"""The GPU cascade kernel (ops/cascade_kernel.py) in interpret mode: parity
with the XLA lockstep evaluator and the reference oracle.

Rejection is monotone per window, so the kernel's tile-level early exit must
reproduce the lockstep evaluator's survivor set, scores (bitwise: the same
f32 leaf sums in the same stage order) and n_weak counter exactly —
including batched canvases, canvases that are not tile multiples, stage caps,
bf16 canvases and cascades deeper than any fixed table size.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from test_cascade import random_stage
from waldboost_tpu.channels import _normalize_opts
from waldboost_tpu.model import (_channel_canvas_fast, _packed_plan_cached,
                                 Model)
from waldboost_tpu.ops import cascade as cop
from waldboost_tpu.ops.cascade import cascade_response_grid
from waldboost_tpu.ops.cascade_kernel import (cascade_dense, cascade_grid,
                                              cascade_masked,
                                              kernel_supported)


def _make_model(seed=0, n_stages=20, shape=(8, 8, 4)):
    from __graft_entry__ import _flagship_model
    model = _flagship_model(seed=seed, n_stages=n_stages, shape=shape,
                            calibrated=False)
    # hand-set some thetas so rejection actually fires
    rng = np.random.RandomState(seed + 1)
    for t in range(3, n_stages, 2):
        model.theta[t] = float(rng.uniform(-0.5, 0.5))
    model._version += 1
    return model


@pytest.fixture(scope="module")
def setup():
    model = _make_model()
    m, n, _ = model.shape
    shrink, n_per_oct, smooth, cf = _normalize_opts(model.channel_opts)
    h, w = 96, 128
    packed = _packed_plan_cached(h, w, shrink, n_per_oct, (m, n), halo=cf.halo)
    valid = jnp.asarray(packed.valid_mask((m, n)))
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 256, (3, h, w)).astype(np.uint8)
    cvs = jnp.stack([
        _channel_canvas_fast(jnp.asarray(im), shrink, smooth, cf,
                             packed).astype(jnp.float32) for im in imgs])
    return model, cvs, valid, (m, n)


def _assert_same(ref, got):
    """(hs, alive, n_weak) of the lockstep evaluator vs the kernel: same
    survivors, bitwise-equal scores everywhere, equal counters."""
    hs0, al0, nw0 = (np.asarray(x) for x in ref)
    hs1, al1, nw1 = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(al0, al1)
    np.testing.assert_array_equal(hs0.view(np.int32), hs1.view(np.int32))
    assert int(nw0) == int(nw1)


def test_static_matches_xla_single(setup):
    model, cvs, valid, window = setup
    casc, meta = model._get_cascade()
    ref = cascade_response_grid(cvs[0], casc, window, meta, init_alive=valid)
    got = cascade_dense(cvs[:1], casc, meta, valid, window)
    _assert_same(ref, [x[0] for x in got])


def test_static_matches_xla_batched(setup):
    model, cvs, valid, window = setup
    casc, meta = model._get_cascade()
    hs1, al1, nw1 = cascade_dense(cvs, casc, meta, valid, window)
    assert hs1.shape[0] == cvs.shape[0]
    for b in range(cvs.shape[0]):
        ref = cascade_response_grid(cvs[b], casc, window, meta,
                                    init_alive=valid)
        _assert_same(ref, (hs1[b], al1[b], nw1[b]))


def test_static_stage_cap_matches_slice(setup):
    model, cvs, valid, window = setup
    casc, meta = model._get_cascade()
    pre = cop.slice_cascade(casc, 0, 7)
    ref = cascade_response_grid(cvs[1], pre, window, meta, init_alive=valid)
    got = cascade_dense(cvs[1:2], pre, meta, valid, window)
    # a 7-stage slice is not a multiple of the kernel's stage group: the
    # padded tail stages must be inert (no score, no n_weak)
    _assert_same(ref, [x[0] for x in got])


def test_model_detect_uses_static_backend(setup):
    """Model.detect through the kernel serving dispatch equals the XLA
    backend."""
    from waldboost_tpu import model as M
    model, _, _, _ = setup
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (96, 128)).astype(np.uint8)
    old = M._CASCADE_BACKEND
    try:
        M.set_cascade_backend("xla")
        bx = model.detect(img)
        M.set_cascade_backend("triton")
        bs = model.detect(img)
    finally:
        M._CASCADE_BACKEND = old
    assert len(bx) == len(bs)
    a = np.concatenate([bx.get(), bx.get_field("scores")[:, None]], axis=1)
    b = np.concatenate([bs.get(), bs.get_field("scores")[:, None]], axis=1)
    a = a[np.lexsort(a.T)]
    b = b[np.lexsort(b.T)]
    assert np.array_equal(a, b)


def test_masked_kernel_matches_static(setup):
    """cascade_masked == where(alive, hs, -inf) over the tile-padded grid,
    with exact in-kernel n_weak and survivor counts."""
    model, cvs, valid, window = setup
    casc, meta = model._get_cascade()
    hs, al, nw = cascade_dense(cvs, casc, meta, valid, window)
    masked, nw2, count = cascade_masked(cvs, casc, meta, valid, window)
    U, V = cvs.shape[-2], cvs.shape[-1]
    m, n = window
    gu, gv = U - m, V - n
    TU, TV, gi, gj = cascade_grid((U, V), window)
    assert masked.shape == (cvs.shape[0], gi * TU, gj * TV)
    al, hs = np.asarray(al), np.asarray(hs)
    mk = np.asarray(masked)
    assert np.array_equal(mk[:, :gu, :gv], np.where(al, hs, -np.inf))
    assert np.all(np.isneginf(mk[:, gu:, :])) and \
        np.all(np.isneginf(mk[:, :, gv:]))
    assert np.array_equal(np.asarray(nw), np.asarray(nw2))
    assert np.array_equal(np.asarray(count),
                          al.reshape(al.shape[0], -1).sum(1))


@pytest.mark.parametrize("tile", [(16, 64), (8, 32), (32, 128)])
def test_masked_kernel_serving_variants(setup, tile):
    """Serving configurations — no n_weak counter, other tile shapes — emit
    the same survivor scores and counts as the default masked form."""
    model, cvs, valid, window = setup
    casc, meta = model._get_cascade()
    ref, nw0, count0 = cascade_masked(cvs, casc, meta, valid, window)
    mk, nw, count = cascade_masked(cvs, casc, meta, valid, window,
                                   with_n_weak=False, tile=tile)
    U, V = cvs.shape[-2:]
    gu, gv = U - window[0], V - window[1]
    np.testing.assert_array_equal(np.asarray(mk)[:, :gu, :gv],
                                  np.asarray(ref)[:, :gu, :gv])
    np.testing.assert_array_equal(np.asarray(count), np.asarray(count0))
    assert not np.asarray(nw).any() and np.asarray(nw0).all()


def test_masked_kernel_bf16_canvas(setup):
    """A bf16 canvas (fast serving mode) is compared in f32, exactly as the
    lockstep evaluator compares the same bf16 values."""
    model, cvs, valid, window = setup
    casc, meta = model._get_cascade()
    cb = cvs.astype(jnp.bfloat16)
    mk, nw, count = cascade_masked(cb, casc, meta, valid, window)
    gu, gv = cvs.shape[-2] - window[0], cvs.shape[-1] - window[1]
    for b in range(cb.shape[0]):
        hs, al, nw0 = cascade_response_grid(cb[b], casc, window, meta,
                                            init_alive=valid)
        al = np.asarray(al)
        np.testing.assert_array_equal(np.asarray(mk[b])[:gu, :gv],
                                      np.where(al, np.asarray(hs), -np.inf))
        assert int(nw[b]) == int(nw0) and int(count[b]) == int(al.sum())


def test_masked_kernel_deep_cascade_auto_latch():
    """A 140-stage cascade: node tables are runtime arrays, so depth has no
    kernel limit; outputs equal the XLA lockstep evaluator exactly."""
    model = _make_model(seed=3, n_stages=140)
    m, n, _ = model.shape
    shrink, n_per_oct, smooth, cf = _normalize_opts(model.channel_opts)
    packed = _packed_plan_cached(48, 64, shrink, n_per_oct, (m, n),
                                 halo=cf.halo)
    valid = jnp.asarray(packed.valid_mask((m, n)))
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (48, 64)).astype(np.uint8)
    cvs = _channel_canvas_fast(jnp.asarray(img), shrink, smooth, cf,
                               packed).astype(jnp.float32)
    casc, meta = model._get_cascade()
    ref = cascade_response_grid(cvs, casc, (m, n), meta, init_alive=valid)
    got = cascade_dense(cvs[None], casc, meta, valid, (m, n))
    _assert_same(ref, [x[0] for x in got])


_THETAS = {
    "none": lambda rng, T: [-np.inf] * T,
    "mixed": lambda rng, T: [(-np.inf if t % 3 else rng.randn() * 0.5 - 0.5)
                             for t in range(T)],
    "reject_all": lambda rng, T: [1e9] + [-np.inf] * (T - 1),
}


@pytest.mark.parametrize("kind", ["stump", "depth2"])
@pytest.mark.parametrize("window", [(8, 8), (5, 11)])
@pytest.mark.parametrize("thetas", sorted(_THETAS))
@pytest.mark.parametrize("hw", [(30, 26), (45, 83)])
def test_kernel_matches_oracle(kind, window, thetas, hw):
    """Kernel vs the reference's survivor-compaction oracle and the lockstep
    evaluator, over tree depth, window shape, rejection pattern and canvas
    sizes that are not tile multiples (padded tiles and masked reads)."""
    rng = np.random.RandomState(hash((kind, window, thetas, hw)) % 2 ** 31)
    C = 3
    X = rng.randn(hw[0], hw[1], C).astype("f")
    T = 10
    stages = [random_stage(rng, window, C, kind) for _ in range(T)]
    th = _THETAS[thetas](rng, T)
    casc, meta = cop.cascade_from_stages(stages, th, n_stages=16)
    assert kernel_supported(meta)
    chw = jnp.transpose(jnp.asarray(X), (2, 0, 1))
    gu, gv = hw[0] - window[0], hw[1] - window[1]
    valid = jnp.ones((gu, gv), bool)

    hs, al, nw = (x[0] for x in cascade_dense(chw[None], casc, meta, valid,
                                              window))
    _assert_same(cop.cascade_response_grid(chw, casc, window, meta), (hs, al,
                                                                      nw))
    rs, cs, h_ref, nw_ref = oracle.predict_on_image(stages, th, X, window)
    al = np.asarray(al)
    assert set(zip(*np.nonzero(al))) == set(zip(rs.tolist(), cs.tolist()))
    np.testing.assert_allclose(np.asarray(hs)[rs, cs], h_ref, rtol=1e-5,
                               atol=1e-5)
    assert int(nw) == nw_ref
    mk, nw2, count = (x[0] for x in cascade_masked(chw[None], casc, meta,
                                                   valid, window))
    assert int(count) == len(rs) and int(nw2) == nw_ref
    assert int(np.isfinite(np.asarray(mk)).sum()) == len(rs)


def test_kernel_deep_trees_take_lockstep():
    """Trees deeper than the complete-tree canonicalisation have no kernel
    route; the kernel entry points fall back to the lockstep evaluator with
    the same outputs."""
    rng = np.random.RandomState(4)
    window, C = (6, 6), 2
    depth = cop.MAX_COMPLETE_DEPTH + 1
    nn = 2 * depth + 1  # a chain: every left child is a leaf

    def chain_stage():
        left = np.full(nn, -1)
        right = np.full(nn, -1)
        for d in range(depth):
            left[2 * d], right[2 * d] = 2 * d + 1, 2 * d + 2
        feat = np.stack([rng.randint(6, size=nn), rng.randint(6, size=nn),
                         rng.randint(C, size=nn)], 1)
        return dict(feature=feat, threshold=rng.randn(nn).astype("f"),
                    left=left, right=right,
                    prediction=rng.randn(nn).astype("f"))

    stages = [chain_stage() for _ in range(4)]
    casc, meta = cop.cascade_from_stages(stages, [-np.inf, 0.0, -np.inf, 0.5])
    assert not kernel_supported(meta)
    X = jnp.asarray(rng.randn(C, 20, 24).astype("f"))
    valid = jnp.ones((14, 18), bool)
    ref = cop.cascade_response_grid(X, casc, window, meta, init_alive=valid)
    _assert_same(ref, [x[0] for x in cascade_dense(X[None], casc, meta, valid,
                                                   window)])
    mk, _, count = cascade_masked(X[None], casc, meta, valid, window)
    assert int(count[0]) == int(np.asarray(ref[1]).sum())


def test_model_cascade_is_kernel_routable():
    """The shipped flagship model (64 depth-2 trees) takes the kernel."""
    import waldboost_tpu as wb
    model = wb.load("models/flagship_synth_64.pb")
    assert isinstance(model, Model)
    _, meta = model._get_cascade()
    assert kernel_supported(meta) and meta.depth == 2


@pytest.mark.gpu
def test_gpu_kernel_matches_lockstep_at_vga(gpu):
    """Compiled on the card, at the flagship's full VGA canvas: identical
    survivors, bitwise scores and equal n_weak vs the lockstep evaluator."""
    import jax

    import waldboost_tpu as wb
    from waldboost_tpu.golden import golden_frames
    from waldboost_tpu.polyphase import _channel_canvas_batch

    model = wb.load("models/flagship_synth_64.pb")
    m, n, _ = model.shape
    shrink, npo, smooth, cf = _normalize_opts(model.channel_opts)
    packed = _packed_plan_cached(480, 640, shrink, npo, (m, n), halo=cf.halo)
    valid = jnp.asarray(packed.valid_mask((m, n)))
    casc, meta = model._get_cascade()
    cvs = jax.jit(lambda ims: _channel_canvas_batch(
        ims, shrink, npo, smooth, cf, packed))(jnp.asarray(golden_frames()[0]))
    got = cascade_dense(cvs, casc, meta, valid, (m, n))
    for b in range(cvs.shape[0]):
        ref = cascade_response_grid(cvs[b], casc, (m, n), meta,
                                    init_alive=valid)
        _assert_same(ref, [x[b] for x in got])
