import numpy as np
import pytest

import oracle
import waldboost_tpu as wb
from waldboost_tpu import fpga


def sobel_oracle(img):
    """Reference 3x3 Sobel with zero borders (numba stencil semantics,
    /root/reference/waldboost/fpga/channels.py:5-27)."""
    img = img.astype(np.int64)
    h, w = img.shape
    dx = np.zeros((h, w), np.int64)
    dy = np.zeros((h, w), np.int64)
    for i in range(1, h - 1):
        for j in range(1, w - 1):
            p = img[i - 1:i + 2, j - 1:j + 2]
            dx[i, j] = (-(p[0, 0] + 2 * p[1, 0] + p[2, 0])
                        + p[0, 2] + 2 * p[1, 2] + p[2, 2])
            dy[i, j] = (-(p[0, 0] + 2 * p[0, 1] + p[0, 2])
                        + p[2, 0] + 2 * p[2, 1] + p[2, 2])
    return dx, dy


def test_grad_hist_4_u1_matches_reference_semantics():
    img = np.random.RandomState(0).randint(0, 256, (14, 17)).astype(np.uint8)
    out = np.asarray(fpga.grad_hist_4_u1.fn(img))  # (4, H, W)
    dx, dy = sobel_oracle(img)
    y = np.stack([
        dx,
        (0.5 * dx - 0.5 * dy).astype(np.int64),  # trunc toward zero
        dy,
        (0.5 * dx + 0.5 * dy).astype(np.int64),
    ])
    want = np.minimum(np.abs(y) // 4, 255).astype(np.uint8)
    np.testing.assert_array_equal(out, want)


def test_grad_mag_u1_matches_reference_semantics():
    img = np.random.RandomState(1).randint(0, 256, (12, 15)).astype(np.uint8)
    out = np.asarray(fpga.grad_mag_u1.fn(img))
    dx, dy = sobel_oracle(img)
    want = np.minimum(np.maximum(np.abs(dx), np.abs(dy)) // 4, 255)
    np.testing.assert_array_equal(out[0], want.astype(np.uint8))


def test_banks_pattern_and_scheduler():
    b = fpga.PixelBanks((4, 4, 2), (2, 2))
    # 2x2 tiling across the window, repeated over channels
    assert b.pattern.shape == (4, 4, 2)
    np.testing.assert_array_equal(b.pattern[..., 0], b.pattern[..., 1])
    np.testing.assert_array_equal(
        b.pattern[:2, :2, 0], [[0, 1], [2, 3]])
    px = b.bank_pixels([0])
    assert (b.pattern.reshape(-1)[px] == 0).all()

    s = fpga.BankScheduler(4)
    assert s.schedule(2) == [[0], [1]]
    assert s.schedule(2) == [[2], [3]]
    assert s.schedule(2) == [[0], [1]]  # round-robin


def test_banks_match_reference_tiling_definition():
    """Property: the modulo bank map equals the reference's tile-pattern
    definition (np.tile of an arange block over the window,
    /root/reference/waldboost/fpga/banks.py:6-15) for odd/even windows."""
    rng = np.random.RandomState(0)
    for shape, block in [((12, 12, 4), (2, 2)), ((7, 9, 1), (2, 2)),
                         ((5, 5), (3, 2)), ((8, 6, 2), (4, 4))]:
        bh, bw = block
        tile = np.arange(bh * bw).reshape(block)
        H, W = shape[:2]
        reps = (-(-H // bh), -(-W // bw))
        want2d = np.tile(tile, reps)[:H, :W]
        C = shape[2] if len(shape) == 3 else 1
        want = np.repeat(want2d[:, :, None], C, axis=2)
        got = fpga.PixelBanks(shape, block).pattern
        np.testing.assert_array_equal(got, want)
        # bank_pixels covers every pixel exactly once across all banks
        px = fpga.PixelBanks(shape, block).bank_pixels(range(bh * bw))
        assert sorted(px.tolist()) == list(range(H * W * C))


def test_fpga_dtree_quantized():
    rng = np.random.RandomState(2)
    X0 = rng.randint(0, 256, (300, 4, 4, 1)).astype(np.uint8)
    X1 = rng.randint(0, 256, (300, 4, 4, 1)).astype(np.uint8)
    X1[:, 1, 1, 0] = np.minimum(X1[:, 1, 1, 0].astype(int) + 120, 255).astype(np.uint8)
    W0 = np.full(300, 1 / 300, "f")
    W1 = np.full(300, 1 / 300, "f")
    tree = fpga.DTree.fit(X0.astype("f"), W0, X1.astype("f"), W1)
    # integer thresholds, clipped + quantized responses
    np.testing.assert_allclose(tree.threshold, np.round(tree.threshold))
    assert np.abs(tree.prediction).max() <= 3 + 1e-6
    np.testing.assert_allclose(tree.prediction * 32,
                               np.round(tree.prediction * 32), atol=1e-4)


def test_fpga_train_end_to_end():
    from waldboost_tpu.utils import fake_data_generator
    gen = fake_data_generator(seed=3)
    opts = dict(shrink=2, n_per_oct=2, smooth=1, channels="grad_hist_4_u1")
    model = wb.Model((8, 8, 4), opts)
    pool = wb.SamplePool(min_tp=60, min_fp=60, seed=0)
    learner = fpga.train(model, gen, pool=pool, length=2, max_depth=2)
    assert len(model) == 2
    # quantized responses survive into the model
    for weak, theta in model:
        np.testing.assert_allclose(weak.prediction * 32,
                                   np.round(weak.prediction * 32), atol=1e-4)
    # detect roundtrip with integer channels
    d = next(gen)
    boxes = model.detect(d["image"])
    assert boxes is not None


def test_fpga_poly_canvas_matches_canvas_path():
    """The new polyphase FPGA canvas (selector resize + poly Sobel + wrap
    pool) is bit-identical to the image-canvas path."""
    import jax
    import jax.numpy as jnp

    from waldboost_tpu.channels import _normalize_opts
    from waldboost_tpu.model import (_channel_canvas_batch,
                                     _channel_canvas_fast,
                                     _packed_plan_cached)

    for chan in ("grad_hist_4_u1", "grad_mag_u1"):
        opts = dict(shrink=2, n_per_oct=2, smooth=0, channels=chan)
        shrink, n_per_oct, smooth, cf = _normalize_opts(opts)
        assert cf.canvas_fn_poly is not None
        packed = _packed_plan_cached(48, 64, shrink, n_per_oct, (8, 8),
                                     halo=cf.halo)
        rng = np.random.RandomState(2)
        imgs = rng.randint(0, 256, (2, 48, 64)).astype(np.uint8)
        poly = _channel_canvas_batch(jnp.asarray(imgs), shrink, n_per_oct,
                                     smooth, cf, packed)
        fast = jax.vmap(
            lambda im: _channel_canvas_fast(im, shrink, smooth, cf, packed)
            .astype(jnp.float32))(jnp.asarray(imgs))
        np.testing.assert_array_equal(np.asarray(poly), np.asarray(fast))


def _poly_vs_image_canvas(chan, smooth, hw, seed):
    """(polyphase chain, image-space canvas chain) channel canvases of one
    random uint8 frame over a real packed plan (gaps, shelf bands, rings)."""
    import dataclasses

    import jax.numpy as jnp

    from waldboost_tpu import model as M
    from waldboost_tpu.channels import _normalize_opts

    opts = dict(shrink=2, n_per_oct=4, smooth=smooth, channels=chan)
    shrink, n_per_oct, sm, cf = _normalize_opts(opts)
    packed = M._packed_plan_cached(*hw, shrink, n_per_oct, (12, 12),
                                   halo=cf.halo)
    img = jnp.asarray(np.random.RandomState(seed)
                      .randint(0, 256, hw).astype(np.uint8))
    poly = np.asarray(M._channel_canvas_poly(img, sm, cf, packed))
    assert poly.shape[0] == cf.n_channels
    if "+" in chan:
        # a composite is the channel-axis concat of its parts' chains
        parts = [_poly_vs_image_canvas(c, smooth, hw, seed)[0]
                 for c in chan.split("+")]
        return poly, np.concatenate(parts, axis=0)
    cf_img = dataclasses.replace(cf, canvas_fn_poly=None)
    ref = np.asarray(M._channel_canvas_fast(img, shrink, sm, cf_img, packed))
    return poly, ref


@pytest.mark.parametrize("name", ["grad_hist_4_u1", "grad_mag_u1"])
@pytest.mark.parametrize("hw", [(96, 128), (240, 320)])
def test_fpga_poly_chain_bitwise(name, hw):
    """The FPGA polyphase channel chain (the serving canvas) is bitwise
    identical to the image-space canvas chain over a real packed plan."""
    poly, ref = _poly_vs_image_canvas(name, 0, hw, seed=3)
    np.testing.assert_array_equal(poly, ref)


@pytest.mark.parametrize("chan,smooth", [
    ("grad_hist_4_u1", 1),
    ("grad_mag_u1", 1),
    ("grad_hist_4_u1+grad_mag_u1", 0),
    ("grad_hist_4_u1+grad_mag_u1", 1),
])
def test_fpga_poly_chain_smooth_and_composite(chan, smooth):
    """smooth==1 (3x3/16 + uint8 truncation + interior mask) through the
    polyphase chain equals the image-space canvas chain, and "+"-composite
    channel functions (the grad_hist+grad_mag C=5 pipeline) equal the
    concat of their parts."""
    poly, ref = _poly_vs_image_canvas(chan, smooth, (96, 128), seed=5)
    np.testing.assert_array_equal(poly, ref)


def test_fpga_serving_boxes_match_xla_backend():
    """End-to-end kernel serving (polyphase canvas + cascade kernel +
    extraction) returns the same boxes as the XLA lockstep backend."""
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_model
    from waldboost_tpu import model as M
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    opts = dict(shrink=2, n_per_oct=4, smooth=0, channels="grad_hist_4_u1")
    model = _flagship_model(channel_opts=opts, image_hw=(128, 160))
    h, w = 240, 320
    imgs = jnp.asarray(np.random.RandomState(0)
                       .randint(0, 256, (2, h, w)).astype(np.uint8))
    try:
        M.set_cascade_backend("xla")
        fn, _ = make_batched_detector_boxes(model, (h, w), k=128,
                                            nms_iou=None, with_n_weak=False)
        ref = [np.asarray(x) for x in fn(imgs)]
        M.set_cascade_backend("triton")
        fn2, _ = make_batched_detector_boxes(model, (h, w), k=128,
                                             nms_iou=None, with_n_weak=False)
        got = [np.asarray(x) for x in fn2(imgs)]
    finally:
        M.set_cascade_backend("triton")
    assert ref[3].sum() > 0  # some survivors, or the test is vacuous
    for a, b in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(b, a)


def test_composed_channels_concat_semantics():
    """A composed channel function == channel-axis concat of its parts
    (what a reference user's concatenating lambda produces), across the
    plain fn, the pyramid, and proto round-trip by name."""
    from waldboost_tpu.channels import resolve_channel_function

    cf = resolve_channel_function("grad_hist_4_u1+grad_mag_u1")
    assert cf.n_channels == 5
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (40, 56)).astype(np.uint8)
    a = np.asarray(resolve_channel_function("grad_hist_4_u1")(img))
    b = np.asarray(resolve_channel_function("grad_mag_u1")(img))
    c = np.asarray(cf(img))
    np.testing.assert_array_equal(c, np.concatenate([a, b], axis=0))
    # persists + reloads by name (the proto stores the dotted "+" name)
    from waldboost_tpu.channels import resolve_channel_function as rcf
    again = rcf(cf.name)
    assert again is cf
    # float-family composition resolves too
    f = rcf("grad_hist+grad_mag")
    assert f.n_channels == 5 and f.canvas_fn_poly is None


def test_fpga_train_sharded_mesh():
    """fpga.train's mesh path: device-pool sharded training with per-stage
    bank feature masks and in-step clip/quantize/integer-threshold
    transforms (the FPGA contract of
    /root/reference/waldboost/fpga/training.py:160-168,249-259)."""
    import jax

    import waldboost_tpu as wb
    from waldboost_tpu import fpga
    from waldboost_tpu.fpga.banks import BankScheduler, PixelBanks
    from waldboost_tpu.parallel.mesh import make_mesh
    from waldboost_tpu.utils import fake_data_generator

    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs >= 4 virtual devices")
    mesh = make_mesh(4)
    gen = fake_data_generator(seed=5)
    model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=0,
                                       channels="grad_hist_4_u1"))
    pool = wb.SamplePool(min_tp=100, min_fp=100, seed=2)
    quantizer = 32
    learner = fpga.train(model, gen, pool=pool, length=4, max_depth=2,
                         quantizer=quantizer, mesh=mesh)
    assert len(model) == len(learner) == 4

    # replay the round-robin schedule to know each stage's banks
    banks = PixelBanks(model.shape, (2, 2))
    sched = BankScheduler(4)
    for weak, _theta in model:
        stage_banks = sched.schedule(2)
        allowed = [set(banks.bank_pixels(b).tolist()) for b in stage_banks]
        # depth of each internal node in the flat layout
        depth = {0: 0}
        for k, (lf, rt) in enumerate(zip(weak.left, weak.right)):
            if lf >= 0:
                depth[int(lf)] = depth[k] + 1
                depth[int(rt)] = depth[k] + 1
        m, n, C = model.shape
        for k, f in enumerate(weak.feature):
            if f is None or weak.left[k] < 0:
                continue
            flat = int(np.ravel_multi_index(f, (m, n, C)))
            assert flat in allowed[depth[k]], (k, f, depth[k])
        # integer thresholds + quantized responses
        for k in range(len(weak.left)):
            if weak.left[k] >= 0:
                assert float(weak.threshold[k]) == int(weak.threshold[k])
        q = weak.prediction * quantizer
        np.testing.assert_allclose(q, np.round(q), atol=1e-4)
