"""Multi-chip tests over the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8 — the standard JAX idiom)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import waldboost_tpu as wb
from waldboost_tpu.parallel.detect import detect_batch, make_batched_detector
from waldboost_tpu.parallel.mesh import make_mesh, shard_array
from waldboost_tpu.parallel.train_step import make_train_step

from test_model import make_model


def _mesh_or_skip(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return make_mesh(n)


def test_batched_detect_matches_single():
    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 48, 64)).astype(np.uint8)
    batched = detect_batch(model, images)
    for b, img in zip(batched, images):
        single = model.detect(img)
        assert len(b) == len(single)
        if len(b):
            np.testing.assert_allclose(np.sort(b.get_field("scores")),
                                       np.sort(single.get_field("scores")),
                                       rtol=1e-5)


def test_n_scales_capped_detector_matches_first_scale():
    """n_scales=1 serves ONLY the first pyramid level: box set must equal
    the reference-style single-scale evaluation (predict_on_image on the
    first channel_pyramid scale — config 1 of BASELINE.json)."""
    from waldboost_tpu.channels import channel_pyramid
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (48, 64)).astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, img.shape, k=512,
                                        with_n_weak=False, n_scales=1)
    rects, scores, valid, count, _ = fn(jnp.asarray(img[None]))
    v = np.asarray(valid[0])
    got = {(*np.round(np.asarray(rects[0])[i], 2),
            np.float32(np.asarray(scores[0])[i])) for i in np.where(v)[0]}

    chns, scale = next(channel_pyramid(img, model.channel_opts))
    r, c, h = model.predict_on_image(chns)
    want_boxes = model.get_boxes(r, c, scale)
    want = {(*np.round(np.asarray(b), 2), np.float32(s))
            for b, s in zip(want_boxes.get(), h)}
    assert got == want


def test_batched_detector_boxes_matches_detect():
    """On-device extraction (rowwise top-k) returns the exact survivor set."""
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (3, 48, 64)).astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, (48, 64), k=2048, k_row=64)
    rects, scores, valid, count, n_weak = fn(jnp.asarray(images))
    rects, scores = np.asarray(rects), np.asarray(scores)
    valid, count = np.asarray(valid), np.asarray(count)
    for b, img in enumerate(images):
        single = model.detect(img)
        assert count[b] == len(single)
        sel = valid[b]
        assert sel.sum() == len(single)
        got = np.concatenate([rects[b][sel], scores[b][sel, None]], axis=1)
        ref = np.concatenate([single.get(),
                              single.get_field("scores")[:, None]], axis=1)
        got = got[np.lexsort(got.T)]
        ref = ref[np.lexsort(ref.T)]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_batched_detector_boxes_nms_matches_host():
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (2, 48, 64)).astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, (48, 64), k=2048, k_row=64,
                                        nms_iou=0.4)
    rects, scores, valid, count, _ = fn(jnp.asarray(images))
    for b, img in enumerate(images):
        single = model.detect(img)
        kept = wb.bbx.non_max_suppression(single, iou_threshold=0.4)
        sel = np.asarray(valid[b])
        got = np.asarray(scores[b])[sel]
        np.testing.assert_allclose(np.sort(got),
                                   np.sort(kept.get_field("scores")),
                                   rtol=1e-6)


def test_two_phase_batched_boxes_matches_detect():
    """Two-phase batched serving (dense prefix + approx_max_k compaction +
    sparse suffix) returns the exact final survivor set and scores."""
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = make_model(n_stages=32, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (3, 48, 64)).astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, (48, 64), k=512,
                                        two_phase=True, prefix=8,
                                        capacity=1024)
    rects, scores, valid, count, n_weak = fn(jnp.asarray(images))
    rects, scores = np.asarray(rects), np.asarray(scores)
    valid, count = np.asarray(valid), np.asarray(count)
    for b, img in enumerate(images):
        single = model.detect(img)
        assert count[b] == len(single)
        sel = valid[b]
        assert sel.sum() == len(single)
        got = np.concatenate([rects[b][sel], scores[b][sel, None]], axis=1)
        ref = np.concatenate([single.get(),
                              single.get_field("scores")[:, None]], axis=1)
        got = got[np.lexsort(got.T)]
        ref = ref[np.lexsort(ref.T)]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_two_phase_capacity_overflow_flags_incomplete():
    """Prefix survivors beyond the compaction capacity must flag count=-1
    (detect_batch then falls back to the exact dense path)."""
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = make_model(n_stages=32, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(8)
    images = rng.randint(0, 256, (2, 48, 64)).astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, (48, 64), k=512,
                                        two_phase=True, prefix=2,
                                        capacity=16)  # force overflow
    _, _, _, count, _ = fn(jnp.asarray(images))
    assert (np.asarray(count) == -1).all()
    # detect_batch recovers exactly via the dense fallback
    batched = detect_batch(model, images)
    for b, img in zip(batched, images):
        single = model.detect(img)
        assert len(b) == len(single)


def test_detect_batch_overflow_fallback():
    """Images whose survivor set overflows the extraction capacity fall back
    to the exact dense path."""
    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, 48, 64)).astype(np.uint8)
    batched = detect_batch(model, images, k=16, k_row=1)  # force overflow
    for b, img in zip(batched, images):
        single = model.detect(img)
        assert len(b) == len(single)


def test_sharded_detect_matches_unsharded():
    mesh = _mesh_or_skip(4)
    model = make_model(n_stages=3, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=0,
                                 channels="grad_hist"))
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (4, 40, 56)).astype(np.uint8)
    fn_s, _ = make_batched_detector(model, (40, 56), mesh=mesh)
    fn_u, _ = make_batched_detector(model, (40, 56))
    hs_s, al_s, nw_s = fn_s(shard_array(images, mesh))
    hs_u, al_u, nw_u = fn_u(jnp.asarray(images))
    np.testing.assert_array_equal(np.asarray(al_s), np.asarray(al_u))
    np.testing.assert_allclose(np.asarray(hs_s)[np.asarray(al_s)],
                               np.asarray(hs_u)[np.asarray(al_u)], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(nw_s), np.asarray(nw_u))


def test_sharded_train_step_matches_single_device():
    mesh = _mesh_or_skip(8)
    rng = np.random.RandomState(2)
    N, F = 64, 32
    x0 = rng.randn(N, F).astype("f")
    x1 = (rng.randn(N, F) + 1.5).astype("f")
    H0 = np.zeros(N, "f")
    H1 = np.zeros(N, "f")
    v0 = np.ones(N, bool)
    v1 = np.ones(N, bool)
    args = (jnp.float32(1.0), jnp.float32(1.0), jnp.float32(-np.inf),
            jnp.asarray(True))

    step1 = make_train_step(alpha=0.2, max_depth=2, n_bins=64)
    r1 = step1(jnp.asarray(x0), jnp.asarray(H0), jnp.asarray(v0),
               jnp.asarray(x1), jnp.asarray(H1), jnp.asarray(v1), *args)

    stepN = make_train_step(alpha=0.2, max_depth=2, n_bins=64, mesh=mesh)
    rN = stepN(shard_array(x0, mesh), shard_array(H0, mesh),
               shard_array(v0, mesh), shard_array(x1, mesh),
               shard_array(H1, mesh), shard_array(v1, mesh), *args)

    # identical tree, threshold, statistics across sharding
    np.testing.assert_array_equal(np.asarray(r1.tree.feature),
                                  np.asarray(rN.tree.feature))
    np.testing.assert_allclose(np.asarray(r1.tree.threshold),
                               np.asarray(rN.tree.threshold), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r1.tree.pred),
                               np.asarray(rN.tree.pred), rtol=1e-5)
    assert float(r1.theta) == pytest.approx(float(rN.theta), rel=1e-6)
    assert float(r1.p0) == pytest.approx(float(rN.p0))
    assert float(r1.p1) == pytest.approx(float(rN.p1))
    np.testing.assert_allclose(np.asarray(r1.H0), np.asarray(rN.H0), rtol=1e-5)


def test_device_pool_insert_from_device_matches_host_insert():
    """Gather-insert straight from a device crop array fills the SAME slots
    with the SAME values as sequential host inserts of the same rows."""
    from waldboost_tpu.parallel.trainer import DevicePool

    rng = np.random.RandomState(7)
    F = 24
    src = rng.randn(300, 2, 3, 4).astype(np.float32)  # crop-shaped rows
    sH = rng.randn(300).astype(np.float32)
    src_dev, sH_dev = jnp.asarray(src), jnp.asarray(sH)

    rng2 = np.random.RandomState(11)
    pa = DevicePool(256, F)
    pb = DevicePool(256, F)
    seed_x = rng2.randn(40, F).astype(np.float32)
    seed_H = rng2.randn(40).astype(np.float32)
    pa.insert(seed_x, seed_H)
    pb.insert(seed_x, seed_H)

    idx = np.flatnonzero(sH > 0.3)  # some ragged subset
    # host path: sequential per-chunk inserts of the selected rows
    pa.insert(src.reshape(300, -1)[idx], sH[idx])
    # device path: one gather-insert of the same rows
    pb.insert_from_device(src_dev, sH_dev, idx)

    assert pa.count == pb.count
    np.testing.assert_array_equal(np.asarray(pa.v), np.asarray(pb.v))
    np.testing.assert_array_equal(np.asarray(pa.H), np.asarray(pb.H))
    np.testing.assert_array_equal(np.asarray(pa.x), np.asarray(pb.x))


def test_train_sharded_matches_unsharded():
    """wb.train with the device pool: an 8-stage run produces the same model
    sharded over the mesh as on one device (same mining rng; the global
    histogram/threshold statistics ride collectives under the mesh)."""
    from waldboost_tpu.utils import fake_data_generator

    mesh = _mesh_or_skip(8)

    def run(mesh_arg):
        gen = fake_data_generator(seed=13)
        model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=1,
                                           channels="grad_hist"))
        pool = wb.SamplePool(min_tp=120, min_fp=120, seed=3)
        learner = wb.train(model, gen, pool=pool, length=8, mesh=mesh_arg,
                           learner=wb.Learner(alpha=0.2, max_depth=2))
        return model, learner

    from waldboost_tpu.parallel.mesh import make_mesh
    m1, l1 = run(make_mesh(1))
    mN, lN = run(mesh)
    assert len(m1) == len(mN) == 8
    def feats(w):
        return [(-1, -1, -1) if f is None else tuple(int(x) for x in f)
                for f in w.feature]

    for (w1, t1), (w2, t2) in zip(m1, mN):
        assert feats(w1) == feats(w2)
        np.testing.assert_allclose(w1.threshold, w2.threshold, rtol=1e-5)
        np.testing.assert_allclose(w1.prediction, w2.prediction, rtol=1e-4)
        assert t1 == pytest.approx(t2, rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(l1.get_stats()["loss"],
                               lN.get_stats()["loss"], rtol=1e-4)


def test_train_sharded_resume_and_stats():
    from waldboost_tpu.utils import fake_data_generator

    mesh = _mesh_or_skip(4)
    gen = fake_data_generator(seed=21)
    model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=1,
                                       channels="grad_hist"))
    pool = wb.SamplePool(min_tp=100, min_fp=100, seed=1)
    learner = wb.train(model, gen, pool=pool, length=3, mesh=mesh,
                       learner=wb.Learner(alpha=0.2, max_depth=2))
    assert len(model) == len(learner) == 3
    stats = learner.get_stats()
    assert stats["false_positive_rate"][-1] < 1.0
    # detection with the trained model works and rejection fires
    d = next(gen)
    model.detect(d["image"])
    assert model.eval_cost < len(model)


def test_train_sharded_pools_carry_over():
    """A ``pools`` dict carries the device-resident pool across
    train_sharded calls: the resumed call reuses the SAME pool objects
    (no re-bootstrap mining) and keeps training the model."""
    from waldboost_tpu.parallel.trainer import train_sharded
    from waldboost_tpu.utils import fake_data_generator

    gen = fake_data_generator(seed=29)
    model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=1,
                                       channels="grad_hist"))
    learner = wb.Learner(alpha=0.2, max_depth=2)
    pools = {}
    train_sharded(model, gen, mesh=None, learner=learner, length=2,
                  min_tp=100, min_fp=100, seed=1, pools=pools)
    assert len(model) == 2
    fp0, tp0 = pools["fp"], pools["tp"]
    assert fp0.count > 0 and tp0.count > 0
    train_sharded(model, gen, mesh=None, learner=learner, length=4,
                  min_tp=100, min_fp=100, seed=1, pools=pools)
    assert len(model) == 4 and len(learner) == 4
    assert pools["fp"] is fp0 and pools["tp"] is tp0  # reused, not rebuilt
    # the carried pool still holds rescored live samples
    assert fp0.count >= 0 and tp0.count > 0

    # the carried pool is tagged with (model, stage count, mesh): an
    # externally grown cascade invalidates the pool's H scores, so the
    # next call must re-bootstrap instead of silently reusing them
    # (ADVICE r3 #2)
    from waldboost_tpu.training import DTree
    w0, _ = model[0]
    model.append(DTree(w0.feature, w0.threshold, w0.left, w0.right,
                       w0.prediction), -np.inf)
    learner.record_stage(1.0, 1.0, learner.loss)  # keep lengths consistent
    train_sharded(model, gen, mesh=None, learner=learner, length=6,
                  min_tp=100, min_fp=100, seed=1, pools=pools)
    assert len(model) == 6
    assert pools["fp"] is not fp0 and pools["tp"] is not tp0  # re-bootstrap


def test_kernel_batched_detector_exact():
    """The batched detector on the cascade kernel (polyphase canvas chain +
    kernel) matches Model.detect on the XLA backend: same survivors,
    bitwise scores."""
    from waldboost_tpu import model as M
    from waldboost_tpu.parallel.detect import make_batched_detector

    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(12)
    images = rng.randint(0, 256, (2, 48, 64)).astype(np.uint8)
    old_cb = M._CASCADE_BACKEND
    try:
        M.set_cascade_backend("xla")
        refs = [model.detect(img) for img in images]
        M.set_cascade_backend("triton")
        fn, _ = make_batched_detector(model, (48, 64))
        hs, alive, nw = fn(jnp.asarray(images))
    finally:
        M._CASCADE_BACKEND = old_cb
    for b, ref in enumerate(refs):
        al = np.asarray(alive[b])
        assert al.sum() == len(ref)
        got = np.sort(np.asarray(hs[b])[al])
        np.testing.assert_array_equal(got, np.sort(ref.get_field("scores")))


def test_tile_sharded_single_image_exact():
    """One image's window grid sharded across chips: identical survivor set,
    scores, and n_weak to the unsharded evaluator (the SURVEY §5 'long axis'
    sharding analog)."""
    from waldboost_tpu.parallel.detect import (make_batched_detector,
                                               make_tile_sharded_detector)

    mesh = _mesh_or_skip(4)
    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(9)
    image = rng.randint(0, 256, (96, 128)).astype(np.uint8)
    fn_t, _ = make_tile_sharded_detector(model, image.shape, mesh=mesh)
    hs_t, al_t, nw_t = fn_t(image)
    fn_u, _ = make_batched_detector(model, image.shape)
    hs_u, al_u, nw_u = fn_u(jnp.asarray(image[None]))
    al_t, al_u = np.asarray(al_t), np.asarray(al_u[0])
    np.testing.assert_array_equal(al_t, al_u)
    np.testing.assert_array_equal(np.asarray(hs_t)[al_t],
                                  np.asarray(hs_u[0])[al_u])
    assert int(nw_t) == int(np.asarray(nw_u)[0])


def test_train_step_improves_loss():
    rng = np.random.RandomState(3)
    N, F = 128, 16
    x0 = rng.randn(N, F).astype("f")
    x1 = (rng.randn(N, F) + 2.0).astype("f")
    step = make_train_step(alpha=0.2, max_depth=2, n_bins=64)
    H0 = jnp.zeros(N)
    H1 = jnp.zeros(N)
    v = jnp.ones(N, bool)
    args = (jnp.float32(1.0), jnp.float32(1.0), jnp.float32(-np.inf),
            jnp.asarray(True))
    losses = []
    for _ in range(3):
        r = step(jnp.asarray(x0), H0, v, jnp.asarray(x1), H1, v, *args)
        H0, H1 = r.H0, r.H1
        losses.append(float(r.loss))
    assert losses[2] < losses[0]


@pytest.mark.parametrize("backend", ["triton", "xla"])
def test_masked_serving_matches_detect(backend):
    """The one-program serving path (kernel backend: canvas + masked kernel
    + extraction in one jit) and the split XLA path both return exactly
    Model.detect's boxes."""
    from waldboost_tpu import model as M
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, 48, 64)).astype(np.uint8)
    refs = [model.detect(img) for img in images]
    old_cb = M._CASCADE_BACKEND
    try:
        M.set_cascade_backend(backend)
        fn, _ = make_batched_detector_boxes(model, (48, 64), k=1024,
                                            with_n_weak=False)
        rects, scores, valid, count, _ = fn(jnp.asarray(images))
    finally:
        M._CASCADE_BACKEND = old_cb
    for b, ref in enumerate(refs):
        sel = np.asarray(valid[b])
        assert int(np.asarray(count[b])) == len(ref)
        got = np.concatenate([np.asarray(rects[b])[sel],
                              np.asarray(scores[b])[sel][:, None]], axis=1)
        exp = np.concatenate([ref.get(), ref.get_field("scores")[:, None]],
                             axis=1)
        got = got[np.lexsort(got.T)]
        exp = exp[np.lexsort(exp.T)]
        np.testing.assert_array_equal(got, exp)


def test_tile_sharded_boxes_extraction():
    """Tile-sharded detection with boxes=True: on-device extraction over
    the sharded grid matches the unsharded serving extraction."""
    from waldboost_tpu.parallel.detect import (make_batched_detector_boxes,
                                               make_tile_sharded_detector)

    mesh = _mesh_or_skip(4)
    model = make_model(n_stages=4, shape=(8, 8, 4),
                       opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                 channels="grad_hist"))
    rng = np.random.RandomState(9)
    image = rng.randint(0, 256, (96, 128)).astype(np.uint8)
    fn_t, _ = make_tile_sharded_detector(model, image.shape, mesh=mesh,
                                         boxes=True, k=4096)
    rects_t, scores_t, valid_t, count_t, nw_t = \
        [np.asarray(x) for x in fn_t(image)]
    fn_u, _ = make_batched_detector_boxes(model, image.shape, k=4096,
                                          nms_iou=None, with_n_weak=False)
    rects_u, scores_u, valid_u, count_u, _ = \
        [np.asarray(x) for x in fn_u(jnp.asarray(image[None]))]
    assert count_t == count_u[0] and count_t >= 0

    def box_set(r, s, v):
        return set(map(tuple, np.round(
            np.concatenate([r[v], s[v][:, None]], 1), 3)))
    assert box_set(rects_t, scores_t, valid_t) \
        == box_set(rects_u[0], scores_u[0], valid_u[0])
