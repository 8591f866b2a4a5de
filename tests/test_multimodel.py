"""Shared-canvas multi-model serving: one canvas computation, K cascades.

Anchor: /root/reference/waldboost/__init__.py:75-130 (wb.detect builds ONE
pyramid and runs every model over it, scaling scores by response_scale and
labeling boxes with the emitting model index).
"""

import sys

import numpy as np
import pytest


def _two_models():
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _flagship_model

    opts = dict(shrink=2, n_per_oct=4, smooth=1, channels="grad_hist")
    kw = dict(n_stages=12, shape=(8, 8, 4), image_hw=(96, 128),
              channel_opts=opts)
    return [_flagship_model(seed=0, **kw), _flagship_model(seed=5, **kw)]


def _box_set(b, scale=1.0, label=None):
    rows = np.concatenate(
        [b.get(), b.get_field("scores")[:, None] * scale], axis=1)
    out = set()
    for i, row in enumerate(np.round(rows, 3)):
        lab = b.get_field("label")[i] if label is None else label
        out.add(tuple(row) + (int(lab),))
    return out


def test_detect_multi_matches_per_model_and_counts_one_canvas(monkeypatch):
    import waldboost_tpu as wb
    from waldboost_tpu import model as M

    models = _two_models()
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (96, 128)).astype(np.uint8)

    # per-model ground truth via the single-model path
    want = set()
    for kix, mm in enumerate(models):
        b = mm.detect(img)
        for row in np.round(np.concatenate(
                [b.get(), b.get_field("scores")[:, None] * (kix + 1.0)],
                axis=1), 3):
            want.add(tuple(row) + (kix,))

    calls = {"n": 0}
    real = M._canvas_jit

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(M, "_canvas_jit", counting)
    got_boxes = wb.detect(img, *models, response_scale=[1.0, 2.0])
    assert calls["n"] == 1, "canvas program must execute ONCE for K models"
    got = _box_set(got_boxes)
    assert got == want
    labels = got_boxes.get_field("label")
    assert set(np.unique(labels)) <= {0, 1}


def test_detect_multi_rejects_mismatched_channel_opts():
    import waldboost_tpu as wb
    from waldboost_tpu.model import detect_multi

    models = _two_models()
    bad = wb.Model((8, 8, 4), dict(models[0].channel_opts, n_per_oct=8))
    with pytest.raises(ValueError):
        detect_multi([models[0], bad], np.zeros((96, 128), np.uint8))


def _hetero_models():
    """Two models with DIFFERENT window shapes, same channel options."""
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _flagship_model

    opts = dict(shrink=2, n_per_oct=4, smooth=1, channels="grad_hist")
    kw = dict(image_hw=(96, 128), channel_opts=opts)
    return [_flagship_model(seed=0, n_stages=12, shape=(8, 8, 4), **kw),
            _flagship_model(seed=5, n_stages=12, shape=(12, 12, 4), **kw)]


def test_detect_multi_heterogeneous_window_shapes(monkeypatch):
    """K models of ANY window shape over one shared canvas — the reference
    scans every model over the same pyramid regardless of window shape
    (/root/reference/waldboost/__init__.py:75-130)."""
    import waldboost_tpu as wb
    from waldboost_tpu import model as M

    models = _hetero_models()
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (96, 128)).astype(np.uint8)

    want = set()
    for kix, mm in enumerate(models):
        b = mm.detect(img)
        for row in np.round(np.concatenate(
                [b.get(), b.get_field("scores")[:, None] * (kix + 1.0)],
                axis=1), 3):
            want.add(tuple(row) + (kix,))

    calls = {"n": 0}
    real = M._canvas_jit

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(M, "_canvas_jit", counting)
    got_boxes = wb.detect(img, *models, response_scale=[1.0, 2.0])
    assert calls["n"] == 1, "one canvas execution for mixed-shape models"
    assert _box_set(got_boxes) == want


def test_make_multi_detector_boxes_heterogeneous(monkeypatch):
    import jax.numpy as jnp

    from waldboost_tpu import model as M
    from waldboost_tpu.parallel import detect as D

    models = _hetero_models()
    rng = np.random.RandomState(10)
    imgs = jnp.asarray(rng.randint(0, 256, (2, 96, 128)).astype(np.uint8))

    try:
        M.set_cascade_backend("triton")
        singles = []
        for mm in models:
            fn, _ = D.make_batched_detector_boxes(mm, (96, 128), k=64,
                                                  nms_iou=None,
                                                  with_n_weak=False)
            out = fn(imgs)
            singles.append([np.asarray(x) for x in out])

        fn, _ = D.make_multi_detector_boxes(models, (96, 128), k=64,
                                            nms_iou=None,
                                            response_scale=[1.0, 2.0],
                                            with_n_weak=False)
        rects, scores, valid, label, count, _nw = \
            [np.asarray(x) for x in fn(imgs)]
    finally:
        M.set_cascade_backend("triton")

    # per-model box SETS equal the single-model batched path (the shared
    # min-window canvas is a different layout than each model's own plan,
    # so slot ORDER may differ; boxes and scores must not)
    for b in range(2):
        for kix, single in enumerate(singles):
            s_rects, s_scores, s_valid, s_count, _ = single
            sel = (label[b] == kix) & valid[b]
            got = set(map(tuple, np.round(np.concatenate(
                [rects[b][sel],
                 scores[b][sel][:, None]], axis=1), 3)))
            scale = 1.0 if kix == 0 else 2.0
            wnt = set(map(tuple, np.round(np.concatenate(
                [s_rects[b][s_valid[b]],
                 s_scores[b][s_valid[b]][:, None] * scale], axis=1), 3)))
            assert got == wnt, (b, kix, len(got), len(wnt))
            assert count[b, kix] == s_count[b]


def test_make_multi_detector_boxes_batched(monkeypatch):
    import jax.numpy as jnp

    from waldboost_tpu import model as M
    from waldboost_tpu.parallel import detect as D

    models = _two_models()
    rng = np.random.RandomState(4)
    imgs = jnp.asarray(rng.randint(0, 256, (2, 96, 128)).astype(np.uint8))

    try:
        M.set_cascade_backend("triton")
        # reference results from the single-model batched path
        singles = []
        for mm in models:
            fn, _ = D.make_batched_detector_boxes(mm, (96, 128), k=64,
                                                  nms_iou=None,
                                                  with_n_weak=False)
            singles.append([np.asarray(x) for x in fn(imgs)])

        traces = {"n": 0}
        orig = D.make_batched_detector

        def spy(*a, **kw):
            out = orig(*a, **kw)
            if kw.get("_raw"):
                canvas_b, rest = out[0], out[1:]

                def counted(*ca, **ck):
                    traces["n"] += 1
                    return canvas_b(*ca, **ck)
                counted.mats = getattr(canvas_b, "mats", None)
                return (counted,) + rest
            return out

        monkeypatch.setattr(D, "make_batched_detector", spy)
        fn, _ = D.make_multi_detector_boxes(models, (96, 128), k=64,
                                            nms_iou=None,
                                            response_scale=[1.0, 2.0],
                                            with_n_weak=False)
        rects, scores, valid, label, count, _nw = \
            [np.asarray(x) for x in fn(imgs)]
    finally:
        M.set_cascade_backend("triton")

    # the fused program traced the canvas exactly once for two models
    assert traces["n"] == 1

    for kix, single in enumerate(singles):
        s_rects, s_scores, s_valid, s_count, _ = single
        sel = label == kix
        np.testing.assert_array_equal(
            rects[sel].reshape(2, -1, 4), s_rects)
        np.testing.assert_allclose(
            scores[sel].reshape(2, -1),
            s_scores * (1.0 if kix == 0 else 2.0), rtol=1e-6)
        np.testing.assert_array_equal(valid[sel].reshape(2, -1), s_valid)
        np.testing.assert_array_equal(count[:, kix], s_count)


def test_make_multi_detector_boxes_mesh_matches_unmeshed():
    """Heterogeneous multi-model serving under a mesh returns exactly the
    no-mesh outputs (CPU-mesh equality backing the dryrun's multi-model
    leg, VERDICT r3 #4)."""
    import jax
    import jax.numpy as jnp
    import pytest

    from waldboost_tpu import model as M
    from waldboost_tpu.parallel import detect as D
    from waldboost_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh(4)
    models = _hetero_models()
    rng = np.random.RandomState(11)
    imgs = jnp.asarray(rng.randint(0, 256, (4, 96, 128)).astype(np.uint8))

    try:
        M.set_cascade_backend("triton")
        fn0, _ = D.make_multi_detector_boxes(models, (96, 128), k=32,
                                             nms_iou=0.5,
                                             with_n_weak=False)
        plain = [np.asarray(x) for x in fn0(imgs)]
        fnm, _ = D.make_multi_detector_boxes(models, (96, 128), k=32,
                                             nms_iou=0.5, mesh=mesh,
                                             with_n_weak=False)
        meshed = [np.asarray(x) for x in fnm(imgs)]
    finally:
        M.set_cascade_backend("triton")

    for a, b in zip(plain, meshed):
        np.testing.assert_array_equal(a, b)
