import numpy as np
import pytest

import waldboost_tpu as wb
from waldboost_tpu import training as tr


def gaussian_data(n=400, f=32, sep=2.0, seed=0):
    rng = np.random.RandomState(seed)
    X0 = rng.randn(n, 4, 4, 2).astype("f")
    X1 = rng.randn(n, 4, 4, 2).astype("f")
    X1[:, 1, 2, 0] += sep  # one separating feature
    return X0, X1


def test_weights():
    H = np.array([0.0, 1.0, -1.0], "f")
    w = tr.weights(H)
    np.testing.assert_allclose(w, np.exp(H) / 3 / 2, rtol=1e-6)


@pytest.mark.parametrize("backend", ["hist", "sklearn"])
def test_dtree_fit_separates(backend):
    X0, X1 = gaussian_data(sep=3.0)
    W0 = np.full(len(X0), 1.0 / len(X0), "f")
    W1 = np.full(len(X1), 1.0 / len(X1), "f")
    tree = tr.DTree.fit(X0, W0, X1, W1, max_depth=2, backend=backend)
    p0 = tree.predict(X0)
    p1 = tree.predict(X1)
    # most negatives score below most positives
    assert (p0 < 0).mean() > 0.8
    assert (p1 > 0).mean() > 0.8
    # the discovered root feature should be the separating one
    assert tuple(tree.feature[0]) == (1, 2, 0)


def test_dtree_quantile_binning_survives_outliers():
    """A separating feature whose mass sits in [0, 1] with a few 1e6
    outliers: the uniform-256 grid collapses the mass into one bin (the
    measured round-2 training-quality gap), quantile edges keep resolving
    the split.  Fit/inference consistency: thresholds are data values, so
    predict must reproduce the fitted split exactly."""
    rng = np.random.RandomState(3)
    n = 500
    X0 = rng.rand(n, 1, 1, 2).astype("f") * 0.45        # class 0: [0, .45]
    X1 = (rng.rand(n, 1, 1, 2) * 0.45 + 0.55).astype("f")  # class 1: [.55, 1]
    X0[:3, 0, 0, 0] = 1e6  # outliers stretch the uniform grid
    X0[:, 0, 0, 1] = rng.randn(n)  # noise feature
    X1[:, 0, 0, 1] = rng.randn(n)
    W0 = np.full(n, 1.0 / n, "f")
    W1 = np.full(n, 1.0 / n, "f")
    tq = tr.DTree.fit(X0, W0, X1, W1, max_depth=1, backend="hist",
                      binning="quantile")
    assert tuple(tq.feature[0]) == (0, 0, 0)
    # all non-outlier class-0 below, all class-1 above the fitted split
    p0, p1 = tq.predict(X0[3:]), tq.predict(X1)
    assert (p0 < 0).all() and (p1 > 0).all()
    # uniform-256 on the same data cannot resolve the squeezed split
    tu = tr.DTree.fit(X0, W0, X1, W1, max_depth=1, backend="hist",
                      binning="uniform")
    pu0, pu1 = tu.predict(X0[3:]), tu.predict(X1)
    assert ((pu0 < 0).mean() < 0.9) or ((pu1 > 0).mean() < 0.9)


def test_dtree_hist_respects_feature_mask():
    X0, X1 = gaussian_data()
    W0 = np.full(len(X0), 1.0 / len(X0), "f")
    W1 = np.full(len(X1), 1.0 / len(X1), "f")
    F = 4 * 4 * 2
    sep_flat = np.ravel_multi_index((1, 2, 0), (4, 4, 2))
    allowed = [np.array([i for i in range(F) if i != sep_flat])] * 2
    tree = tr.DTree.fit(X0, W0, X1, W1, max_depth=2,
                        allowed_features=allowed, backend="hist")
    used = {np.ravel_multi_index(tuple(f), (4, 4, 2))
            for f, l in zip(tree.feature, tree.left) if l >= 0}
    assert sep_flat not in used


def test_dtree_clip_and_quantize():
    X0, X1 = gaussian_data(sep=5.0)
    W0 = np.full(len(X0), 1.0 / len(X0), "f")
    W1 = np.full(len(X1), 1.0 / len(X1), "f")
    tree = tr.DTree.fit(X0, W0, X1, W1, max_depth=1, clip=0.5, quantizer=32)
    assert np.abs(tree.prediction).max() <= 0.5 + 1e-6
    np.testing.assert_allclose(tree.prediction * 32,
                               np.round(tree.prediction * 32), atol=1e-5)


def test_dtree_proto_roundtrip():
    X0, X1 = gaussian_data()
    W0 = np.full(len(X0), 1.0 / len(X0), "f")
    W1 = np.full(len(X1), 1.0 / len(X1), "f")
    tree = tr.DTree.fit(X0, W0, X1, W1, max_depth=2)
    from waldboost_tpu.proto import codec
    pb = codec.DTree()
    tree.as_proto(pb)
    t2 = tr.DTree.from_proto(pb)
    X = np.concatenate([X0[:10], X1[:10]])
    np.testing.assert_allclose(tree.predict(X), t2.predict(X), rtol=1e-6)


def test_fit_rejection_threshold_reference_semantics():
    rng = np.random.RandomState(0)
    H0 = rng.randn(500) - 1
    H1 = rng.randn(500) + 1
    theta = tr.fit_rejection_threshold(H0, 1.0, H1, 1.0, alpha=0.2)
    # naive loop implementation of /root/reference/waldboost/training.py:191-220
    ts = np.sort(np.unique(np.concatenate([H0, H1])))[1:]
    R = np.array([((1.0 * (H0 < t).mean() + 0 + 1e-6)
                   / (1.0 * (H1 < t).mean() + 0 + 1e-6)) for t in ts])
    idx = np.nonzero(R > 5)[0]
    want = ts[idx.max()] if idx.size else -np.inf
    assert theta == pytest.approx(want)


def test_fit_rejection_threshold_degenerate():
    # non-overlapping -> min(H1)
    assert tr.fit_rejection_threshold(
        np.array([-2., -1.]), 1.0, np.array([1., 2.]), 1.0, 0.1) == 1.0
    # <3 unique values -> -inf
    assert tr.fit_rejection_threshold(
        np.array([0., 0.]), 1.0, np.array([0., 0.]), 1.0, 0.1) == -np.inf


def test_rejection_schedule():
    sched = tr.BasicRejectionSchedule(rejection_interval=(2, 5), target_p0=1e-5)
    assert sched(0, 1.0) == -np.inf
    assert sched(3, 1.0) is None
    assert sched(6, 1.0) == -np.inf
    assert sched(3, 1e-6) == -np.inf
    sched = tr.BasicRejectionSchedule(rejection_interval=None)
    assert sched(100, 1.0) is None


def test_fit_stage_and_learner_state(tmp_path):
    X0, X1 = gaussian_data(sep=3.0)
    H0 = np.zeros(len(X0), "f")
    H1 = np.zeros(len(X1), "f")
    model = wb.Model((4, 4, 2), dict(shrink=1, n_per_oct=2, smooth=0,
                                     channels="grad_hist"))
    learner = tr.Learner(alpha=0.2, max_depth=2)
    l1, p0, p1 = learner.fit_stage(model, X0, H0, X1, H1)
    assert len(model) == 1
    assert len(learner) == 1
    assert 0 <= p0 <= 1 and 0 <= p1 <= 1
    # learner checkpoint roundtrip
    f = tmp_path / "learner.pkl"
    learner.save(str(f))
    l2 = tr.Learner.load(str(f))
    assert l2.alpha == learner.alpha
    assert l2.p0 == learner.p0 and l2.p1 == learner.p1


def test_fit_stage_with_empty_positive_class():
    """Background-only training (min_tp=0 pools) must not crash: degenerate
    but legal — the reference's NOTES list this as a required behaviour."""
    X0, _ = gaussian_data()
    X1 = np.empty((0, 4, 4, 2), "f")
    model = wb.Model((4, 4, 2), dict(shrink=1, n_per_oct=2, smooth=0,
                                     channels="grad_hist"))
    learner = tr.Learner(alpha=0.2, max_depth=1)
    stage_loss, p0, p1 = learner.fit_stage(
        model, X0, np.zeros(len(X0), "f"), X1, np.zeros(0, "f"))
    assert len(model) == 1
    assert np.isfinite(stage_loss)
    assert model.theta[0] == -np.inf  # no basis for a threshold


def test_fit_stage_explicit_zero_theta_not_refit():
    """theta=0.0 must be used as-is (reference bug: falsy check re-fits it,
    SURVEY.md appendix)."""
    X0, X1 = gaussian_data(sep=3.0)
    model = wb.Model((4, 4, 2), dict(shrink=1, n_per_oct=2, smooth=0,
                                     channels="grad_hist"))
    learner = tr.Learner(alpha=0.2, max_depth=1)
    learner.fit_stage(model, X0, np.zeros(len(X0), "f"),
                      X1, np.zeros(len(X1), "f"), theta=0.0)
    assert model.theta[0] == 0.0


@pytest.mark.parametrize("chunk", [1, 7, 256, 1000, 4096])
def test_indicator_histogram_blocks(chunk):
    """The blocked indicator contraction equals a float64 NumPy histogram
    within the f32 reorder bound, whatever the block size (padding rows
    included): the fit's histograms do not depend on the pool's size."""
    import jax
    import jax.numpy as jnp

    from waldboost_tpu.ops.fit import indicator_histogram

    rng = np.random.RandomState(chunk)
    n, feat, nb = 1000, 6, 16
    X = rng.randn(n, feat).astype(np.float32)
    wc = rng.rand(3, n).astype(np.float32)
    edges = np.quantile(X, np.arange(1, nb) / nb, axis=0).astype(np.float32)
    got = np.asarray(jax.jit(indicator_histogram, static_argnums=3)(
        jnp.asarray(wc), jnp.asarray(X), jnp.asarray(edges), chunk))
    ind = (X[:, :, None] <= edges.T[None]).astype(np.float64)
    ref = np.einsum("cn,nfb->cfb", wc.astype(np.float64), ind)
    assert got.shape == ref.shape == (3, feat, nb - 1)
    np.testing.assert_allclose(got, ref, rtol=n * 2.0 ** -24, atol=0)


def test_hist_einsum_matches_scatter_path():
    """The indicator-einsum histogram path (f32 at HIGHEST precision)
    must grow the same tree as the segment-sum scatter path
    (WB_HIST_EINSUM=0) on well-separated data (association order differs,
    so only exact-tie splits could legitimately diverge)."""
    import os

    from waldboost_tpu.ops import fit as F

    rng = np.random.RandomState(7)
    n, feat = 512, 24
    X0 = rng.randn(n, feat).astype(np.float32)
    X1 = rng.randn(n, feat).astype(np.float32)
    X1[:, 5] += 2.5
    X0[:, 11] -= 1.5
    W0 = np.full(n, 0.5 / n, np.float32)
    W1 = np.full(n, 0.5 / n, np.float32)
    old = os.environ.get("WB_HIST_EINSUM")
    try:
        trees = {}
        for mode in ("1", "0"):
            os.environ["WB_HIST_EINSUM"] = mode
            tree = tr.DTree.fit(X0.reshape(n, feat, 1, 1), W0,
                                X1.reshape(n, feat, 1, 1), W1,
                                max_depth=2, backend="hist")
            trees[mode] = tree
    finally:
        if old is None:
            os.environ.pop("WB_HIST_EINSUM", None)
        else:
            os.environ["WB_HIST_EINSUM"] = old
    t1, t0 = trees["1"], trees["0"]
    f1 = [None if f is None else tuple(np.asarray(f).ravel())
          for f in t1.feature]
    f0 = [None if f is None else tuple(np.asarray(f).ravel())
          for f in t0.feature]
    assert f1 == f0
    np.testing.assert_allclose(t1.threshold, t0.threshold, rtol=1e-6)
    np.testing.assert_allclose(t1.prediction, t0.prediction, rtol=1e-5)


def test_train_on_hard_scene_distribution():
    """End-to-end training quality on the HARDER synthetic distribution
    (utils.scene_generator: multi-octave object sizes, variable aspect,
    ignore-flagged instances, textured clutter — VERDICT r4 #3): a small
    detector trained on it must rank held-out detections usefully, with
    the Evaluator's ignore machinery exercised by real ignore-flagged
    ground truth."""
    from itertools import islice

    import waldboost_tpu as wb
    from waldboost_tpu.testing import evaluate_model
    from waldboost_tpu.utils import scene_generator

    gen = scene_generator(seed=11, hw=(192, 192))
    model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                       channels="grad_hist"))
    pool = wb.SamplePool(min_tp=300, min_fp=300, seed=0)
    wb.train(model, gen, pool=pool, length=12,
             learner=wb.Learner(alpha=0.2, max_depth=2))
    assert len(model) == 12

    corpus = list(islice(scene_generator(seed=909, hw=(192, 192)), 60))
    # the held-out corpus must actually contain ignore-flagged instances
    n_ign = sum(int(d["groundtruth_boxes"].get_field("ignore").sum())
                for d in corpus if len(d["groundtruth_boxes"]))
    assert n_ign > 0
    res = evaluate_model(corpus, model).evaluate()
    # a 12-stage CPU-budget detector on the hard distribution: well above
    # chance, well below the easy distribution's ~0.75 (12 stages,
    # multi-octave objects)
    assert res["auc"] > 0.2, res["auc"]
