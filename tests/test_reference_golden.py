"""Golden parity against the ACTUAL reference implementation.

The reference at /root/reference cannot import in this image (bbx, numba,
skimage are absent), so tests/refshims/ vendors minimal test-only stand-ins
(numba.njit = pass-through + a tiny @stencil interpreter, an exact-integer
skimage resize, bbx = waldboost_tpu.boxes).  With those, the *reference's
own code* executes and produces golden channels, detections, scores, and
model files.

The contract asserted here is EXACTNESS: channel pyramids are bit-equal
(ops.exact computes the uint8 resize truncation and the f64-promoted
grad_hist projections exactly; the only tolerated exception is the
exact-cancellation line where BOTH sides are < 2^-40 — PARITY.md §1c), and
detection boxes+scores match with ZERO mismatches over a 100+ image corpus
including structured fake_data_generator images.
"""

import os
import sys

import numpy as np
import pytest

REF_PATH = "/root/reference"


@pytest.fixture(scope="module")
def ref():
    if not os.path.isdir(os.path.join(REF_PATH, "waldboost")):
        pytest.skip("reference repo not available")
    # numpy >= 1.24 removed these aliases the reference predates
    for name, val in [("bool", bool), ("int", int), ("float", float)]:
        if name not in np.__dict__:
            setattr(np, name, val)
    shims = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "refshims")
    if shims not in sys.path:
        sys.path.insert(0, shims)
    if REF_PATH not in sys.path:
        sys.path.insert(0, REF_PATH)
    # the reference generates model_pb2 at build time and does not check it
    # in; our proto is wire-compatible (same fields/numbers), so seed it
    from waldboost_tpu.proto import codec
    sys.modules.setdefault("waldboost.model_pb2", codec)
    import waldboost  # noqa: F401  (the reference package)
    return waldboost


def _tiny_model(n_stages=12, seed=0):
    from __graft_entry__ import _flagship_model
    return _flagship_model(seed=seed, n_stages=n_stages, shape=(8, 8, 4),
                           calibrated=True, image_hw=(96, 128),
                           channel_opts=dict(shrink=2, n_per_oct=4, smooth=1,
                                             channels="grad_hist"))


def _to_ref_model(model, ref, tmp_path):
    path = str(tmp_path / "m.pb")
    model.save(path)
    rmodel = ref.Model.load(path)
    # the dotted func name in the .pb resolves to OUR ChannelFunction, which
    # returns channel-major (C, H, W); the reference pipeline wants its own
    # HWC channel function
    rmodel.channel_opts["channels"] = ref.channels.grad_hist
    return rmodel


def _assert_channels_bitequal(rc, tc):
    """Bit-equal except the documented exact-cancellation exception: any
    differing value must be < 2^-40 on BOTH sides (PARITY.md §1c)."""
    rc32 = rc.astype(np.float32)
    tc32 = np.asarray(tc, np.float32)
    neq = rc32 != tc32
    if neq.any():
        tiny = 2.0 ** -40
        both_tiny = (np.abs(rc32[neq]) < tiny) & (np.abs(tc32[neq]) < tiny)
        assert both_tiny.all(), (
            int(neq.sum()), float(np.abs(rc32[neq] - tc32[neq]).max()))


def test_reference_channel_pyramid_golden(ref):
    """Our channel pyramid vs the reference's own code: BIT-EQUAL, level by
    level, on random and structured images."""
    import waldboost_tpu as wb
    from waldboost_tpu.utils import fake_data_generator

    rng = np.random.RandomState(7)
    gen = fake_data_generator(seed=13)
    images = [rng.randint(0, 256, (96, 128)).astype(np.uint8)
              for _ in range(3)]
    images += [np.atleast_3d(next(gen)["image"])[:, :, 0] for _ in range(2)]
    opts_ref = dict(shrink=2, n_per_oct=4, smooth=1,
                    channels=ref.channels.grad_hist)
    opts_ours = dict(shrink=2, n_per_oct=4, smooth=1, channels="grad_hist")
    for img in images:
        ref_levels = list(ref.channels.channel_pyramid(img, opts_ref))
        our_levels = list(wb.channels.channel_pyramid(img, opts_ours))
        assert len(ref_levels) == len(our_levels)
        for (rc, rs), (tc, ts) in zip(ref_levels, our_levels):
            assert rc.shape == tc.shape
            assert rs == pytest.approx(ts, rel=1e-9)
            _assert_channels_bitequal(rc, tc)


def test_reference_predict_exact(ref, tmp_path):
    """Identical inputs -> the reference's Model.predict and ours agree
    EXACTLY (tree routing + score accumulation, no resize involved)."""
    model = _tiny_model()
    rmodel = _to_ref_model(model, ref, tmp_path)
    rng = np.random.RandomState(3)
    X = (rng.rand(257, 8, 8, 4) * 30).astype(np.float32)
    H_ref, mask_ref = rmodel.predict(X)
    H_ours, mask_ours = model.predict(X)
    np.testing.assert_array_equal(np.asarray(mask_ref), mask_ours)
    fin = np.isfinite(H_ref)
    np.testing.assert_array_equal(fin, np.isfinite(H_ours))
    np.testing.assert_array_equal(H_ref[fin], H_ours[fin])


def test_reference_predict_on_image_exact(ref, tmp_path):
    """Dense-grid scan on an identical channel tensor: exact survivor set."""
    model = _tiny_model()
    rmodel = _to_ref_model(model, ref, tmp_path)
    rng = np.random.RandomState(4)
    chns = (rng.rand(40, 56, 4) * 25).astype(np.float32)
    r_ref, c_ref, h_ref = rmodel.predict_on_image(chns)
    r_ours, c_ours, h_ours = model.predict_on_image(chns)
    ref_set = np.stack([r_ref, c_ref], 1)
    our_set = np.stack([r_ours, c_ours], 1)
    order_r = np.lexsort(ref_set.T)
    order_t = np.lexsort(our_set.T)
    np.testing.assert_array_equal(ref_set[order_r], our_set[order_t])
    np.testing.assert_array_equal(np.asarray(h_ref)[order_r],
                                  h_ours[order_t])


def test_reference_detect_golden(ref, tmp_path):
    """End-to-end detection boxes vs the reference's own pipeline: ZERO
    mismatches (boxes AND scores) over a 100+ image corpus mixing random
    noise with structured fake_data_generator scenes (north-star contract:
    detections identical to the CPU reference)."""
    from waldboost_tpu.utils import fake_data_generator

    model = _tiny_model()
    rmodel = _to_ref_model(model, ref, tmp_path)
    rng = np.random.RandomState(5)
    gen = fake_data_generator(seed=21)
    images = [rng.randint(0, 256, (72, 96)).astype(np.uint8)
              for _ in range(64)]
    images += [np.atleast_3d(next(gen)["image"])[:, :, 0]
               for _ in range(40)]
    n_total = 0
    n_mismatch = 0
    for img in images:
        ref_boxes = rmodel.detect(img)
        our_boxes = model.detect(img)
        a = np.round(np.concatenate(
            [ref_boxes.get(), ref_boxes.get_field("scores")[:, None]], 1), 3)
        b = np.round(np.concatenate(
            [our_boxes.get(), our_boxes.get_field("scores")[:, None]], 1), 3)
        sa = set(map(tuple, a))
        sb = set(map(tuple, b))
        n_total += max(len(sa), len(sb), 1)
        n_mismatch += len(sa ^ sb) // 2 + len(sa ^ sb) % 2
    assert n_total > 100
    assert n_mismatch == 0, (n_mismatch, n_total)


def test_reference_written_pb_loads_bitcompatible(ref, tmp_path):
    """A model file WRITTEN BY THE REFERENCE loads here with identical
    behavior (wire compatibility in the reference->this-package direction)."""
    import waldboost_tpu as wb

    model = _tiny_model(seed=9)
    rmodel = _to_ref_model(model, ref, tmp_path)
    path = str(tmp_path / "ref_written.pb")
    rmodel.save(path)
    ours = wb.load(path)
    assert len(ours) == len(model)
    assert ours.shape == model.shape
    rng = np.random.RandomState(11)
    X = (rng.rand(128, 8, 8, 4) * 30).astype(np.float32)
    H0, m0 = model.predict(X)
    H1, m1 = ours.predict(X)
    np.testing.assert_array_equal(m0, m1)
    np.testing.assert_array_equal(H0[m0], H1[m1])


def test_reference_written_learner_pickle_loads(ref, tmp_path):
    """A Learner checkpoint WRITTEN BY THE REFERENCE loads here.

    The reference pickles ``Learner.__dict__`` including the ``wh`` class
    object (/root/reference/waldboost/training.py:125-132), so the file
    carries a ``waldboost.training.DTree`` global; ``Learner.load``'s
    interop unpickler must remap it to this package's DTree."""
    import waldboost_tpu as wb
    from waldboost_tpu.training import DTree

    rL = ref.training.Learner(alpha=0.15, max_depth=2)
    rL.p0 = [0.8, 0.7]
    rL.p1 = [0.99, 0.98]
    rL.losses = [0.9, 0.85]
    path = str(tmp_path / "ref_learner.pkl")
    rL.save(path)

    ours = wb.Learner.load(path)
    assert ours.alpha == 0.15
    assert ours.wh is DTree  # remapped, NOT the reference class
    assert ours.wh_args == {"max_depth": 2}
    assert ours.p0 == [0.8, 0.7]
    assert ours.p1 == [0.99, 0.98]
    assert ours.losses == [0.9, 0.85]
    assert len(ours) == 2

    # and the round-trip back through OUR save stays loadable
    path2 = str(tmp_path / "resaved.pkl")
    ours.save(path2)
    again = wb.Learner.load(path2)
    assert again.wh is DTree and again.losses == [0.9, 0.85]


def test_reference_fpga_channels_golden(ref):
    """Integer FPGA channels vs the reference's stencil code: exact."""
    from waldboost_tpu.fpga.channels import grad_hist_4_u1, grad_mag_u1
    from waldboost.fpga import channels as ref_fpga

    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (64, 80)).astype(np.uint8)
    ref_gh = ref_fpga.grad_hist_4_u1(img)           # (H, W, 4) uint8
    our_gh = np.asarray(grad_hist_4_u1(img))        # (4, H, W) uint8
    np.testing.assert_array_equal(ref_gh, np.transpose(our_gh, (1, 2, 0)))
    ref_gm = ref_fpga.grad_mag_u1(img)
    our_gm = np.asarray(grad_mag_u1(img))
    np.testing.assert_array_equal(np.atleast_3d(ref_gm),
                                  np.transpose(our_gm, (1, 2, 0)))


def test_reference_detect_trained_model_golden(ref, tmp_path):
    """The committed REALLY-TRAINED cascade (models/flagship_synth_64.pb)
    produces identical boxes+scores through the reference's own pipeline —
    the exactness contract holds for trained thresholds/leaves, not just
    synthetic calibrated ones."""
    import waldboost_tpu as wb
    from waldboost_tpu.utils import fake_data_generator

    path = "/root/repo/models/flagship_synth_64.pb"
    if not os.path.exists(path):
        pytest.skip("trained model not present")
    model = wb.load(path)
    rmodel = ref.Model.load(path)
    rmodel.channel_opts["channels"] = ref.channels.grad_hist
    rng = np.random.RandomState(17)
    gen = fake_data_generator(seed=33)
    images = [np.atleast_3d(next(gen)["image"])[:, :, 0] for _ in range(6)]
    images += [rng.randint(0, 256, (256, 256)).astype(np.uint8)
               for _ in range(2)]
    n_boxes = 0
    for img in images:
        rb = rmodel.detect(img)
        tb = model.detect(img)
        a = set(map(tuple, np.round(np.concatenate(
            [rb.get(), rb.get_field("scores")[:, None]], 1), 3)))
        b = set(map(tuple, np.round(np.concatenate(
            [tb.get(), tb.get_field("scores")[:, None]], 1), 3)))
        assert a == b, (len(a ^ b), len(a), len(b))
        n_boxes += len(a)
    assert n_boxes > 0  # the trained detector actually fires on scenes


def test_reference_float_image_golden(ref, tmp_path):
    """Float-typed images through the same pipeline (the reference accepts
    any 2-D ndarray, /root/reference/waldboost/channels.py:104-142).

    The ONE deviation for float inputs is the resize: the reference lerps
    in f64 and casts to the input dtype; the device lerps in f32 (PARITY.md
    "Floating-point status", ~1.5e-5 absolute on a 0..255 dynamic range).
    This pins that deviation with numbers instead of a sentence: channel
    pyramids agree to a tight tolerance, detection box sets flip only on
    threshold-borderline windows (bounded fraction), and shared boxes'
    scores differ only where a tree split sat within the resize noise."""
    import waldboost_tpu as wb
    from waldboost_tpu.utils import fake_data_generator

    model = _tiny_model()
    rmodel = _to_ref_model(model, ref, tmp_path)
    rng = np.random.RandomState(6)
    gen = fake_data_generator(seed=31)
    images = [(rng.rand(72, 96) * 255.0).astype(np.float32)
              for _ in range(10)]
    images += [np.atleast_3d(next(gen)["image"])[:, :, 0].astype(np.float32)
               for _ in range(10)]

    # channel pyramid: float path within the measured ULP bound (PARITY.md
    # "Floating-point status")
    from waldboost_tpu.testing import ulp_distance as ulp_dist

    opts_ref = dict(shrink=2, n_per_oct=4, smooth=1,
                    channels=ref.channels.grad_hist)
    opts_ours = dict(shrink=2, n_per_oct=4, smooth=1, channels="grad_hist")
    max_ulp = 0
    for img in images[:4]:
        ref_levels = list(ref.channels.channel_pyramid(img, opts_ref))
        our_levels = list(wb.channels.channel_pyramid(img, opts_ours))
        assert len(ref_levels) == len(our_levels)
        for (rc, rs), (tc, ts) in zip(ref_levels, our_levels):
            assert rc.shape == tc.shape
            assert rs == pytest.approx(ts, rel=1e-9)
            rc32 = rc.astype(np.float32)
            tc32 = np.asarray(tc, np.float32)
            np.testing.assert_allclose(tc32, rc32, rtol=1e-5, atol=1e-5)
            max_ulp = max(max_ulp, int(ulp_dist(tc32, rc32).max()))
    # round-5 double-float path (ops.dd): resize lerp, [1,2,1] prefilter
    # accumulation, and projection store all replicate the reference's f64
    # chains; the sole residue is resize values landing ON f32 rounding
    # midpoints (rational pyramid scales make those COMMON), where the f64
    # chain's 2^-53 noise picks the side — measured 0.09% of values, <=5
    # ULP after downstream amplification (was 260 ULP in round 4).
    # Emulating f64's per-op roundings needs triple-f32 expansions +
    # per-element directed rounding (~10-20x the dd op count) — the
    # PARITY.md float-status record justifies stopping at this bound.
    assert max_ulp <= 16, max_ulp

    # detections: identical box geometry up to threshold-borderline flips
    n_total = n_flip = n_common = n_score_off = 0
    for img in images:
        rb = rmodel.detect(img)
        tb = model.detect(img)
        a = {tuple(np.round(r, 3)): s for r, s in
             zip(rb.get(), rb.get_field("scores"))}
        b = {tuple(np.round(r, 3)): s for r, s in
             zip(tb.get(), tb.get_field("scores"))}
        n_total += max(len(a), len(b), 1)
        n_flip += len(set(a) ^ set(b))
        for key in set(a) & set(b):
            n_common += 1
            if abs(a[key] - b[key]) > 1e-3:
                n_score_off += 1  # a split within the resize noise flipped
    assert n_common > 100
    assert n_flip <= 0.005 * n_total, (n_flip, n_total)
    assert n_score_off <= 0.005 * n_common, (n_score_off, n_common)
