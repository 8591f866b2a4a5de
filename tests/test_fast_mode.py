"""Opt-in fast serving mode (WB_SERVING_MODE=fast): deviation bounds.

Fast mode trades the bit-exactness contract for throughput: float content
skips the double-float exactness chains and the cascade kernel reads a
bf16 canvas (compared in f32).  These tests pin: exact mode unchanged,
fast-mode deviation bounded.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from __graft_entry__ import _flagship_model
from waldboost_tpu.parallel.detect import make_batched_detector_boxes


@pytest.fixture()
def model():
    return _flagship_model(seed=0, n_stages=16, shape=(8, 8, 4),
                           channel_opts=dict(shrink=2, n_per_oct=2, smooth=1,
                                             channels="grad_hist"),
                           image_hw=(96, 128))


def _build(model, mode):
    prev = os.environ.get("WB_SERVING_MODE")
    os.environ["WB_SERVING_MODE"] = mode
    try:
        fn, _ = make_batched_detector_boxes(model, (96, 128), k=512,
                                            with_n_weak=False)
    finally:
        if prev is None:
            os.environ.pop("WB_SERVING_MODE", None)
        else:
            os.environ["WB_SERVING_MODE"] = prev
    return fn


def _boxes(out, b):
    rects, scores, valid, count, _ = out
    v = np.asarray(valid[b])
    return ({tuple(np.round(x, 2)) for x in np.asarray(rects[b])[v]},
            np.asarray(scores[b])[v])


def test_fast_mode_bounded_deviation(model):
    rng = np.random.RandomState(0)
    imgs = jnp.asarray(rng.randint(0, 256, (4, 96, 128)).astype(np.uint8))
    oe = _build(model, "exact")(imgs)
    of = _build(model, "fast")(imgs)
    total = flips = 0
    for b in range(4):
        se, _ = _boxes(oe, b)
        sf, _ = _boxes(of, b)
        total += max(len(se), 1)
        flips += len(se ^ sf)
    # deviation exists but is a small fraction of boxes
    assert flips <= 0.25 * total, (flips, total)


def test_fast_mode_float_images_bounded_deviation(model):
    """Float frames in fast mode take plain f32 chains (f32 planes, plain
    lerp — polyphase._combine_block_plain) instead of the dd-exact chain —
    boxes must stay close to the exact float path's.  WB_FAST_FLOAT=bf16
    additionally quantizes the content (looser bound)."""
    rng = np.random.RandomState(2)
    base = rng.randint(0, 256, (4, 96, 128)).astype(np.float32)
    imgs = jnp.asarray(base + rng.rand(4, 96, 128).astype(np.float32))
    oe = _build(model, "exact")(imgs)
    of = _build(model, "fast")(imgs)
    prev = os.environ.get("WB_FAST_FLOAT")
    os.environ["WB_FAST_FLOAT"] = "bf16"
    try:
        oq = _build(model, "fast")(imgs)
    finally:
        if prev is None:
            os.environ.pop("WB_FAST_FLOAT", None)
        else:
            os.environ["WB_FAST_FLOAT"] = prev
    total = flips = flips_q = 0
    for b in range(4):
        se, _ = _boxes(oe, b)
        sf, _ = _boxes(of, b)
        sq, _ = _boxes(oq, b)
        total += max(len(se), 1)
        flips += len(se ^ sf)
        flips_q += len(se ^ sq)
    # default (f32 planes): same deviation sources as the uint8 fast path
    assert flips <= 0.25 * total, (flips, total)
    # bf16 content quantization: looser, but still a working detector
    assert flips_q <= 0.6 * total, (flips_q, total)


def test_fast_mode_float_sharded_matches_unsharded(model):
    """Fast-float serving under a device mesh must equal the unsharded
    fast-float program bitwise (batch sharding only re-partitions the
    same deterministic kernels)."""
    import jax
    import pytest

    from waldboost_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh(4)
    rng = np.random.RandomState(3)
    imgs = jnp.asarray(rng.rand(4, 96, 128).astype(np.float32) * 255.0)

    prev = os.environ.get("WB_SERVING_MODE")
    os.environ["WB_SERVING_MODE"] = "fast"
    try:
        fu, _ = make_batched_detector_boxes(model, (96, 128), k=512,
                                            with_n_weak=False)
        fs, _ = make_batched_detector_boxes(model, (96, 128), k=512,
                                            mesh=mesh, with_n_weak=False)
    finally:
        if prev is None:
            os.environ.pop("WB_SERVING_MODE", None)
        else:
            os.environ["WB_SERVING_MODE"] = prev
    ou, os_ = fu(imgs), fs(imgs)
    for b in range(4):
        su, _ = _boxes(ou, b)
        ss, _ = _boxes(os_, b)
        assert su == ss, (b, su ^ ss)


def test_exact_mode_env_default_unchanged(model):
    """Without the env (default), the serving path must equal an explicit
    WB_SERVING_MODE=exact build bit-for-bit."""
    rng = np.random.RandomState(1)
    imgs = jnp.asarray(rng.randint(0, 256, (2, 96, 128)).astype(np.uint8))
    o_def = _build(model, os.environ.get("WB_SERVING_MODE", "exact"))(imgs)
    o_ex = _build(model, "exact")(imgs)
    for a, b in zip(o_def[:4], o_ex[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
