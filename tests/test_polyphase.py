"""Polyphase canvas pipeline: exact equality with the full-resolution path.

The shrink=2 fast path materializes the packed image canvas as its 2x2
polyphase decomposition (model._channel_canvas_poly); stencils become
cross-phase shifted adds and the average pool becomes elementwise.  These
tests pin bit-exactness against the interleaved full-resolution pipeline,
whose semantics are in turn oracle-tested (tests/test_channels.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from waldboost_tpu import model as M
from waldboost_tpu.channels import _normalize_opts
from waldboost_tpu.ops.warp import reflect_halos, reflect_halos_poly


@pytest.mark.parametrize("hw", [(96, 128), (240, 320)])
@pytest.mark.parametrize("smooth", [0, 1])
def test_poly_canvas_exact(hw, smooth):
    h, w = hw
    opts = dict(shrink=2, n_per_oct=4, smooth=smooth, channels="grad_hist")
    shrink, n_per_oct, sm, cf = _normalize_opts(opts)
    packed = M._packed_plan_cached(h, w, shrink, n_per_oct, (12, 12),
                                   halo=cf.halo)
    rng = np.random.RandomState(11)
    img = jnp.asarray(rng.randint(0, 256, (h, w)).astype(np.uint8))
    poly = np.asarray(M._channel_canvas_poly(img, sm, cf, packed))
    cf_old = dataclasses.replace(cf, canvas_fn_poly=None)
    old = np.asarray(M._channel_canvas_fast(img, shrink, sm, cf_old, packed))
    assert np.array_equal(poly, old)


@pytest.mark.parametrize("hw,npo", [((48, 64), 2), ((96, 128), 2),
                                    ((160, 256), 4)])
def test_poly_canvas_batch_matches_single(hw, npo):
    """The batched serving canvas (polyphase chain vmapped over a batch)
    equals the single-image polyphase canvas bitwise, image by image."""
    h, w = hw
    opts = dict(shrink=2, n_per_oct=npo, smooth=1, channels="grad_hist")
    shrink, n_per_oct, sm, cf = _normalize_opts(opts)
    packed = M._packed_plan_cached(h, w, shrink, n_per_oct, (8, 8),
                                   halo=cf.halo)
    rng = np.random.RandomState(7)
    imgs = jnp.asarray(rng.randint(0, 256, (2, h, w)).astype(np.uint8))
    got = np.asarray(M._channel_canvas_batch(imgs, shrink, n_per_oct, sm, cf,
                                             packed))
    for b in range(2):
        ref = np.asarray(M._channel_canvas_poly(imgs[b], sm, cf, packed))
        np.testing.assert_array_equal(got[b], ref)


def test_reflect_halos_poly_matches_interleaved():
    rng = np.random.RandomState(2)
    H, W = 64, 96
    canvas = rng.rand(H, W).astype(np.float32)
    regions = ((8, 8, 16, 20, 3), (30, 40, 24, 32, 6))
    ref = np.asarray(reflect_halos(jnp.asarray(canvas), regions))
    planes = jnp.asarray(
        np.stack([[canvas[0::2, 0::2], canvas[0::2, 1::2]],
                  [canvas[1::2, 0::2], canvas[1::2, 1::2]]]))
    out = np.asarray(reflect_halos_poly(planes, regions))
    inter = np.zeros((H, W), np.float32)
    inter[0::2, 0::2] = out[0, 0]
    inter[0::2, 1::2] = out[0, 1]
    inter[1::2, 0::2] = out[1, 0]
    inter[1::2, 1::2] = out[1, 1]
    assert np.array_equal(inter, ref)
