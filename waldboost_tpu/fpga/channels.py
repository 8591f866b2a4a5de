"""FPGA integer channel functions: uint8-in / uint8-out gradient features.

Parity with /root/reference/waldboost/fpga/channels.py (numba stencils):
3x3 Sobel gradients computed in int32 with *zero borders* (stencil default),
fixed-orientation responses, ``min(abs(y)//4, 255)`` uint8 quantization with
truncation-toward-zero on the half-integer orientations (int32 array
assignment semantics of the reference, fpga/channels.py:46-48).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..channels import ChannelFunction, register_channel_function

__all__ = ["grad_hist_4_u1", "grad_mag_u1"]


def _sobel_int32(image: jax.Array):
    """(H, W) any-int/uint image -> (dx, dy) int32 with zero 1px borders.

    dx kernel [[-1,0,1],[-2,0,2],[-1,0,1]], dy its transpose
    (/root/reference/waldboost/fpga/channels.py:5-27).
    """
    x = image.astype(jnp.int32)
    # valid-region correlations via shifted adds
    c0 = x[:, :-2]
    c2 = x[:, 2:]
    dx_rows = c2 - c0                       # per-row [-1, 0, 1]
    dx = dx_rows[:-2, :] + 2 * dx_rows[1:-1, :] + dx_rows[2:, :]
    r0 = x[:-2, :]
    r2 = x[2:, :]
    dy_cols = r2 - r0
    dy = dy_cols[:, :-2] + 2 * dy_cols[:, 1:-1] + dy_cols[:, 2:]
    pad = ((1, 1), (1, 1))
    return jnp.pad(dx, pad), jnp.pad(dy, pad)


def _grad_hist_4_u1_fn(image: jax.Array) -> jax.Array:
    """4 fixed orientations {dx, (dx-dy)/2, dy, (dx+dy)/2} ->
    min(|y|//4, 255) uint8 (/root/reference/waldboost/fpga/channels.py:29-53).
    The half-integer orientations truncate toward zero (int32 assignment)."""
    dx, dy = _sobel_int32(image)
    y0 = dx
    # 0.5*dx - 0.5*dy assigned into an int32 array -> C truncation toward zero
    y1 = (0.5 * dx - 0.5 * dy).astype(jnp.int32)
    y2 = dy
    y3 = (0.5 * dx + 0.5 * dy).astype(jnp.int32)
    y = jnp.stack([y0, y1, y2, y3], axis=0)
    return jnp.minimum(jnp.abs(y) // 4, 255).astype(jnp.uint8)


def _grad_mag_u1_fn(image: jax.Array) -> jax.Array:
    """max(|dx|, |dy|)//4 clamped to 255, 1 channel
    (/root/reference/waldboost/fpga/channels.py:56-67)."""
    dx, dy = _sobel_int32(image)
    y = jnp.maximum(jnp.abs(dx), jnp.abs(dy))
    return jnp.minimum(y // 4, 255).astype(jnp.uint8)[None]


def _sobel_poly(planes):
    """Sobel (dx, dy) on a 2x2-polyphase image canvas, f32 (integer values
    <= 2040 are exact), zero boundary fill.  planes[a, b, i, j] =
    canvas[2i+a, 2j+b]; outputs in the same layout.  Matches
    :func:`_sobel_int32` exactly (integer sums are order-independent in f32;
    the zero fill only reaches canvas margins/gaps, which the stencil border
    mask zeroes anyway)."""
    from ..channels import _shift

    P = [[planes[0, 0], planes[0, 1]], [planes[1, 0], planes[1, 1]]]
    # vertical smooth sy[a][b] = x[2i+a-1, 2j+b] + 2 x[2i+a, 2j+b]
    #                            + x[2i+a+1, 2j+b]
    sy = [[_shift(P[1][b], -1, 0) + 2.0 * P[0][b] + P[1][b] for b in (0, 1)],
          [P[0][b] + 2.0 * P[1][b] + _shift(P[0][b], +1, 0) for b in (0, 1)]]
    # dx[a][b] = sy[2i+a, 2j+b+1] - sy[2i+a, 2j+b-1]  (right minus left)
    dx = [[sy[a][1] - _shift(sy[a][1], 0, -1),
           _shift(sy[a][0], 0, +1) - sy[a][0]] for a in (0, 1)]
    # horizontal smooth sx[a][b] = x[.., 2j+b-1] + 2 x[.., 2j+b] + x[.., 2j+b+1]
    sx = [[_shift(P[a][1], 0, -1) + 2.0 * P[a][0] + P[a][1],
           P[a][0] + 2.0 * P[a][1] + _shift(P[a][0], 0, +1)]
          for a in (0, 1)]
    # dy[a][b] = sx[2i+a+1, 2j+b] - sx[2i+a-1, 2j+b]  (below minus above)
    # a=0: below = row 2i+1 = phase1[i] (no shift); above = 2i-1 = phase1[i-1]
    dy = [[sx[1][b] - _shift(sx[1][b], -1, 0) for b in (0, 1)],
          [_shift(sx[0][b], +1, 0) - sx[0][b] for b in (0, 1)]]
    dx = jnp.stack([jnp.stack(r) for r in dx])
    dy = jnp.stack([jnp.stack(r) for r in dy])
    return dx, dy


def _fpga_poly_channels(planes, ctx, responses):
    """Shared polyphase tail: quantize -> stencil ring mask -> uint8-wrap
    2x2 average pool, all bit-identical to the canvas path
    (avg_pool_2's uint8 sums wrap mod 256; mod commutes with addition, so
    one wrap of the exact f32 sum reproduces the stepwise uint8 adds)."""
    qs = [jnp.minimum(jnp.floor(jnp.abs(y) * 0.25), 255.0)
          for y in responses]
    q = jnp.stack(qs)  # (C, 2, 2, H, W) integer-valued f32 in [0, 255]
    if ctx.border_mask_poly is not None:
        q = jnp.where(ctx.border_mask_poly[None], q, 0.0)
    s = (q[:, 0, 0] + q[:, 1, 0]) + (q[:, 0, 1] + q[:, 1, 1])
    s = s - 256.0 * jnp.floor(s * (1.0 / 256.0))  # uint8 wraparound
    return jnp.floor(s * 0.25)  # /4 truncation (nonneg)


def _grad_hist_4_u1_poly_fn(planes, ctx):
    """Polyphase grad_hist_4_u1 + shrink-2 pool: identical values to
    _grad_hist_4_u1_canvas_fn -> avg_pool_2 -> f32, stride-free."""
    dx, dy = _sobel_poly(planes.astype(jnp.float32))
    y1 = jnp.trunc(0.5 * dx - 0.5 * dy)  # int32-assignment truncation
    y3 = jnp.trunc(0.5 * dx + 0.5 * dy)
    return _fpga_poly_channels(planes, ctx, [dx, y1, dy, y3])


def _grad_mag_u1_poly_fn(planes, ctx):
    dx, dy = _sobel_poly(planes.astype(jnp.float32))
    y = jnp.maximum(jnp.abs(dx), jnp.abs(dy))
    return _fpga_poly_channels(planes, ctx, [y])


def _grad_hist_4_u1_canvas_fn(canvas, ctx):
    """Canvas mode: one Sobel pass over the packed canvas; the numba-stencil
    zero-border convention is restored by masking each level's 1px ring."""
    out = _grad_hist_4_u1_fn(canvas)
    if ctx.border_mask is not None:
        out = jnp.where(ctx.border_mask[None], out, jnp.uint8(0))
    return out


def _grad_mag_u1_canvas_fn(canvas, ctx):
    out = _grad_mag_u1_fn(canvas)
    if ctx.border_mask is not None:
        out = jnp.where(ctx.border_mask[None], out, jnp.uint8(0))
    return out


grad_hist_4_u1 = register_channel_function(
    ChannelFunction(
        name="waldboost_tpu.fpga.channels.grad_hist_4_u1",
        fn=_grad_hist_4_u1_fn,
        n_channels=4,
        aliases=("grad_hist_4_u1", "waldboost.fpga.channels.grad_hist_4_u1",
                 "waldboost.fpga.nb_channels.grad_hist_4_u1"),
        halo=0,
        boundary="stencil_zero",
        canvas_fn=_grad_hist_4_u1_canvas_fn,
        canvas_fn_poly=_grad_hist_4_u1_poly_fn,
    )
)

grad_mag_u1 = register_channel_function(
    ChannelFunction(
        name="waldboost_tpu.fpga.channels.grad_mag_u1",
        fn=_grad_mag_u1_fn,
        n_channels=1,
        aliases=("grad_mag_u1", "waldboost.fpga.channels.grad_mag_u1",
                 "waldboost.fpga.nb_channels.grad_mag_u1"),
        halo=0,
        boundary="stencil_zero",
        canvas_fn=_grad_mag_u1_canvas_fn,
        canvas_fn_poly=_grad_mag_u1_poly_fn,
    )
)
