"""Resize-as-matmul and static halo-reflection permutations.

Building blocks of the canvas-first pyramid pipeline:

* :func:`resize_matrices` — bilinear resize expressed as two small dense
  matrices ``out = R_h @ img @ R_w.T`` (2 nonzeros per row): matrix
  products instead of gathers, and exactly the same arithmetic as lerp
  (each output row/col is a 2-term convex blend).
* :func:`reflection_permutation` — a static index map that fills designated
  halo bands of a canvas with symmetric reflections of the adjacent interior,
  leaving everything else in place.  Applying it is a single gather; it is
  how per-level reflect boundary semantics (scipy ``mode='reflect'``,
  /root/reference/waldboost/channels.py:19-27) survive packing many pyramid
  levels into one canvas.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["resize_matrices", "reflection_permutation", "apply_row_permutation"]


@functools.lru_cache(maxsize=None)
def _axis_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear sampling matrix, half-pixel-centre convention
    with edge clamping (same coordinates as ops.image.resize_bilinear)."""
    R = np.zeros((n_out, n_in), np.float32)
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    coords = np.clip(coords, 0.0, n_in - 1.0)
    i0 = np.floor(coords).astype(np.int64)
    i0 = np.minimum(i0, max(n_in - 2, 0))
    frac = (coords - i0).astype(np.float32)
    R[np.arange(n_out), i0] = 1.0 - frac
    if n_in > 1:
        R[np.arange(n_out), np.minimum(i0 + 1, n_in - 1)] += frac
    return R


def resize_matrices(h: int, w: int, nh: int, nw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (R_h, R_w) with ``resized = R_h @ img @ R_w.T``."""
    return _axis_matrix(h, nh), _axis_matrix(w, nw)


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 2-tap structure of :func:`_axis_matrix` as small vectors:
    ``(i0 int32 (n_out,), frac f32 (n_out,))`` with row r of the matrix =
    ``(1-frac[r])`` at col ``i0[r]`` plus ``frac[r]`` at ``min(i0[r]+1, n_in-1)``."""
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    coords = np.clip(coords, 0.0, n_in - 1.0)
    i0 = np.floor(coords).astype(np.int64)
    i0 = np.minimum(i0, max(n_in - 2, 0))
    frac = (coords - i0).astype(np.float32)
    return i0.astype(np.int32), frac


@functools.lru_cache(maxsize=None)
def resize_taps64(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`resize_taps` with the frac kept in FLOAT64 — the float-image
    exact path needs the unrounded f64 lerp weights (the reference resizes
    float images in f64, tests/refshims/skimage float branch)."""
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    coords = np.clip(coords, 0.0, n_in - 1.0)
    i0 = np.floor(coords).astype(np.int64)
    i0 = np.minimum(i0, max(n_in - 2, 0))
    return i0.astype(np.int32), coords - i0


def build_resize_matrix(i0: np.ndarray, frac: np.ndarray, n_in: int) -> jax.Array:
    """Materialize the (n_out, n_in) 2-tap resize matrix ON DEVICE from its
    tap vectors — bitwise equal to the host matrix of :func:`_axis_matrix`
    but without embedding an O(n_out * n_in) constant into the compiled
    program (large-image pyramids would otherwise ship 100+ MB of matrix
    constants to the compiler)."""
    i0 = jnp.asarray(i0, jnp.int32)
    frac = jnp.asarray(frac, jnp.float32)
    cols = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    t0 = jnp.where(cols == i0[:, None], 1.0 - frac[:, None], 0.0)
    i1 = jnp.minimum(i0 + 1, n_in - 1)
    t1 = jnp.where(cols == i1[:, None], frac[:, None], 0.0)
    return t0 + t1


def _reflect_index(q: int, lo: int, hi: int) -> int:
    """Symmetric reflection of coordinate q into [lo, hi): d c b a | a b c d."""
    n = hi - lo
    if n <= 0:
        return lo
    t = q - lo
    period = 2 * n
    t = t % period
    if t < 0:
        t += period
    if t >= n:
        t = period - 1 - t
    return lo + t


@functools.lru_cache(maxsize=64)
def reflection_permutation(canvas_shape: Tuple[int, int],
                           regions: Tuple[Tuple[int, int, int, int, int], ...]
                           ) -> np.ndarray:
    """Build a flat (H*W,) int32 index map.

    ``regions``: tuples ``(y, x, h, w, halo)`` — interior rectangles whose
    surrounding ``halo``-wide band should be filled with the symmetric
    reflection of the rectangle's content.  Pixels outside any band map to
    themselves.  Bands of different regions must not overlap (guaranteed by
    the halo-aware packer).
    """
    H, W = canvas_shape
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    for (y, x, h, w, halo) in regions:
        y0, y1 = max(y - halo, 0), min(y + h + halo, H)
        x0, x1 = max(x - halo, 0), min(x + w + halo, W)
        ys = np.arange(y0, y1)
        xs = np.arange(x0, x1)
        ry = np.array([_reflect_index(v, y, y + h) for v in ys], np.int64)
        rx = np.array([_reflect_index(v, x, x + w) for v in xs], np.int64)
        sub = (ry[:, None] * W + rx[None, :]).astype(np.int32)
        idx[y0:y1, x0:x1] = sub
    return idx.reshape(-1)


def apply_row_permutation(canvas: jax.Array, perm: np.ndarray) -> jax.Array:
    """Apply a flat permutation over the last two dims of (..., H, W)."""
    *lead, H, W = canvas.shape
    flat = canvas.reshape(tuple(lead) + (H * W,))
    out = jnp.take(flat, jnp.asarray(perm), axis=-1)
    return out.reshape(canvas.shape)


def reflect_halos_poly(planes: jax.Array,
                       regions: Sequence[Tuple[int, int, int, int, int]]
                       ) -> jax.Array:
    """Symmetric halo reflection on a 2x2-polyphase decomposition.

    ``planes``: (..., 2, 2, Hp, Wp) where ``planes[..., a, b, i, j]`` is the
    full-resolution canvas pixel ``(2i+a, 2j+b)``.  ``regions`` are
    full-resolution ``(y, x, h, w, halo)`` rectangles with even ``y, x, h, w``
    (guaranteed: level offsets and sizes are shrink-snapped).  Semantically
    identical to :func:`reflect_halos` on the interleaved canvas; reflection
    of row ``y - k`` to ``y + k - 1`` always crosses phase parity
    (``(y-k) + (y+k-1)`` is odd), so each band copy is a cross-phase
    slice + flip — no strided access.
    """
    def rows_of_phase(r0: int, r1: int, a: int) -> Tuple[int, int]:
        """Plane-row range [i0, i1) of phase ``a`` rows within full-res rows
        [r0, r1)."""
        i0 = -(-(r0 - a) // 2)
        i1 = -(-(r1 - a) // 2)
        return i0, i1

    for (y, x, h, w, halo) in regions:
        if halo <= 0:
            continue
        b = min(halo, h, w)
        xs = slice(x // 2, (x + w) // 2)  # level cols, both col phases
        # vertical: full-res dest rows [y-b, y) reflect rows [y, y+b) about y
        # (dest r -> src 2y-1-r, opposite parity); bottom about y+h
        for a in (0, 1):
            i0, i1 = rows_of_phase(y - b, y, a)
            if i1 > i0:
                # src plane rows (phase 1-a): j = y - 1 - i, descending
                src = planes[..., 1 - a, :, y - i1:y - i0, xs]
                planes = planes.at[..., a, :, i0:i1, xs].set(
                    jnp.flip(src, axis=-2))
            i0, i1 = rows_of_phase(y + h, y + h + b, a)
            if i1 > i0:
                src = planes[..., 1 - a, :, y + h - i1:y + h - i0, xs]
                planes = planes.at[..., a, :, i0:i1, xs].set(
                    jnp.flip(src, axis=-2))
        # horizontal over the vertically-extended band (corners included)
        for a in (0, 1):
            r0, r1 = rows_of_phase(y - b, y + h + b, a)
            if r1 <= r0:
                continue
            rs = slice(r0, r1)
            for bb in (0, 1):
                j0, j1 = rows_of_phase(x - b, x, bb)
                if j1 > j0:
                    src = planes[..., a, 1 - bb, rs, x - j1:x - j0]
                    planes = planes.at[..., a, bb, rs, j0:j1].set(
                        jnp.flip(src, axis=-1))
                j0, j1 = rows_of_phase(x + w, x + w + b, bb)
                if j1 > j0:
                    src = planes[..., a, 1 - bb, rs, x + w - j1:x + w - j0]
                    planes = planes.at[..., a, bb, rs, j0:j1].set(
                        jnp.flip(src, axis=-1))
    return planes


def reflect_halos(canvas: jax.Array,
                  regions: Sequence[Tuple[int, int, int, int, int]]) -> jax.Array:
    """Fill each region's halo band with the symmetric reflection of its
    content using static slices + flips (two separable passes, corners
    included).  Semantically identical to applying
    :func:`reflection_permutation` without a full-canvas gather.  Regions
    must be disjoint
    including their halos (guaranteed by the halo-aware packer) and satisfy
    ``halo <= h, w``.  Operates on the last two dims.
    """
    for (y, x, h, w, halo) in regions:
        if halo <= 0:
            continue
        b = min(halo, h, w)
        # vertical pass: extend rows into the top/bottom bands
        top = jnp.flip(canvas[..., y:y + b, x:x + w], axis=-2)
        canvas = canvas.at[..., y - b:y, x:x + w].set(top)
        bot = jnp.flip(canvas[..., y + h - b:y + h, x:x + w], axis=-2)
        canvas = canvas.at[..., y + h:y + h + b, x:x + w].set(bot)
        # horizontal pass over the extended rows (fills corners too)
        left = jnp.flip(canvas[..., y - b:y + h + b, x:x + b], axis=-1)
        canvas = canvas.at[..., y - b:y + h + b, x - b:x].set(left)
        right = jnp.flip(canvas[..., y - b:y + h + b, x + w - b:x + w], axis=-1)
        canvas = canvas.at[..., y - b:y + h + b, x + w:x + w + b].set(right)
    return canvas
