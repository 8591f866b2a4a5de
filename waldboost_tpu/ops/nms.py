"""On-device non-maximum suppression and top-k detection extraction.

The reference leaves NMS to the external bbx package on the host
(the reference's waldboost/testing.py:46); here NMS and the
pyramid-coordinate mapping run on device to avoid host round-trips.

Greedy score-descending NMS is inherently sequential, but for a fixed-K
candidate set it vectorizes as a K-step ``fori_loop`` over an IoU matrix —
O(K^2) elementwise work that the VPU eats for realistic K (<= a few
thousand).  Exactly equivalent to the host implementation in
waldboost_tpu.boxes.non_max_suppression.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["iou_matrix_device", "nms_device", "topk_detections",
           "extract_detections_rowwise", "extract_detections_approx",
           "extract_detections_masked"]


def iou_matrix_device(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pairwise IoU of (N,4) / (M,4) XYXY rects."""
    x1 = jnp.maximum(a[:, None, 0], b[None, :, 0])
    y1 = jnp.maximum(a[:, None, 1], b[None, :, 1])
    x2 = jnp.minimum(a[:, None, 2], b[None, :, 2])
    y2 = jnp.minimum(a[:, None, 3], b[None, :, 3])
    inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
    area_a = jnp.maximum(a[:, 2] - a[:, 0], 0) * jnp.maximum(a[:, 3] - a[:, 1], 0)
    area_b = jnp.maximum(b[:, 2] - b[:, 0], 0) * jnp.maximum(b[:, 3] - b[:, 1], 0)
    union = area_a[:, None] + area_b[None, :] - inter
    return jnp.where(union > 0, inter / union, 0.0)


@functools.partial(jax.jit, static_argnames=("iou_threshold",))
def nms_device(rects: jax.Array, scores: jax.Array, valid: jax.Array,
               iou_threshold: float = 0.5) -> jax.Array:
    """Greedy NMS over a fixed-capacity candidate set.

    rects (K, 4), scores (K,), valid (K,) bool (padding mask).
    Returns keep (K,) bool.  Equivalent to
    waldboost_tpu.boxes.non_max_suppression on the valid subset.

    Selection loop, not a K-step scan: each iteration argmax-picks the best
    remaining box and suppresses its overlaps, so the trip count is
    ``#kept + 1`` (typically ~10 per image) instead of K: sequential
    loop steps with tiny bodies cost latency, not work.
    argmax breaks score ties by lowest index, exactly the host's stable
    descending sort order (boxes.non_max_suppression).
    """
    K = rects.shape[0]
    idx = jnp.arange(K)
    area = jnp.maximum(rects[:, 2] - rects[:, 0], 0) * \
        jnp.maximum(rects[:, 3] - rects[:, 1], 0)

    def cond(state):
        _keep, remaining = state
        return jnp.any(remaining)

    def body(state):
        keep, remaining = state
        s = jnp.where(remaining, scores, -jnp.inf)
        i = jnp.argmax(s)
        # under vmap the loop runs until every lane finishes; a finished
        # lane has remaining all-False -> active False -> no-op iteration
        active = remaining[i]
        box = rects[i]
        x1 = jnp.maximum(box[0], rects[:, 0])
        y1 = jnp.maximum(box[1], rects[:, 1])
        x2 = jnp.minimum(box[2], rects[:, 2])
        y2 = jnp.minimum(box[3], rects[:, 3])
        inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
        union = area[i] + area - inter
        iou = jnp.where(union > 0, inter / union, 0.0)
        sup = jnp.logical_or(iou > iou_threshold, idx == i)
        remaining = jnp.logical_and(remaining,
                                    jnp.logical_not(jnp.logical_and(active,
                                                                    sup)))
        keep = jnp.logical_or(keep, jnp.logical_and(active, idx == i))
        return keep, remaining

    keep0 = jnp.zeros(K, bool)
    keep, _ = jax.lax.while_loop(cond, body, (keep0, valid))
    return keep


@functools.partial(jax.jit, static_argnames=("k",))
def extract_detections_approx(hs: jax.Array, alive: jax.Array,
                              level_id: jax.Array, offsets: jax.Array,
                              inv_scales: jax.Array, window: jax.Array,
                              k: int = 256
                              ) -> Tuple[jax.Array, jax.Array, jax.Array,
                                         jax.Array]:
    """Fixed-capacity survivor extraction via ``lax.approx_max_k`` (a
    partial-reduction top-k where the backend has one; exact ``top_k``
    elsewhere).

    approx_max_k may miss survivors (recall < 1), so exactness is *checked*:
    ``count`` is the true survivor total and is set to -1 when the extracted
    set is incomplete (capacity overflow OR a recall miss) — callers fall
    back to the dense path exactly as with the overflow check of
    :func:`extract_detections_rowwise`.

    Returns (rects (k, 4) image-space XYXY, scores (k,), valid (k,), count).
    """
    gu, gv = hs.shape
    masked = jnp.where(alive, hs, -jnp.inf).reshape(-1)
    true_count = jnp.sum(alive, dtype=jnp.int32)
    k_eff = min(k, masked.shape[0])
    scores, idx = jax.lax.approx_max_k(masked, k_eff)
    valid = jnp.isfinite(scores)
    got = jnp.sum(valid, dtype=jnp.int32)
    complete = jnp.logical_and(true_count <= k_eff, got == true_count)
    count = jnp.where(complete, true_count, -1)
    rs = idx // gv
    cs = idx % gv
    lid = jnp.maximum(level_id[rs, cs], 0)
    local_r = rs - offsets[lid, 0]
    local_c = cs - offsets[lid, 1]
    x1 = local_c.astype(jnp.float32)
    y1 = local_r.astype(jnp.float32)
    m = window[0].astype(jnp.float32)
    n = window[1].astype(jnp.float32)
    rects = jnp.stack([x1, y1, x1 + n, y1 + m], axis=1)
    rects = rects * inv_scales[lid][:, None]
    rects = jnp.where(valid[:, None], rects, 0.0)
    return rects, scores, valid, count


@functools.partial(jax.jit, static_argnames=("k", "with_coords"))
def extract_detections_masked(masked: jax.Array, count: jax.Array,
                              level_id: jax.Array, offsets: jax.Array,
                              inv_scales: jax.Array, window: jax.Array,
                              k: int = 256, with_coords: bool = False
                              ) -> Tuple[jax.Array, ...]:
    """Extraction from a kernel-emitted masked map (hs where alive, -inf
    elsewhere; see ops.cascade_kernel.cascade_masked).

    ``masked`` is the UNCROPPED aligned (GUp, GVp) map, ``count`` the exact
    survivor total (computed in-kernel), ``level_id`` the (GUp, GVp) padded
    level map (-1 in dead regions).  Identical completeness contract to
    :func:`extract_detections_approx`: count == -1 flags overflow/recall
    miss and callers fall back dense.
    """
    gu, gv = masked.shape
    flat = masked.reshape(-1)
    k_eff = min(k, flat.shape[0])
    scores, idx = jax.lax.approx_max_k(flat, k_eff)
    valid = jnp.isfinite(scores)
    got = jnp.sum(valid, dtype=jnp.int32)
    complete = jnp.logical_and(count <= k_eff, got == count)
    count = jnp.where(complete, count, -1)
    rs = idx // gv
    cs = idx % gv
    lid = jnp.maximum(level_id[rs, cs], 0)
    local_r = rs - offsets[lid, 0]
    local_c = cs - offsets[lid, 1]
    x1 = local_c.astype(jnp.float32)
    y1 = local_r.astype(jnp.float32)
    m = window[0].astype(jnp.float32)
    n = window[1].astype(jnp.float32)
    rects = jnp.stack([x1, y1, x1 + n, y1 + m], axis=1)
    rects = rects * inv_scales[lid][:, None]
    rects = jnp.where(valid[:, None], rects, 0.0)
    if with_coords:
        # canvas window-grid coords of each survivor (garbage where ~valid;
        # in-bounds, so downstream gathers stay safe) — the fused verifier
        # crops windows at these origins without leaving the program
        return rects, scores, valid, count, rs.astype(jnp.int32), \
            cs.astype(jnp.int32)
    return rects, scores, valid, count


@functools.partial(jax.jit, static_argnames=("k_row", "k"))
def extract_detections_rowwise(hs: jax.Array, alive: jax.Array,
                               level_id: jax.Array, offsets: jax.Array,
                               inv_scales: jax.Array, window: jax.Array,
                               k_row: int = 16, k: int = 1024
                               ) -> Tuple[jax.Array, jax.Array, jax.Array,
                                          jax.Array]:
    """Fixed-capacity survivor extraction, hierarchical: per-row top-``k_row``
    then global top-``k`` over the (GU * k_row) candidates.

    Batched row-wise top-k plus a global top-k over the row candidates
    replaces one flat ``top_k`` over the whole window grid.  Exact (returns ALL
    survivors) when no grid row holds more than ``k_row`` survivors and the
    total count fits ``k`` — the returned ``count`` lets callers detect
    overflow and fall back (monotone with Model.detect's two-phase pattern).

    Returns (rects (k, 4) image-space XYXY, scores (k,), valid (k,), count).
    """
    gu, gv = hs.shape
    masked = jnp.where(alive, hs, -jnp.inf)
    count = jnp.sum(alive, dtype=jnp.int32)
    row_over = jnp.max(jnp.sum(alive, axis=1, dtype=jnp.int32))
    # overflow sentinel: count > k or some row > k_row -> report count = -1
    count = jnp.where((row_over <= k_row) & (count <= k), count, -1)
    cand_scores, cand_cols = jax.lax.top_k(masked, min(k_row, gv))  # (GU, kr)
    flat = cand_scores.reshape(-1)
    k_eff = min(k, flat.shape[0])
    scores, sel = jax.lax.top_k(flat, k_eff)
    rs = sel // cand_scores.shape[1]
    cs = cand_cols.reshape(-1)[sel]
    lid = jnp.maximum(level_id[rs, cs], 0)
    valid = jnp.isfinite(scores)
    local_r = rs - offsets[lid, 0]
    local_c = cs - offsets[lid, 1]
    x1 = local_c.astype(jnp.float32)
    y1 = local_r.astype(jnp.float32)
    m = window[0].astype(jnp.float32)
    n = window[1].astype(jnp.float32)
    rects = jnp.stack([x1, y1, x1 + n, y1 + m], axis=1)
    rects = rects * inv_scales[lid][:, None]
    rects = jnp.where(valid[:, None], rects, 0.0)
    return rects, scores, valid, count


@functools.partial(jax.jit, static_argnames=("k",))
def topk_detections(hs: jax.Array, alive: jax.Array, level_id: jax.Array,
                    offsets: jax.Array, inv_scales: jax.Array,
                    window: jax.Array, k: int = 1024
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fixed-capacity on-device extraction of the top-k surviving windows of
    a packed-canvas response map as image-space boxes.

    hs/alive: (GU, GV) response map + survivor mask; level_id: (GU, GV)
    static map (-1 outside levels); offsets: (L, 2) level canvas offsets;
    inv_scales: (L,) 1/scale per level; window: (2,) [m, n].

    Returns (rects (k, 4) XYXY image space, scores (k,), valid (k,) bool).
    """
    gu, gv = hs.shape
    flat_scores = jnp.where(alive, hs, -jnp.inf).reshape(-1)
    k = min(k, flat_scores.shape[0])
    scores, idx = jax.lax.top_k(flat_scores, k)
    rs = idx // gv
    cs = idx % gv
    lid = jnp.maximum(level_id.reshape(-1)[idx], 0)
    valid = jnp.isfinite(scores)
    local_r = rs - offsets[lid, 0]
    local_c = cs - offsets[lid, 1]
    x1 = local_c.astype(jnp.float32)
    y1 = local_r.astype(jnp.float32)
    m = window[0].astype(jnp.float32)
    n = window[1].astype(jnp.float32)
    rects = jnp.stack([x1, y1, x1 + n, y1 + m], axis=1)
    rects = rects * inv_scales[lid][:, None]
    return rects, scores, valid
