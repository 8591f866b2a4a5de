"""Batched / multi-chip detection.

Builds a jitted program that runs the packed-pyramid cascade over a *batch*
of same-sized images, optionally sharded across a device mesh (data
parallelism over images — the device replacement for the reference CLI's
``multiprocessing.Pool(6)`` fan-out,
/root/reference/scripts/waldboost-detect.py:65-67).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..channels import _normalize_opts
from ..model import (Model, _channel_canvas_batch, _packed_plan_cached)
from ..ops.cascade import cascade_response_grid
from .mesh import data_sharding

__all__ = ["make_batched_detector", "make_batched_detector_boxes",
           "detect_batch"]


def _serving_fast() -> bool:
    """Opt-in fast serving mode (``WB_SERVING_MODE=fast``): plain f32
    channel chains for float content (no double-float exactness tax) and a
    bf16 canvas into the cascade kernel.  NOT bit-exact vs the reference —
    the default ("exact") keeps the zero-mismatch contract.  Read OUTSIDE
    jit (a trace-time env read bakes the first value in) and passed on as
    static configuration."""
    import os
    return os.environ.get("WB_SERVING_MODE", "exact") == "fast"


def make_batched_detector(model: Model, image_shape: Tuple[int, int],
                          mesh=None, n_stages_cap: Optional[int] = None,
                          _parts: bool = False, _raw: bool = False,
                          _shared=None):
    """Compile a batched detector for ``model`` on images of ``image_shape``.

    Returns ``fn(images) -> (hs, alive, n_weak)`` where ``images`` is
    (B, H, W); outputs have leading batch dim.  With ``mesh`` given, inputs
    and outputs are sharded over the mesh's data axis (B must be divisible by
    the mesh size).

    ``n_stages_cap`` evaluates only the first stages (the two-phase prefix).
    With ``_parts=True`` returns ``(canvas_jit, cascade_jit, packed)``
    instead.  ``_raw=True`` returns the unjitted building blocks
    ``(canvas_b, cascade_b, cascade_masked_b, packed)`` for single-program
    composition; ``cascade_masked_b`` is None on the XLA backend.

    ``_shared=packed`` builds against a pre-planned SHARED canvas
    (heterogeneous multi-model serving, or a truncated scale plan).
    """
    from ..model import _resolve_cascade_backend

    m, n, _ = model.shape
    shrink, n_per_oct, smooth, cf = _normalize_opts(model.channel_opts)
    if _shared is not None:
        packed = _shared
    else:
        packed = _packed_plan_cached(image_shape[0], image_shape[1], shrink,
                                     n_per_oct, (m, n), halo=cf.halo)
    valid = jnp.asarray(packed.valid_mask((m, n)))
    casc, meta = model._get_cascade()
    if n_stages_cap is not None:
        from ..ops.cascade import slice_cascade
        casc = slice_cascade(casc, 0, min(n_stages_cap, casc.n_stages))
    # serving knobs resolve at BUILD time, not inside the traced closures
    fast = _serving_fast()

    def canvas_b(images):
        cvs = _channel_canvas_batch(images, shrink, n_per_oct, smooth, cf,
                                    packed, fast=fast)
        return cvs.astype(jnp.bfloat16) if fast else cvs

    if _resolve_cascade_backend() == "triton":
        from ..ops.cascade_kernel import cascade_dense, cascade_masked

        def cascade_b(cvs):
            return cascade_dense(cvs, casc, meta, valid, (m, n))

        def cascade_masked_b(cvs, with_n_weak=True):
            return cascade_masked(cvs, casc, meta, valid, (m, n),
                                  with_n_weak=with_n_weak)
    else:
        def cascade_one(canvas):
            return cascade_response_grid(canvas, casc, (m, n), meta,
                                         init_alive=valid)

        cascade_b = jax.vmap(cascade_one)
        cascade_masked_b = None

    if _raw:
        return canvas_b, cascade_b, cascade_masked_b, packed

    if mesh is None:
        canvas_jit = jax.jit(canvas_b)
        cascade_jit = jax.jit(cascade_b)
    else:
        # shard_map runs the per-shard programs on every device's local
        # batch slice (data parallelism over images; no collectives —
        # detection is independent per image)
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from .mesh import DATA_AXIS

        in_sh = data_sharding(mesh, 3)
        cv_sh = data_sharding(mesh, 4)
        out_sh = (data_sharding(mesh, 3), data_sharding(mesh, 3),
                  data_sharding(mesh, 1))
        canvas_sharded = shard_map(
            canvas_b, mesh=mesh,
            in_specs=(P(DATA_AXIS, None, None),),
            out_specs=P(DATA_AXIS, None, None, None),
            check_vma=False)
        canvas_jit = jax.jit(canvas_sharded, in_shardings=(in_sh,),
                             out_shardings=cv_sh)
        cascade_sharded = shard_map(
            cascade_b, mesh=mesh,
            in_specs=(P(DATA_AXIS, None, None, None),),
            out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None, None),
                       P(DATA_AXIS)),
            check_vma=False)
        cascade_jit = jax.jit(cascade_sharded, in_shardings=(cv_sh,),
                              out_shardings=out_sh)

    if _parts:
        return canvas_jit, cascade_jit, packed

    def fn(images):
        return cascade_jit(canvas_jit(images))

    return fn, packed


#: two-phase batched serving defaults: dense prefix length and the survivor
#: capacity of the compaction (sized from the flagship survivor histogram:
#: ~3.4k of 407k valid VGA windows survive 12 calibrated stages)
TWO_PHASE_BATCH_PREFIX = 12
TWO_PHASE_BATCH_CAPACITY = 8192


def make_batched_detector_boxes(model: Model, image_shape: Tuple[int, int],
                                mesh=None, k: int = 1024, k_row: int = 16,
                                nms_iou: Optional[float] = None,
                                extractor: str = "approx",
                                two_phase="auto",
                                prefix: int = TWO_PHASE_BATCH_PREFIX,
                                capacity: int = TWO_PHASE_BATCH_CAPACITY,
                                with_n_weak: bool = True,
                                n_scales: Optional[int] = None):
    """Batched detection with fully on-device extraction.

    Returns ``fn(images) -> (rects, scores, valid, count, n_weak)`` — per
    image a fixed-capacity (k, 4) box set in image space (optionally NMS'd on
    device), with ``count`` the exact survivor count (-1 flags an incomplete
    extraction: capacity overflow, or a recall miss of the default "approx"
    extractor — see ops.nms).  No dense response map ever leaves the device.

    ``two_phase`` ("auto"/True/False): evaluate only ``prefix`` stages
    densely, compact the prefix survivors to a fixed ``capacity`` via
    approx_max_k, and run the remaining stages sparsely on the compacted set
    (ops.cascade.cascade_suffix_sparse) — the batched, host-sync-free version
    of Model.detect's two-phase fast path.  Exact whenever the prefix
    survivors fit ``capacity`` and the compaction captured all of them
    (checked on device; ``count`` is -1 otherwise and callers fall back
    dense, as detect_batch does).  Rejection is monotone, so survivors and
    scores are identical to the dense pass.
    """
    from ..ops.nms import (extract_detections_approx,
                           extract_detections_rowwise, nms_device)

    m, n, _ = model.shape
    # two-phase is opt-in (two_phase=True): the dense masked kernel is the
    # default; the sparse suffix's cost on this device is not measured yet
    use_tp = two_phase is True
    if use_tp:
        return _make_two_phase_detector_boxes(
            model, image_shape, mesh=mesh, k=k, nms_iou=nms_iou,
            prefix=prefix, capacity=capacity)

    if extractor == "approx":
        built = _make_masked_detector_boxes(model, image_shape, mesh=mesh,
                                            k=k, nms_iou=nms_iou,
                                            with_n_weak=with_n_weak,
                                            n_scales=n_scales)
        if built is not None:
            return built

    if n_scales is not None:
        raise ValueError("n_scales requires the kernel serving path "
                         "(extractor='approx', cascade backend 'triton')")
    base_fn, packed = make_batched_detector(model, image_shape, mesh=mesh)
    level_id_map, inv_scales = packed.level_maps((m, n))
    offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32) \
        if packed.levels else np.zeros((0, 2), np.int32)
    lid = jnp.asarray(level_id_map)
    offs = jnp.asarray(offsets)
    iscales = jnp.asarray(inv_scales)
    wnd = jnp.asarray([m, n], jnp.int32)

    def extract_one(hs, alive):
        if extractor == "approx":
            rects, scores, valid, count = extract_detections_approx(
                hs, alive, lid, offs, iscales, wnd, k=k)
        else:
            rects, scores, valid, count = extract_detections_rowwise(
                hs, alive, lid, offs, iscales, wnd, k_row=k_row, k=k)
        if nms_iou is not None:
            keep = nms_device(rects, scores, valid,
                              iou_threshold=float(nms_iou))
            valid = jnp.logical_and(valid, keep)
        return rects, scores, valid, count

    extract_b = jax.jit(jax.vmap(extract_one))

    def fn(images):
        hs, alive, n_weak = base_fn(images)
        rects, scores, valid, count = extract_b(hs, alive)
        return rects, scores, valid, count, n_weak

    return fn, packed


def _make_masked_detector_boxes(model: Model, image_shape: Tuple[int, int],
                                mesh=None, k: int = 256,
                                nms_iou: Optional[float] = None,
                                with_n_weak: bool = True,
                                n_scales: Optional[int] = None):
    """ONE-program batched detection on the cascade kernel.

    Composes canvas -> masked cascade kernel -> approx_max_k extraction ->
    NMS into a single jit (shard_map'd under a mesh).  The cascade kernel
    emits the tile-padded masked map + exact survivor counts, so the
    extraction needs no alive map and no jnp.where pass.  Returns None when
    the kernel path is not selected (callers fall back to the split-program
    XLA path).
    """
    from ..ops.nms import extract_detections_masked, nms_device

    m, n, _ = model.shape
    shared = None
    if n_scales is not None:
        # serve only the first n_scales pyramid levels (the reference's
        # config-1 "single scale" workload at n_scales=1; the reference
        # itself controls scale count via channel_opts['n_per_oct'],
        # /root/reference/waldboost/channels.py:111-131): a truncated
        # packed plan rides the same canvas chain + cascade kernel
        from ..channels import pyramid_plan
        from ..model import _normalize_opts
        from ..packing import PackedPyramidPlan
        shrink_, n_per_oct_, _sm, cf_ = _normalize_opts(model.channel_opts)
        plan = pyramid_plan(image_shape[0], image_shape[1], shrink_,
                            n_per_oct_)[:n_scales]
        packed_t = PackedPyramidPlan.build(plan, (m, n), halo=cf_.halo,
                                           shrink=shrink_)
        shared = packed_t
    parts = make_batched_detector(model, image_shape, _raw=True,
                                  _shared=shared)
    canvas_b, _, cascade_masked_b, packed = parts
    if cascade_masked_b is None:
        return None

    from ..ops.cascade_kernel import cascade_grid
    Hc, Wc = packed.canvas_h, packed.canvas_w
    TU, TV, gi, gj = cascade_grid((Hc, Wc), (m, n))
    GUp, GVp = gi * TU, gj * TV
    level_id_map, inv_scales = packed.level_maps((m, n))
    gu, gv = level_id_map.shape
    lid_pad = np.full((GUp, GVp), -1, np.int32)
    lid_pad[:gu, :gv] = level_id_map
    offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32) \
        if packed.levels else np.zeros((1, 2), np.int32)
    lid = jnp.asarray(lid_pad)
    offs = jnp.asarray(offsets)
    iscales = jnp.asarray(inv_scales) if packed.levels else \
        jnp.ones(1, jnp.float32)
    wnd = jnp.asarray([m, n], jnp.int32)

    def extract_one(masked, count):
        rects, scores, valid, count = extract_detections_masked(
            masked, count, lid, offs, iscales, wnd, k=k)
        if nms_iou is not None:
            keep = nms_device(rects, scores, valid,
                              iou_threshold=float(nms_iou))
            valid = jnp.logical_and(valid, keep)
        return rects, scores, valid, count

    def body(images):
        masked, n_weak, count = cascade_masked_b(canvas_b(images),
                                                 with_n_weak=with_n_weak)
        rects, scores, valid, count = jax.vmap(extract_one)(masked, count)
        return rects, scores, valid, count, n_weak

    if mesh is None:
        return jax.jit(body), packed

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .mesh import DATA_AXIS

    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                   P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False)
    return jax.jit(sharded, in_shardings=(data_sharding(mesh, 3),)), packed


def make_multi_detector_boxes(models, image_shape: Tuple[int, int],
                              mesh=None, k: int = 256,
                              nms_iou: Optional[float] = None,
                              response_scale=None,
                              with_n_weak: bool = True):
    """K-model batched detection over ONE shared channel canvas.

    The canvas program appears exactly once in the compiled program; each
    model's cascade kernel scans the same canvas, and every
    model's survivors are extracted to its own k-slot box set (scores
    pre-scaled by ``response_scale`` on device, per-model NMS on device
    when ``nms_iou`` is set).  Returns ``fn(images) -> (rects, scores,
    valid, label, count, n_weak)`` with shapes ``(B, K*k, 4)`` /
    ``(B, K*k)`` / ``(B, K*k)`` / ``(B, K*k)`` int32 model index /
    ``(B, K)`` per-model exact survivor counts / ``(B,)``.

    Device analog of /root/reference/waldboost/__init__.py:75-130 (one
    pyramid, K models); models must share channel options.  Window shapes
    may DIFFER: the shared canvas is planned from the elementwise-min
    window and each model's cascade kernel scans it with its own window
    grid, validity mask, and level maps.
    """
    from ..channels import _normalize_opts
    from ..ops.cascade_kernel import cascade_grid
    from ..ops.nms import extract_detections_masked, nms_device

    model0 = models[0]
    key0 = _normalize_opts(model0.channel_opts)
    if not all(_normalize_opts(mm.channel_opts) == key0 for mm in models):
        raise ValueError("make_multi_detector_boxes needs models sharing "
                         "channel options")
    if response_scale is None:
        response_scale = [1.0] * len(models)
    if len(response_scale) != len(models):
        raise ValueError("Wrong response_scale parameter")

    shrink, n_per_oct, smooth, cf = key0
    m_min = min(mm.shape[0] for mm in models)
    n_min = min(mm.shape[1] for mm in models)
    packed = _packed_plan_cached(image_shape[0], image_shape[1], shrink,
                                 n_per_oct, (m_min, n_min), halo=cf.halo)
    Hc, Wc = packed.canvas_h, packed.canvas_w
    parts = [make_batched_detector(mm, image_shape, _raw=True,
                                   _shared=packed)
             for mm in models]
    canvas_b = parts[0][0]
    cascades = [p[2] for p in parts]
    if any(c is None for c in cascades):
        raise RuntimeError("multi-model serving needs the cascade kernel "
                           "path (set_cascade_backend('triton'))")

    offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32) \
        if packed.levels else np.zeros((1, 2), np.int32)
    offs = jnp.asarray(offsets)
    iscales = jnp.asarray(packed.level_maps((m_min, n_min))[1]) \
        if packed.levels else jnp.ones(1, jnp.float32)

    lids, wnds = [], []
    for mm in models:
        m, n, _ = mm.shape
        TU, TV, gi, gj = cascade_grid((Hc, Wc), (m, n))
        level_id_map, _ = packed.level_maps((m, n))
        gu, gv = level_id_map.shape
        lid_pad = np.full((gi * TU, gj * TV), -1, np.int32)
        lid_pad[:gu, :gv] = level_id_map
        lids.append(jnp.asarray(lid_pad))
        wnds.append(jnp.asarray([m, n], jnp.int32))

    def extract_one(masked, count, scale, lid, wnd):
        rects, scores, valid, count = extract_detections_masked(
            masked, count, lid, offs, iscales, wnd, k=k)
        scores = scores * scale
        if nms_iou is not None:
            keep = nms_device(rects, scores, valid,
                              iou_threshold=float(nms_iou))
            valid = jnp.logical_and(valid, keep)
        return rects, scores, valid, count

    def body(images):
        cvs = canvas_b(images)  # the ONE canvas computation
        outs = []
        nw_total = None
        for kix, cascade_kx in enumerate(cascades):
            masked, n_weak, count = cascade_kx(cvs, with_n_weak=with_n_weak)
            scale = jnp.float32(float(response_scale[kix]))
            lid, wnd = lids[kix], wnds[kix]
            rects, scores, valid, cnt = jax.vmap(
                lambda mk, ct: extract_one(mk, ct, scale, lid, wnd))(
                    masked, count)
            label = jnp.full(scores.shape, kix, jnp.int32)
            outs.append((rects, scores, valid, label, cnt))
            nw_total = n_weak if nw_total is None else nw_total + n_weak
        rects = jnp.concatenate([o[0] for o in outs], axis=1)
        scores = jnp.concatenate([o[1] for o in outs], axis=1)
        valid = jnp.concatenate([o[2] for o in outs], axis=1)
        label = jnp.concatenate([o[3] for o in outs], axis=1)
        count = jnp.stack([o[4] for o in outs], axis=1)
        return rects, scores, valid, label, count, nw_total

    if mesh is None:
        return jax.jit(body), packed

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .mesh import DATA_AXIS

    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                   P(DATA_AXIS, None), P(DATA_AXIS, None),
                   P(DATA_AXIS, None), P(DATA_AXIS)),
        check_vma=False)
    return jax.jit(sharded, in_shardings=(data_sharding(mesh, 3),)), packed


def _make_two_phase_detector_boxes(model: Model, image_shape, mesh=None,
                                   k: int = 1024,
                                   nms_iou: Optional[float] = None,
                                   prefix: int = TWO_PHASE_BATCH_PREFIX,
                                   capacity: int = TWO_PHASE_BATCH_CAPACITY):
    """Two-phase batched detection (see make_batched_detector_boxes)."""
    from ..ops.cascade import cascade_suffix_sparse
    from ..ops.nms import nms_device

    m, n, _ = model.shape
    canvas_jit, prefix_jit, packed = make_batched_detector(
        model, image_shape, mesh=mesh, n_stages_cap=prefix, _parts=True)
    casc, meta = model._get_cascade()
    level_id_map, inv_scales = packed.level_maps((m, n))
    gu, gv = level_id_map.shape
    lid_flat = jnp.asarray(level_id_map.reshape(-1))
    offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32) \
        if packed.levels else np.zeros((1, 2), np.int32)
    offs = jnp.asarray(offsets)
    iscales = jnp.asarray(inv_scales) if packed.levels else \
        jnp.ones(1, jnp.float32)
    cap = min(capacity, max(gu * gv, 1))
    k_out = min(k, cap)

    def tp_one(cvs, hs1, alive1, nw1):
        masked = jnp.where(alive1, hs1, -jnp.inf).reshape(-1)
        count1 = jnp.sum(alive1, dtype=jnp.int32)
        # recall_target=1.0: the tiled partial reduction is then EXACT top-k
        # (still ~4x faster than the sort-based lax.top_k at canvas size), so
        # whenever count1 <= cap every prefix survivor is captured and the
        # two-phase result equals the dense pass
        scoresK, idx = jax.lax.approx_max_k(masked, cap, recall_target=1.0)
        aliveK = jnp.isfinite(scoresK)
        complete = jnp.logical_and(count1 <= cap,
                                   jnp.sum(aliveK, dtype=jnp.int32) == count1)
        H, aliveS, nw2 = cascade_suffix_sparse(
            cvs, casc, (m, n), meta, idx, scoresK, aliveK, prefix)
        n_surv = jnp.sum(aliveS, dtype=jnp.int32)
        scores, sel = jax.lax.top_k(jnp.where(aliveS, H, -jnp.inf), k_out)
        valid = jnp.isfinite(scores)
        idx_out = idx[sel]
        rs = idx_out // gv
        cs = idx_out % gv
        lid = jnp.maximum(lid_flat[idx_out], 0)
        x1 = (cs - offs[lid, 1]).astype(jnp.float32)
        y1 = (rs - offs[lid, 0]).astype(jnp.float32)
        rects = jnp.stack([x1, y1, x1 + float(n), y1 + float(m)], axis=1)
        rects = rects * iscales[lid][:, None]
        rects = jnp.where(valid[:, None], rects, 0.0)
        count = jnp.where(jnp.logical_and(complete, n_surv <= k_out),
                          n_surv, -1)
        if nms_iou is not None:
            keep = nms_device(rects, scores, valid,
                              iou_threshold=float(nms_iou))
            valid = jnp.logical_and(valid, keep)
        return rects, scores, valid, count, nw1 + nw2

    tp_b = jax.jit(jax.vmap(tp_one))

    def fn(images):
        cvs = canvas_jit(images)
        hs1, alive1, nw1 = prefix_jit(cvs)
        return tp_b(cvs, hs1, alive1, nw1)

    return fn, packed


def make_tile_sharded_detector(model: Model, image_shape: Tuple[int, int],
                               mesh=None, boxes: bool = False,
                               k: int = 1024,
                               nms_iou: Optional[float] = None):
    """Shard ONE image's window grid across the mesh (single-image latency).

    The packed canvas is built once (replicated); each chip evaluates the
    cascade over its horizontal band of window-origin rows — every chip
    slices its band (+ window halo) from the replicated canvas inside
    shard_map, so no halo exchange is needed.  This is the "long axis"
    (scale x window grid) sharding analog of SURVEY.md §5: detection over a
    single large frame scales with chips, not just over image batches.

    Returns ``fn(image) -> (hs, alive, n_weak)`` on the full (GU, GV) grid,
    identical to the unsharded evaluator's output — or, with ``boxes=True``,
    ``fn(image) -> (rects, scores, valid, count, n_weak)`` with fully
    on-device box extraction (+ optional on-device NMS), the same extraction
    contract as make_batched_detector_boxes.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..model import _resolve_cascade_backend
    from .mesh import DATA_AXIS

    m, n, _ = model.shape
    shrink, n_per_oct, smooth, cf = _normalize_opts(model.channel_opts)
    packed = _packed_plan_cached(image_shape[0], image_shape[1], shrink,
                                 n_per_oct, (m, n), halo=cf.halo)
    valid_np = packed.valid_mask((m, n))
    gu, gv = valid_np.shape
    n_dev = int(np.prod(list(mesh.shape.values())))
    rows_per = -(-gu // n_dev)
    gu_pad = rows_per * n_dev
    # pad the valid mask (dead rows) so bands divide evenly; the canvas gets
    # the same padding plus the window halo every band needs below itself
    valid_pad = np.zeros((gu_pad, gv), bool)
    valid_pad[:gu] = valid_np
    valid_dev = jnp.asarray(valid_pad)

    casc, meta = model._get_cascade()
    if _resolve_cascade_backend() == "triton":
        from ..ops.cascade_kernel import cascade_dense

        def band_eval(canvas_band, valid_band):
            return tuple(x[0] for x in cascade_dense(
                canvas_band[None], casc, meta, valid_band, (m, n)))
    else:
        def band_eval(canvas_band, valid_band):
            return cascade_response_grid(canvas_band, casc, (m, n), meta,
                                         init_alive=valid_band)

    def shard_body(canvas, valid):
        # canvas/valid arrive replicated; each chip takes its band + halo
        idx = jax.lax.axis_index(DATA_AXIS)
        start = idx * rows_per
        band = jax.lax.dynamic_slice(
            canvas, (0, start, 0),
            (canvas.shape[0], rows_per + m, canvas.shape[2]))
        vband = jax.lax.dynamic_slice(valid, (start, 0), (rows_per, gv))
        hs, alive, nw = band_eval(band, vband)
        return hs, alive, nw[None]

    sharded = shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS)),
        check_vma=False)

    def canvas_one(image):
        return _channel_canvas_batch(image[None], shrink, n_per_oct, smooth,
                                     cf, packed)[0]

    canvas_jit = jax.jit(canvas_one)

    @jax.jit
    def cascade_jit(canvas):
        # rows: every band slices rows [start, start+rows_per+m) — pad so
        # the last band's halo read is in bounds
        need = gu_pad + m
        pad_r = max(need - canvas.shape[1], 0)
        canvas_p = jnp.pad(canvas, ((0, 0), (0, pad_r), (0, 0)))
        hs, alive, nw = sharded(canvas_p, valid_dev)
        return hs[:gu], alive[:gu], nw.sum()

    if not boxes:
        def fn(image):
            return cascade_jit(canvas_jit(jnp.asarray(image)))

        return fn, packed

    # on-device extraction over the sharded response grid (the same box
    # contract as make_batched_detector_boxes)
    from ..ops.nms import extract_detections_approx, nms_device

    level_id_map, inv_scales = packed.level_maps((m, n))
    lid = jnp.asarray(level_id_map)
    offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32) \
        if packed.levels else np.zeros((1, 2), np.int32)
    offs = jnp.asarray(offsets)
    iscales = jnp.asarray(inv_scales) if packed.levels else \
        jnp.ones(1, jnp.float32)
    wnd = jnp.asarray([m, n], jnp.int32)

    @jax.jit
    def extract_jit(hs, alive):
        rects, scores, valid, count = extract_detections_approx(
            hs, alive, lid, offs, iscales, wnd, k=k)
        if nms_iou is not None:
            keep = nms_device(rects, scores, valid,
                              iou_threshold=float(nms_iou))
            valid = jnp.logical_and(valid, keep)
        return rects, scores, valid, count

    def fn(image):
        hs, alive, nw = cascade_jit(canvas_jit(jnp.asarray(image)))
        rects, scores, valid, count = extract_jit(hs, alive)
        return rects, scores, valid, count, nw

    return fn, packed


# True-size bucketed serving lives in .bucket (runtime-geometry programs);
# re-exported here for the historical import path.
from .bucket import BucketedDetector  # noqa: E402


def detect_batch(model: Model, images: np.ndarray, mesh=None,
                 k: int = 4096, k_row: int = 64):
    """Convenience wrapper: batched detection with on-device box extraction.
    Returns a list of Boxes (pre-NMS), the same survivor set per image as
    ``Model.detect``.  Falls back to a dense transfer for any image whose
    survivor count overflows the fixed extraction capacity."""
    from .. import boxes as bbx
    from ..boxes import Boxes

    images = np.asarray(images)
    fn, packed = make_batched_detector_boxes(model, images.shape[1:],
                                             mesh=mesh, k=k, k_row=k_row)
    rects_b, scores_b, valid_b, count_b, _ = fn(jnp.asarray(images))
    rects_b = np.asarray(rects_b)
    scores_b = np.asarray(scores_b)
    valid_b = np.asarray(valid_b)
    count_b = np.asarray(count_b)
    m, n, _ = model.shape
    out = []
    dense_idx = [b for b in range(images.shape[0]) if count_b[b] < 0]
    dense = {}
    if dense_idx:
        # rare overflow: dense per-image fallback (exactness guarantee)
        for b in dense_idx:
            dense[b] = model.detect(images[b])
    for b in range(images.shape[0]):
        if b in dense:
            out.append(dense[b])
            continue
        sel = valid_b[b]
        bx = Boxes(rects_b[b][sel])
        bx.set_field("scores", scores_b[b][sel].astype(np.float32))
        out.append(bx)
    return out
