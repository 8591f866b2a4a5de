"""True-size detection inside shape buckets — recompile-free arbitrary-size
serving with per-size-exact semantics.

A jit program is shape-specialized, so naive serving recompiles per novel
camera resolution.  The bucket program here is compiled
ONCE per coarse (H, W) bucket from the BUCKET's packed pyramid plan (static
placements, static shapes), while everything the real image size determines
enters as RUNTIME operands:

* exact rational resize taps per level (ops.exact.resize_exact_matmul_rt;
  reflect halos ride the tap vectors as duplicated boundary rows),
* the window-origin validity mask, smooth-interior / stencil-border masks,
* the level-id map and per-level inverse scales for box extraction.

The real pyramid plan for an (h, w) <= bucket image is a per-index subset of
the bucket plan (level i's scale depends only on i, and floor-halved octave
dims of a smaller image are never larger), so each real level's content sits
top-left inside its bucket slot; the packer's gap/halo guarantees keep the
(smaller) real halos disjoint exactly as the bucket's would be.  Detections
are therefore bit-identical to the per-size ``Model.detect(image)`` — the
reference's interpreted per-size generator semantics
(/root/reference/waldboost/channels.py:93-146, model.py:149-179) — at every
size, from one compiled program per bucket.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..channels import CanvasCtx, _compute_octaves, _normalize_opts, \
    pyramid_plan
from ..model import Model, PackedPyramidPlan, _packed_plan_cached

__all__ = ["BucketedDetector", "make_bucket_detector_boxes",
           "bucket_geometry"]


# ---------------------------------------------------------------------------
# Host-side per-size geometry
# ---------------------------------------------------------------------------

def _axis_taps_rt(n_in: int, n_out: int, n_out_static: int, halo: int,
                  exact: bool):
    """Tap vectors for output rows ``[-halo, n_out_static + halo)`` of one
    resize axis: content rows carry the exact rational (or float lerp) taps
    for ``n_in -> n_out``, rows in the reflect band duplicate the boundary
    rows (same values ops.warp.reflect_halos would copy), and rows beyond the
    real extent clamp to the edge (finite garbage, masked downstream)."""
    rows = np.arange(-halo, n_out_static + halo, dtype=np.int64)
    src = rows.copy()
    top = rows < 0
    src[top] = -rows[top] - 1            # dest -k reflects content row k-1
    bot = rows >= n_out
    src[bot] = 2 * n_out - 1 - rows[bot]  # dest n+j reflects row n-1-j
    src = np.clip(src, 0, max(n_out - 1, 0))
    if exact:
        from ..ops.exact import axis_taps_exact
        i0, fn, den = axis_taps_exact(n_in, n_out)
        i1 = np.minimum(i0 + 1, max(n_in - 1, 0)).astype(np.int32)
        return (i0[src], i1[src], fn[src].astype(np.float32),
                np.float32(den))
    from ..ops.warp import resize_taps
    i0, frac = resize_taps(n_in, n_out)
    i0 = np.minimum(i0, max(n_in - 2, 0)).astype(np.int32)
    i1 = np.minimum(i0 + 1, max(n_in - 1, 0)).astype(np.int32)
    return i0[src], i1[src], frac[src].astype(np.float32)


def _degenerate_taps(n_out_static: int, halo: int, exact: bool):
    """Taps for a bucket slot whose level does not exist at the real size:
    every output row copies source row 0 (finite, fully masked)."""
    nz = np.zeros(n_out_static + 2 * halo, np.int32)
    if exact:
        return nz, nz, nz.astype(np.float32), np.float32(1.0)
    return nz, nz, nz.astype(np.float32)


@functools.lru_cache(maxsize=256)
def bucket_geometry(bucket_hw: Tuple[int, int], real_hw: Tuple[int, int],
                    window: Tuple[int, int], shrink: int, n_per_oct: int,
                    smooth: int, cf_name: str, exact: bool):
    """All per-real-size runtime operands of the bucket program, as a dict of
    host numpy arrays (hashable-args cached; callers device_put once per
    size).  Mask/map formulas mirror PackedPyramidPlan's static methods with
    the REAL level extents at the BUCKET placements."""
    from ..channels import resolve_channel_function
    cf = resolve_channel_function(cf_name)
    m, n = window
    packed = _packed_plan_cached(bucket_hw[0], bucket_hw[1], shrink,
                                 n_per_oct, (m, n), halo=cf.halo)
    h, w = real_hw
    plan = pyramid_plan(h, w, shrink, n_per_oct)
    halo = packed.halo if (cf.boundary == "reflect" and cf.halo > 0) else 0
    Hc, Wc = packed.canvas_h, packed.canvas_w
    s = packed.shrink
    gu, gv = max(Hc - m, 0), max(Wc - n, 0)
    valid = np.zeros((gu, gv), bool)
    level_id = np.full((gu, gv), -1, np.int32)
    L = max(len(packed.levels), 1)
    iscales = np.ones(L, np.float32)
    interior = np.zeros((Hc, Wc), bool)
    border = np.zeros((Hc * s, Wc * s), bool)
    regions = []
    g = {}
    for li, pl in enumerate(packed.levels):
        pi = pl.plan_index
        rlv = plan[pi] if pi < len(plan) else None
        usable = rlv is not None and rlv.out_height > m and rlv.out_width > n
        if not usable:
            g[f"r{li}"] = _degenerate_taps(pl.level.height, halo, exact)
            g[f"c{li}"] = _degenerate_taps(pl.level.width, halo, exact)
            continue
        o = pl.level.octave
        oh_r, ow_r = max(h >> o, 1), max(w >> o, 1)
        g[f"r{li}"] = _axis_taps_rt(oh_r, rlv.height, pl.level.height, halo,
                                    exact)
        g[f"c{li}"] = _axis_taps_rt(ow_r, rlv.width, pl.level.width, halo,
                                    exact)
        oh, ow = rlv.out_height, rlv.out_width
        valid[pl.y:pl.y + (oh - m), pl.x:pl.x + (ow - n)] = True
        level_id[pl.y:pl.y + (oh - m), pl.x:pl.x + (ow - n)] = li
        # f64 reciprocal, ONE f32 rounding — bitwise the same inv_scales as
        # PackedPyramidPlan.level_maps builds for the per-size path
        iscales[li] = np.float32(1.0 / rlv.scale)
        if oh > 2 and ow > 2:
            interior[pl.y + 1:pl.y + oh - 1, pl.x + 1:pl.x + ow - 1] = True
        ih, iw = rlv.height, rlv.width
        if ih > 2 and iw > 2:
            border[pl.y * s + 1:pl.y * s + ih - 1,
                   pl.x * s + 1:pl.x * s + iw - 1] = True
        regions.append((pl.y * s, pl.x * s, ih, iw, packed.halo))

    from ..ops.cascade_kernel import cascade_grid
    TU, TV, gi, gj = cascade_grid((Hc, Wc), (m, n))
    lid_pad = np.full((gi * TU, gj * TV), -1, np.int32)
    lid_pad[:gu, :gv] = level_id

    g["valid"] = valid
    g["lid"] = lid_pad
    g["iscales"] = iscales
    if smooth == 1:
        g["interior"] = interior
    if cf.boundary == "stencil_zero":
        g["border"] = border
    if cf.boundary == "reflect" and cf.halo > 1:
        # mid-pipeline ctx.reflect consumers (grad_mag's magnitude
        # re-reflection): runtime symmetric-reflection permutation, applied
        # as one gather.  grad_hist-family (halo 1, image-canvas reflect
        # only) skips the cost — its halos ride the tap vectors.
        from ..ops.warp import reflection_permutation
        g["rperm"] = reflection_permutation((Hc * s, Wc * s),
                                            tuple(regions))
    return g


# ---------------------------------------------------------------------------
# Device program (one per bucket)
# ---------------------------------------------------------------------------

def _canvas_rt_one(image, g, packed: PackedPyramidPlan, cf, shrink: int,
                   smooth: int, halo: int, n_oct: int, is_int: bool,
                   fast: bool = False):
    """Runtime-geometry channel canvas for ONE image padded to the bucket
    shape: per-level runtime-tap resize into the bucket's static placements
    (halo rows included via tap duplication), then the same canvas-wide
    channel / pool / smooth chain as model._channel_canvas_fast with the
    masks as traced operands."""
    from ..ops.exact import resize_exact_matmul_rt, resize_lerp_rt

    octaves = _compute_octaves(image, n_oct)
    Hci, Wci = packed.image_canvas_shape()
    canvas = jnp.zeros((Hci, Wci), jnp.float32)
    for li, pl in enumerate(packed.levels):
        oct_img = octaves[pl.level.octave].astype(jnp.float32)
        if is_int:
            im = resize_exact_matmul_rt(oct_img, g[f"r{li}"], g[f"c{li}"])
        else:
            im = resize_lerp_rt(oct_img, g[f"r{li}"], g[f"c{li}"])
        canvas = jax.lax.dynamic_update_slice(
            canvas, im, (pl.y * shrink - halo, pl.x * shrink - halo))

    if "rperm" in g:
        from ..ops.warp import apply_row_permutation
        reflect = lambda t: apply_row_permutation(t, g["rperm"])
    else:
        reflect = lambda t: t
    ctx = CanvasCtx(reflect=reflect, border_mask=g.get("border"),
                    exact_int=is_int, fast=fast)
    chns = cf.canvas_fn(canvas, ctx)
    if shrink == 2:
        from ..ops.image import avg_pool_2
        chns = avg_pool_2(chns)
    if smooth == 1:
        from ..ops.image import smooth_3x3
        chns = smooth_3x3(chns)
        chns = jnp.where(g["interior"][None], chns,
                         jnp.zeros((), chns.dtype))
    return chns.astype(jnp.float32)


def make_bucket_detector_boxes(model: Model, bucket_hw: Tuple[int, int],
                               k: int = 1024,
                               nms_iou: Optional[float] = None,
                               mesh=None, with_n_weak: bool = False,
                               verifier=None):
    """ONE-program true-size detection for every image size inside a bucket.

    Returns ``(fn, packed)`` with ``fn(images, geom) -> (rects, scores,
    valid, count, n_weak)``: ``images`` is a (B, Hb, Wb) batch of images
    zero-padded to the bucket shape (padding is never read — the runtime
    taps index only real content) and ``geom`` the per-real-size operand
    dict of :func:`bucket_geometry` (device arrays).  The survivor set and
    scores are exactly ``Model.detect`` at the REAL size; ``count == -1``
    flags extraction overflow (callers fall back to the per-size path).
    Returns None when the model's channel function has no canvas mode.

    ``verifier=(module, params)`` fuses CNN re-scoring INTO the program:
    each extracted survivor's (m, n, C) window is cropped from the already-
    resident channel canvas and re-scored ``cnn(X) + H`` in the same
    dispatch (/root/reference/waldboost/verification.py:85-105's flow, with
    zero extra host round-trips); ``scores`` become the verified scores,
    NMS (if any) ranks by them, and a sixth output carries the raw cascade
    scores."""
    from ..ops.cascade_kernel import cascade_masked
    from ..ops.nms import extract_detections_masked, nms_device
    from .detect import _serving_fast

    m, n, _ = model.shape
    shrink, n_per_oct, smooth, cf = _normalize_opts(model.channel_opts)
    if cf.canvas_fn is None:
        return None
    packed = _packed_plan_cached(bucket_hw[0], bucket_hw[1], shrink,
                                 n_per_oct, (m, n), halo=cf.halo)
    if not packed.levels:
        return None
    halo = packed.halo if (cf.boundary == "reflect" and cf.halo > 0) else 0
    n_oct = max(pl.level.octave for pl in packed.levels) + 1
    casc, meta = model._get_cascade()
    offs = jnp.asarray(np.array([(pl.y, pl.x) for pl in packed.levels],
                                np.int32))
    wnd = jnp.asarray([m, n], jnp.int32)
    # the serving mode resolves at BUILD time (a trace-time env read bakes
    # the first value in)
    fast = _serving_fast()

    def body(images, g):
        is_int = jnp.issubdtype(images.dtype, jnp.integer)
        cvs = jax.vmap(lambda im: _canvas_rt_one(
            im, g, packed, cf, shrink, smooth, halo, n_oct, is_int,
            fast=fast))(images)
        if fast:
            cvs = cvs.astype(jnp.bfloat16)
        masked, n_weak, count = cascade_masked(
            cvs, casc, meta, g["valid"], (m, n), with_n_weak=with_n_weak)

        def extract_one(mk, cnt):
            return extract_detections_masked(
                mk, cnt, g["lid"], offs, g["iscales"], wnd, k=k,
                with_coords=True)

        rects, scores, vld, count, rs, cs = jax.vmap(extract_one)(masked,
                                                                  count)
        casc_scores = scores
        if verifier is not None:
            vmod, vparams = verifier

            def windows_one(cv, rs_i, cs_i):
                def crop(r, c):
                    sl = jax.lax.dynamic_slice(
                        cv, (0, r, c), (cv.shape[0], m, n))
                    return jnp.transpose(sl, (1, 2, 0))
                return jax.vmap(crop)(rs_i, cs_i)

            wins = jax.vmap(windows_one)(cvs, rs, cs)  # (B, k, m, n, C)
            B, K = wins.shape[:2]
            adj = vmod.apply(vparams, wins.reshape((B * K,) + wins.shape[2:])
                             .astype(jnp.float32),
                             deterministic=True).reshape(B, K)
            scores = jnp.where(vld, scores + adj, scores)

        if nms_iou is not None:
            def nms_one(r, s, v):
                keep = nms_device(r, s, v, iou_threshold=float(nms_iou))
                return jnp.logical_and(v, keep)
            vld = jax.vmap(nms_one)(rects, scores, vld)
        return rects, scores, vld, count, n_weak, casc_scores

    if mesh is None:
        return jax.jit(body), packed

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .mesh import DATA_AXIS, data_sharding, replicated

    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P()),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                   P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
                   P(DATA_AXIS, None)),
        check_vma=False)
    jbody = jax.jit(sharded,
                    in_shardings=(data_sharding(mesh, 3), replicated(mesh)))
    return jbody, packed


# ---------------------------------------------------------------------------
# The serving front end
# ---------------------------------------------------------------------------

class BucketedDetector:
    """Recompile-free TRUE-SIZE serving for arbitrary image sizes.

    Snaps each (H, W) UP to a coarse bucket grid and reuses ONE compiled
    program per bucket, but — unlike padded-image detection — plans the
    pyramid from the REAL image size and feeds the per-size geometry (exact
    resize taps, validity/interior masks, level maps) as runtime operands.
    ``detect(image)`` is bit-identical to ``Model.detect(image)`` at every
    size; novel sizes inside a known bucket cost one small host geometry
    build + upload, never a compile.

    ``detect(image) -> Boxes``; ``detect_many(images) -> list[Boxes]``,
    grouping same-(bucket, size) images into batches.  Programs are cached
    per (bucket, dtype-kind, batch size) with batch sizes bucketed to powers
    of two.
    """

    def __init__(self, model: Model, bucket: int = 128, k: int = 1024,
                 nms_iou: Optional[float] = None, mesh=None,
                 max_batch: int = 16, track_cost: bool = False,
                 verifier=None):
        self.model = model
        self.bucket = int(bucket)
        self.k = k
        self.nms_iou = nms_iou
        self.mesh = mesh
        self.max_batch = int(max_batch)
        #: optional (module, params) CNN verifier fused into every bucket
        #: program: survivors are re-scored cnn(window) + H on device in the
        #: same dispatch, 'scores' become the verified scores (NMS ranks by
        #: them) and 'cascade_scores' carries the raw cascade response
        self.verifier = verifier
        #: opt-in eval-cost observability: fold each image's in-kernel
        #: weak-evaluation count into the model's cost counters
        #: (Model._track_cost / cost_stats) like Model.detect does.  Off by
        #: default — the counter costs one extra accumulate per stage in
        #: the serving kernel.
        self.track_cost = bool(track_cost)
        self._fns = {}
        self._geoms = {}
        self._nvalid = {}
        self.compiles = 0  # observability: bucket programs built so far

    def _snap(self, h: int, w: int) -> Tuple[int, int]:
        b = self.bucket
        m, n, _ = self.model.shape
        H = max(-(-h // b) * b, m * 2)
        W = max(-(-w // b) * b, n * 2)
        return H, W

    def _fn(self, hw: Tuple[int, int]):
        if hw not in self._fns:
            built = make_bucket_detector_boxes(
                self.model, hw, k=self.k, nms_iou=self.nms_iou,
                mesh=self.mesh, with_n_weak=self.track_cost,
                verifier=self.verifier)
            self._fns[hw] = built[0] if built is not None else None
            self.compiles += 1
        return self._fns[hw]

    def _geom(self, bucket_hw: Tuple[int, int], real_hw: Tuple[int, int],
              exact: bool):
        key = (bucket_hw, real_hw, exact)
        if key not in self._geoms:
            m, n, _ = self.model.shape
            shrink, n_per_oct, smooth, cf = _normalize_opts(
                self.model.channel_opts)
            g = bucket_geometry(bucket_hw, real_hw, (m, n), shrink,
                                n_per_oct, smooth, cf.name, exact)
            # host-side scanned-window count for eval-cost tracking
            self._nvalid[key] = int(np.asarray(g["valid"]).sum())
            self._geoms[key] = jax.device_put(dict(g))
        return self._geoms[key]

    def _fallback_detect(self, im):
        """Per-size exact path (canvas-less channel function, or extraction
        overflow): same verified-scores + NMS semantics as the bucket
        program, off the bucket fast path."""
        if self.verifier is not None:
            from ..verification import detect_and_verify
            bx = detect_and_verify(im, self.model, *self.verifier)
        else:
            bx = self.model.detect(im)
        if self.nms_iou is not None and len(bx):
            from ..boxes import non_max_suppression
            bx = non_max_suppression(bx, iou_threshold=float(self.nms_iou))
        return bx

    def _run_group(self, bucket_hw, real_hw, images):
        from ..boxes import Boxes

        fn = self._fn(bucket_hw)
        if fn is None:
            # channel function without canvas mode (recompiles per size —
            # correct, slow)
            return [self._fallback_detect(im) for im in images]
        H, W = bucket_hw
        exact = np.issubdtype(images[0].dtype, np.integer)
        g = self._geom(bucket_hw, real_hw, exact)
        out = []
        for i0 in range(0, len(images), self.max_batch):
            chunk = images[i0:i0 + self.max_batch]
            nb = len(chunk)
            nbp = 1 << (nb - 1).bit_length()
            batch = np.zeros((nbp, H, W), chunk[0].dtype)
            for j, im in enumerate(chunk):
                batch[j, :im.shape[0], :im.shape[1]] = im
            rects_b, scores_b, valid_b, count_b, nweak_b, casc_b = fn(
                jnp.asarray(batch), g)
            rects_b = np.asarray(rects_b)
            scores_b = np.asarray(scores_b)
            valid_b = np.asarray(valid_b)
            count_b = np.asarray(count_b)
            if self.verifier is not None:
                casc_b = np.asarray(casc_b)
            if self.track_cost:
                nweak_b = np.asarray(nweak_b)
                nv = self._nvalid[(bucket_hw, real_hw, exact)]
                for j in range(nb):
                    if count_b[j] >= 0:  # fallback path tracks via detect
                        self.model._track_cost(int(nweak_b[j]), nv)
            for j, im in enumerate(chunk):
                if count_b[j] < 0:
                    # extraction overflow / recall miss: per-size exact
                    # dense fallback (same true-size semantics)
                    out.append(self._fallback_detect(im))
                    continue
                sel = valid_b[j]
                bx = Boxes(rects_b[j][sel])
                bx.set_field("scores", scores_b[j][sel].astype(np.float32))
                if self.verifier is not None:
                    bx.set_field("cascade_scores",
                                 casc_b[j][sel].astype(np.float32))
                out.append(bx)
        return out

    def detect(self, image):
        return self.detect_many([image])[0]

    def detect_many(self, images):
        images = [np.asarray(im) for im in images]
        groups = {}
        for idx, im in enumerate(images):
            if im.ndim != 2:
                raise ValueError("Image must have 2 dimensions")
            key = (self._snap(*im.shape), im.shape[:2])
            groups.setdefault(key, []).append(idx)
        out = [None] * len(images)
        for (bucket_hw, real_hw), idxs in groups.items():
            boxes = self._run_group(bucket_hw, real_hw,
                                    [images[i] for i in idxs])
            for i, b in zip(idxs, boxes):
                out[i] = b
        return out
