"""Polyphase-resize channel-canvas assembly (XLA path + shared geometry).

The pyramid's uint8 levels are produced by 4-corner *selector* resize
matrices (uint8 content is bf16-exact, so one bf16 matmul pass per axis is
bitwise equal to HIGHEST-precision f32 — see PARITY.md) and every level's
channels are computed ONCE over the packed canvas.  This module holds the
host-side tap builders, the XLA plane/channel pipelines, and the per-level
fallback; the packing planner lives in :mod:`waldboost_tpu.packing`.

Exactness contract: resize floors are computed in exact rational
arithmetic and the float pool/smooth keep the reference's f32 association
ORDER (see ops/exact.py and CLAUDE.md round-7 notes) — outputs are
bit-equal to /root/reference/waldboost/channels.py:111-146 on uint8 input.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .channels import compute_pyramid
from .packing import PackedPyramidPlan, _band_rows

#: precision of the one-hot selector matmuls over integer-valued (uint8)
#: content: every output is ONE product of a 0/1 weight and a value <= 255,
#: exact in any pass the GPU may pick (bf16, TF32 or f32)
_SELECT = jax.lax.Precision.DEFAULT


def _channel_canvas_fast(image, shrink, smooth, cf, packed: PackedPyramidPlan):
    """Canvas-first channel pipeline (the fast path).

    Every level is resized from its octave image into ONE image-space canvas
    (matmul resize), level halos are filled with symmetric
    reflections via one static gather, and the channel function / shrink
    pooling / smoothing each run ONCE over the whole canvas.  Per-level
    boundary semantics (scipy reflect for the float channels, numba-stencil
    zero borders for the integer channels, per-level zero-border smoothing)
    are restored by the halo reflection and static masks — outputs inside
    every level rect are identical to the per-level reference pipeline.
    """
    from .channels import CanvasCtx, _compute_octaves
    from .ops.warp import build_resize_matrix, reflect_halos, resize_taps

    if shrink == 2 and cf.canvas_fn_poly is not None:
        return _channel_canvas_poly(image, smooth, cf, packed)

    n_oct = max(pl.level.octave for pl in packed.levels) + 1
    octaves = _compute_octaves(image, n_oct)
    is_int = jnp.issubdtype(image.dtype, jnp.integer)

    Hc_img, Wc_img = packed.image_canvas_shape()
    img_canvas = jnp.zeros((Hc_img, Wc_img), jnp.float32)
    for pl in packed.levels:
        lv = pl.level
        oct_img = octaves[lv.octave].astype(jnp.float32)
        oh, ow = oct_img.shape
        if is_int:
            # exact-arithmetic resize + floor (integer tap numerators,
            # matmuls at HIGHEST precision, one exact final floor) — the
            # truncating uint8 cast of the reference has NO float ties here
            # (PARITY.md §1, ops.exact)
            from .ops.exact import axis_taps_exact, resize_exact_matmul
            im = resize_exact_matmul(oct_img,
                                     axis_taps_exact(oh, lv.height),
                                     axis_taps_exact(ow, lv.width))
        else:
            Rh = build_resize_matrix(*resize_taps(oh, lv.height), oh)
            Rw = build_resize_matrix(*resize_taps(ow, lv.width), ow)
            # HIGHEST precision: a reduced-precision f32 matmul (bf16 or
            # TF32 passes) leaves errors visible in float channels
            im = jnp.einsum("ah,hw,bw->ab", Rh, oct_img, Rw,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
        img_canvas = jax.lax.dynamic_update_slice(
            img_canvas, im, (pl.y * shrink, pl.x * shrink))

    if cf.boundary == "reflect" and cf.halo > 0:
        regions = packed.reflect_regions()
        img_canvas = reflect_halos(img_canvas, regions)
        reflect = lambda x: reflect_halos(x, regions)
    else:
        reflect = lambda x: x

    border_mask = None
    if cf.boundary == "stencil_zero":
        border_mask = jnp.asarray(packed.stencil_border_mask())
    ctx = CanvasCtx(reflect=reflect, border_mask=border_mask,
                    exact_int=bool(is_int))
    chns = cf.canvas_fn(img_canvas, ctx)

    if shrink == 2:
        from .ops.image import avg_pool_2
        chns = avg_pool_2(chns)
    if smooth == 1:
        from .ops.image import smooth_3x3
        chns = smooth_3x3(chns)
        interior = jnp.asarray(packed.smooth_interior_mask())
        zero = jnp.zeros((), chns.dtype)
        chns = jnp.where(interior[None], chns, zero)
    return chns


def _channel_canvas_poly(image, smooth, cf, packed: PackedPyramidPlan):
    """Polyphase canvas pipeline (shrink=2 fast path), single image."""
    planes = _poly_planes(image, cf, packed)
    return _poly_channels(planes, smooth, cf, packed)


def _channel_canvas_batch(images, shrink, n_per_oct, smooth, cf,
                          packed: PackedPyramidPlan, fast: bool = False):
    """(B, H, W) images -> (B, C, Hc, Wc) channel canvases.

    ``fast`` (the opt-in relaxed serving mode, resolved by the caller
    outside any trace): float content takes plain f32 chains instead of
    the double-float ones.  The canvas stays f32; serving casts it."""
    if shrink == 2 and cf.canvas_fn_poly is not None:
        planes = jax.vmap(
            lambda im: _poly_planes(im, cf, packed, fast=fast))(images)
        return _poly_channels(planes, smooth, cf, packed, fast=fast)
    if cf.canvas_fn is not None:
        return jax.vmap(
            lambda im: _channel_canvas_fast(im, shrink, smooth, cf, packed)
            .astype(jnp.float32))(images)
    return jax.vmap(
        lambda im: _channel_canvas_per_level(im, shrink, n_per_oct, smooth,
                                             cf, packed))(images)


def _poly_planes(image, cf, packed: PackedPyramidPlan, fast=False,
                 fast_bf16=None):
    """Resize every pyramid level into the 2x2-polyphase canvas planes.

    The full-resolution image canvas is materialized directly as its 2x2
    polyphase decomposition (2, 2, Hc, Wc): each level's resize matmul emits
    the four (row-phase, col-phase) planes in ONE einsum (the resize matrices'
    rows are just regrouped phase-major).  Downstream, stencils become
    cross-phase shifted adds and the shrink-2 average pool becomes
    elementwise — there is no strided access anywhere.  Level-edge reflect
    halos ride the resize matrices (duplicated boundary rows/cols), identical
    to a post-hoc reflect_halos_poly pass.

    The planes are assembled by shelf-band CONCATENATION: the packer's even
    halo gives every level one plane-space placement shared by all four
    phases, so each shelf of levels becomes one width-axis concat of
    (2, 2, hq, wq) blocks and zero gap strips, and the canvas one height-axis
    concat of shelf bands (a handful of fused ops, instead of a
    dynamic_update_slice per phase-quadrant — about 190 for a VGA
    pyramid).
    """
    from .channels import _compute_octaves_f32

    n_oct = max((pl.level.octave for pl in packed.levels), default=0) + 1
    octaves = _compute_octaves_f32(image, n_oct)
    is_int = jnp.issubdtype(image.dtype, jnp.integer)

    Hc, Wc = packed.canvas_h, packed.canvas_w
    # Reflect halos ride the resize matrices: a level's reflected halo band
    # is a copy of its own resized boundary rows/cols, so duplicating those
    # rows in R (host-side, _ext_pm in _poly_level_blocks) emits the halo
    # directly from the einsum — zero extra device ops, bit-identical to a
    # post-hoc reflect_halos_poly pass (the separable two-pass corner
    # semantics are exactly the outer product of duplicated rows and cols).
    halo = packed.halo if (cf.boundary == "reflect" and cf.halo > 0) else 0
    assert halo % 2 == 0, "packer guarantees an even baked halo"
    he2 = halo // 2  # halo in plane (channel-space) units

    PH, PW = Hc, Wc
    if fast_bf16 is None:
        # serving builds resolve this at BUILD time and pass it in; the
        # fallback read here happens at trace time (CLAUDE.md landmine:
        # env reads inside a traced fn bake the first value in)
        fast_bf16 = _fast_float_bf16()
    blocks = _poly_level_blocks(octaves, cf, packed, halo, is_int,
                                fast=fast, fast_bf16=fast_bf16)
    # integer-valued canvases (uint8 images) are exact in bf16 (<= 255 needs
    # 8 mantissa bits): halving the plane bytes halves the assembly writes
    # and the channel chain's reads, with identical values after the f32
    # upcast downstream.  Fast serving mode (WB_SERVING_MODE=fast) keeps
    # FLOAT content f32 by default (exact selection, plain lerp);
    # WB_FAST_FLOAT=bf16 opts into quantizing the input content itself.
    dtype = jnp.bfloat16 if (is_int or (fast and fast_bf16)) \
        else jnp.float32

    blocks = [b.astype(dtype) for b in blocks]
    xs = [pl.x - he2 for pl in packed.levels]

    def zeros(h, w):
        return jnp.zeros((2, 2, h, w), dtype)

    # Band assembly: each band is one width-axis concat of COLUMN blocks and
    # zero gap strips; a column is the height-axis concat of its
    # (row-disjoint) stacked level blocks.  Legacy single-slot plans
    # degenerate to exactly one concat per shelf.
    rows = []
    for ys, pitch, lis in _band_rows(packed, he2, 0, PH):
        cols_of: Dict[int, List[Tuple[int, int]]] = {}
        for li, top, col in lis:
            cols_of.setdefault(col, []).append((li, top))
        items = []
        for col, entries in cols_of.items():
            x0 = min(xs[li] for li, _ in entries)
            wcol = max(xs[li] + blocks[li].shape[3]
                       for li, _ in entries) - x0

            def fit_w(li):
                b = blocks[li]
                dx = xs[li] - x0
                if dx or b.shape[3] < wcol:
                    b = jnp.pad(b, ((0, 0), (0, 0), (0, 0),
                                    (dx, wcol - dx - b.shape[3])))
                return b

            segs = []
            cur = 0
            for li, top in sorted(entries, key=lambda t: t[1]):
                b = fit_w(li)
                assert top >= cur, "stacked slots overlap (packer bug)"
                if top > cur:
                    segs.append(zeros(top - cur, wcol))
                segs.append(b)
                cur = top + b.shape[2]
            assert cur <= pitch, (cur, pitch)
            if cur < pitch:
                segs.append(zeros(pitch - cur, wcol))
            blk = (jnp.concatenate(segs, axis=-2)
                   if len(segs) > 1 else segs[0])
            items.append((x0, blk))
        items.sort(key=lambda t: t[0])
        cols = []
        cur_c = 0
        for c0, b in items:
            assert c0 >= cur_c, "column blocks overlap (packer gap violated)"
            if c0 > cur_c:
                cols.append(zeros(pitch, c0 - cur_c))
            cols.append(b)
            cur_c = c0 + b.shape[3]
        if cur_c < PW:
            cols.append(zeros(pitch, PW - cur_c))
        rows.append(jnp.concatenate(cols, axis=-1)
                    if len(cols) > 1 else cols[0])
    if not rows:
        return zeros(PH, PW)
    out = jnp.concatenate(rows, axis=-2) if len(rows) > 1 else rows[0]
    assert out.shape[-2:] == (PH, PW), (out.shape, PH, PW)
    return out


def _ext_pm_taps(R, size, halo):
    """Reflect-halo row duplication + phase-major regrouping of a tap
    vector (rows of the resize matrix in 2x2-polyphase emission order)."""
    if halo:
        R = np.concatenate([R[halo - 1::-1], R,
                            R[size - 1:size - halo - 1:-1]])
    return np.concatenate([R[halo % 2::2], R[(1 + halo) % 2::2]])


def _combine_block(G, frn, fcn, den_h, den_w, hq, wq):
    """Exact 4-corner bilinear combine + floor over the bf16-exact corner
    gathers: ``frn``/``fcn`` are integer frac NUMERATORS (phase-major) over
    the static denominators — ops.exact.combine4_exact computes the uint8
    truncation with no float ties (PARITY.md §1)."""
    from .ops.exact import combine4_exact

    FH = jnp.asarray(np.asarray(frn, np.float32)
                     .reshape(2, hq))[:, None, :, None]
    FW = jnp.asarray(np.asarray(fcn, np.float32)
                     .reshape(2, wq))[None, :, None, :]

    def g(a, b2):
        # per-slice upcast fuses into the combine (a full-G astype
        # would materialize an f32 copy)
        return G[a, b2].astype(jnp.float32)

    return combine4_exact(g(0, 0), g(0, 1), g(1, 0), g(1, 1),
                          FH, FW, den_h, den_w)


def _combine_block_dd(G, fr64h, fr64w, hq, wq):
    """Float-image 4-corner combine: the reference's f64 two-pass lerp
    (rows, then cols on the UNROUNDED row result, one f32 rounding at the
    end — tests/refshims/skimage float branch) evaluated in double-float
    pairs (ops.dd).  ``fr64h``/``fr64w`` are the phase-major FLOAT64 frac
    vectors; corners in ``G`` are exact f32 selections."""
    from .ops.dd import dd_round, lerp_dd

    def consts(v, reshape, bcast):
        v = np.asarray(v, np.float64).reshape(reshape)
        om = 1.0 - v
        out = []
        for a in (v, om):
            hi = a.astype(np.float32)
            lo = (a - hi).astype(np.float32)
            out += [jnp.asarray(hi)[bcast], jnp.asarray(lo)[bcast]]
        return out  # [fr_hi, fr_lo, omfr_hi, omfr_lo]

    fh, fl, oh_, ol = consts(fr64h, (2, hq),
                             (slice(None), None, slice(None), None))
    gh, gl, ph, pl_ = consts(fr64w, (2, wq),
                             (None, slice(None), None, slice(None)))

    def f32(a):
        return (a.astype(jnp.float32), jnp.zeros(a.shape, jnp.float32))

    rows = [lerp_dd(f32(G[0, b]), f32(G[1, b]), fh, fl, oh_, ol)
            for b in (0, 1)]
    return dd_round(lerp_dd(rows[0], rows[1], gh, gl, ph, pl_))


def _fast_float_bf16() -> bool:
    """WB_FAST_FLOAT=bf16 (resolved at detector-build/trace time, like
    WB_SERVING_MODE): fast-mode float frames quantize the CONTENT to bf16
    planes (single-pass selection einsums) instead of the default f32
    planes (exact HIGHEST selection): a cheaper plane build and half the
    plane bytes, at a much looser deviation bound."""
    import os
    return os.environ.get("WB_FAST_FLOAT", "f32") == "bf16"


def _combine_block_plain(G, fr64h, fr64w, hq, wq, out_dtype):
    """Fast-serving float combine: plain f32 two-pass lerp over the corner
    selections, emitted in the fast plane dtype.  No dd compensation, no
    floor — float content, relaxed contract (WB_SERVING_MODE=fast)."""
    FH = jnp.asarray(np.asarray(fr64h, np.float32)
                     .reshape(2, hq))[:, None, :, None]
    FW = jnp.asarray(np.asarray(fr64w, np.float32)
                     .reshape(2, wq))[None, :, None, :]

    def f32(a):
        return a.astype(jnp.float32)

    rows = [f32(G[0, b]) + FH * (f32(G[1, b]) - f32(G[0, b]))
            for b in (0, 1)]
    return (rows[0] + FW * (rows[1] - rows[0])).astype(out_dtype)


def _poly_level_blocks(octaves, cf, packed: PackedPyramidPlan, halo,
                       is_int, fast=False, fast_bf16=False):
    """Per-level resized blocks in (2, 2, hq, wq) phase layout, with ``halo``
    (even) reflect rows/cols baked into the resize matrices."""
    from .ops.warp import build_resize_matrix, resize_taps

    def _ext_pm(R, size):
        return _ext_pm_taps(R, size, halo)

    blocks = [None] * len(packed.levels)
    col_groups: Dict[int, list] = {}
    for li, pl in enumerate(packed.levels):
        lv = pl.level
        oct_img = octaves[lv.octave]
        if oct_img.dtype != jnp.float32:
            oct_img = oct_img.astype(jnp.float32)
        oh, ow = oct_img.shape
        # matrices built on device from tiny tap vectors (embedding the
        # dense matrices as HLO constants makes the compile payload
        # O(sum of n_out*n_in) — 100+ MB for 4K pyramids); the _ext_pm
        # row transforms apply to the tap vectors directly
        if is_int:
            # exact integer taps (numerators over static denominators)
            from .ops.exact import axis_taps_exact
            th = axis_taps_exact(oh, lv.height)
            tw = axis_taps_exact(ow, lv.width)
            den_h, den_w = th[2], tw[2]
            i0h, frh = (_ext_pm(t, lv.height)
                        for t in (th[0], th[1].astype(np.float32)))
            i0w, frw = (_ext_pm(t, lv.width)
                        for t in (tw[0], tw[1].astype(np.float32)))
        else:
            from .ops.warp import resize_taps64
            i0h, frh = (
                _ext_pm(t, lv.height) for t in resize_taps64(oh, lv.height))
            i0w, frw = (
                _ext_pm(t, lv.width) for t in resize_taps64(ow, lv.width))
        hq = (lv.height + 2 * halo) // 2
        wq = (lv.width + 2 * halo) // 2
        if is_int:
            # 4-corner selector resize: integer-valued images are bf16-exact,
            # so the four corner gathers are 0/1 selector matmuls at DEFAULT
            # precision (exact in any pass: one-hot rows select uint8-exact
            # values); the bilinear weights then apply elementwise in f32
            # with EXACTLY ops.image._resize_bilinear_f32's lerp association
            # — bit-identical to the spec path.
            z = np.zeros_like(frh)
            zw = np.zeros_like(frw)
            # both selector pairs stacked along a leading free dim: each
            # level stays TWO dot ops (as with the tap matmuls), just
            # single-pass — the 4-corner structure rides free dims
            Sh = jnp.stack([
                build_resize_matrix(i0h, z, oh),
                build_resize_matrix(np.minimum(i0h + 1, oh - 1), z, oh),
            ]).reshape(2, 2, hq, oh)
            Sw = jnp.stack([
                build_resize_matrix(i0w, zw, ow),
                build_resize_matrix(np.minimum(i0w + 1, ow - 1), zw, ow),
            ]).reshape(2, 2, wq, ow)
            # rows are selected uint8-exact values: bf16 storage is exact
            # and halves the intermediate's traffic
            # contraction order picked per level by FLOP count: the second
            # pass contracts over the FIRST pass's source axis, so leading
            # with the larger source axis is cheaper (typically col-first
            # for landscape levels)
            row_first = (4 * hq * oh * ow + 16 * hq * wq * ow
                         <= 4 * wq * oh * ow + 16 * hq * wq * oh)
            if row_first:
                rows = jnp.einsum("aprh,hw->aprw", Sh, oct_img,
                                  preferred_element_type=jnp.bfloat16,
                                  precision=_SELECT)
                # G holds selected integer-valued pixels: bf16-exact, half
                # the intermediate traffic; the lerp upcasts per slice
                G = jnp.einsum("aprw,bqcw->abpqrc", rows, Sw,
                               preferred_element_type=jnp.bfloat16,
                               precision=_SELECT)
                blocks[li] = _combine_block(G, frh, frw, den_h, den_w,
                                            hq, wq)
            else:
                # col-first levels of one octave contract the SAME octave
                # image over w: their Sw selectors concatenate along the
                # output-col axis into ONE pass-1 matmul per octave (each
                # output element's dot product is unchanged — bit-identical
                # to the per-level einsum, one matmul instead of several)
                col_groups.setdefault(lv.octave, []).append(
                    (li, Sh, Sw, frh, frw, den_h, den_w, hq, wq))
            continue
        # float images: 4-corner selection at HIGHEST f32 (one-hot rows
        # select exact f32 values; bf16 selection would truncate float
        # content), then the f64 two-pass lerp in double-float — bitwise
        # the reference's resize(...).astype(f32) chain (ops.dd; the
        # round-4 f32 triple-einsum lerp carried the 260-ULP bound).
        # Fast serving mode trades that contract for throughput: the
        # selection stays one-hot but the lerp is plain f32 — no dd — and
        # the f32 planes feed the plain channel chains.  WB_FAST_FLOAT=bf16
        # additionally quantizes the content to bf16 planes.
        z = np.zeros(len(i0h), np.float32)
        zw = np.zeros(len(i0w), np.float32)
        Sh = jnp.stack([
            build_resize_matrix(i0h, z, oh),
            build_resize_matrix(np.minimum(i0h + 1, oh - 1), z, oh),
        ]).reshape(2, 2, hq, oh)
        Sw = jnp.stack([
            build_resize_matrix(i0w, zw, ow),
            build_resize_matrix(np.minimum(i0w + 1, ow - 1), zw, ow),
        ]).reshape(2, 2, wq, ow)
        if fast and fast_bf16:
            # the bf16 outputs ARE the quantization; the pass precision
            # only decides how a value rounds on its way there
            rows = jnp.einsum("aprh,hw->aprw", Sh, oct_img,
                              preferred_element_type=jnp.bfloat16,
                              precision=jax.lax.Precision.DEFAULT)
            G = jnp.einsum("aprw,bqcw->abpqrc", rows, Sw,
                           preferred_element_type=jnp.bfloat16,
                           precision=jax.lax.Precision.DEFAULT)
            blocks[li] = _combine_block_plain(G, frh, frw, hq, wq,
                                              jnp.bfloat16)
            continue
        # fast f32 planes: HIGH (3-pass) selection instead of HIGHEST
        # (6-pass) — the ~2^-17 relative selection residue sits far below
        # the mode's own plain-projection + bf16-canvas deviation.  (A
        # manual hi/lo split einsum pair is NOT an option:
        # --xla_allow_excess_precision folds the f32->bf16->f32 round-trip
        # that builds the hi term into a no-op.)  The exact path keeps HIGHEST: its selection must
        # reproduce f32 values bitwise for the dd lerp.
        prec = jax.lax.Precision.HIGH if fast else jax.lax.Precision.HIGHEST
        rows = jnp.einsum("aprh,hw->aprw", Sh, oct_img,
                          preferred_element_type=jnp.float32,
                          precision=prec)
        G = jnp.einsum("aprw,bqcw->abpqrc", rows, Sw,
                       preferred_element_type=jnp.float32,
                       precision=prec)
        if fast:
            blocks[li] = _combine_block_plain(G, frh, frw, hq, wq,
                                              jnp.float32)
        else:
            blocks[li] = _combine_block_dd(G, frh, frw, hq, wq)

    # grouped pass-1 for the col-first int levels, one matmul per octave
    for octv, items in col_groups.items():
        oct_img = octaves[octv]
        if oct_img.dtype != jnp.float32:
            oct_img = oct_img.astype(jnp.float32)
        Sw_cat = jnp.concatenate([it[2] for it in items], axis=2)
        cols_cat = jnp.einsum("hw,bqcw->bhqc", oct_img, Sw_cat,
                              preferred_element_type=jnp.bfloat16,
                              precision=_SELECT)
        off = 0
        for li, Sh, _Sw, frh, frw, den_h, den_w, hq, wq in items:
            cols = cols_cat[:, :, :, off:off + wq]
            off += wq
            G = jnp.einsum("aprh,bhqc->abpqrc", Sh, cols,
                           preferred_element_type=jnp.bfloat16,
                           precision=_SELECT)
            blocks[li] = _combine_block(G, frh, frw, den_h, den_w, hq, wq)
    return blocks


def _poly_channels(planes, smooth, cf, packed: PackedPyramidPlan,
                   fast: bool = False):
    """Polyphase planes (B?, 2, 2, Hc, Wc) -> pooled channel canvas
    (B?, C, Hc, Wc), one XLA chain (channels, pool, smooth, mask)."""
    from .channels import CanvasCtx

    interior = jnp.asarray(packed.smooth_interior_mask()) if smooth == 1 \
        else None
    bmp = None
    if cf.boundary == "stencil_zero":
        bm = packed.stencil_border_mask()  # image-space (2Hc, 2Wc)
        Hc2, Wc2 = bm.shape
        bmp = jnp.asarray(bm.reshape(Hc2 // 2, 2, Wc2 // 2, 2)
                          .transpose(1, 3, 0, 2))
    ctx = CanvasCtx(reflect=lambda x: x, border_mask_poly=bmp, fast=fast)

    def one(p):
        chns = cf.canvas_fn_poly(p, ctx)  # pooled (C, Hc, Wc)
        if smooth == 1:
            from .ops.image import smooth_3x3
            chns = smooth_3x3(chns)
            if cf.boundary == "stencil_zero":
                # integer channels (uint8 in the canvas path) truncate the
                # /16 back — the numba-stencil uint8 assignment semantics
                # (/root/reference/waldboost/channels.py:78-90 applied to
                # fpga channels); values are nonneg so floor == trunc
                chns = jnp.floor(chns)
            zero = jnp.zeros((), chns.dtype)
            chns = jnp.where(interior[None], chns, zero)
        return chns

    return jax.vmap(one)(planes) if planes.ndim == 5 else one(planes)


def _channel_canvas_per_level(image, shrink, n_per_oct, smooth, cf,
                              packed: PackedPyramidPlan):
    """Fallback canvas assembly for channel functions without a canvas_fn:
    per-level channel tensors written into the canvas (exact but slower)."""
    opts = dict(shrink=shrink, n_per_oct=n_per_oct, smooth=smooth, channels=cf)
    levels = compute_pyramid(image, opts)
    canvas = jnp.zeros((cf.n_channels, packed.canvas_h, packed.canvas_w),
                       jnp.float32)
    for pl in packed.levels:
        chns, _ = levels[pl.plan_index]
        canvas = jax.lax.dynamic_update_slice(
            canvas, chns.astype(jnp.float32), (0, pl.y, pl.x))
    return canvas

