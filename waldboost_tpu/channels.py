"""Channel features: channel functions, registry, and the multi-scale pyramid.

Device redesign of the reference's waldboost/channels.py:

* Channel functions are pure JAX functions ``(H, W) image -> (C, H, W)``
  channels (channel-major on device; the public generator yields HWC numpy to
  preserve the reference API).
* The ragged generator-of-scales becomes a *static pyramid plan* computed
  host-side from the image shape (:func:`pyramid_plan`); the device pipeline
  is traced once per (image-shape, channel-opts) and compiled by XLA with
  fully static shapes (:func:`compute_pyramid`).
* Channel functions are persisted by *registry name* (a safe lookup table)
  instead of the reference's ``eval``-based dynamic import
  (/root/reference/waldboost/model.py:23-29).

Level geometry reproduces /root/reference/waldboost/channels.py:93-146
exactly: octave halving via ``avg_pool_2`` while min side >= 8, ``n_per_oct``
intra-octave scales with factor ``2**(-1/n_per_oct)``, sizes snapped to
multiples of ``shrink`` via ``int((w*s)/shrink)*shrink`` (load-bearing for
parity), ``real_scale = nw / original_width``, optional shrink-2 average pool
and 3x3 binomial smoothing, yielded scale is ``real_scale / shrink``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import image as imops

__all__ = [
    "ChannelFunction",
    "register_channel_function",
    "resolve_channel_function",
    "grad_mag",
    "grad_hist",
    "channel_pyramid",
    "pyramid_plan",
    "compute_pyramid",
    "Level",
    "default_channel_opts",
]


# ---------------------------------------------------------------------------
# Channel function registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CanvasCtx:
    """Context handed to canvas-mode channel functions.

    ``reflect``: fills each pyramid level's halo band with the symmetric
    reflection of the level content (one static gather) — how per-level
    scipy ``mode='reflect'`` boundary semantics survive the packed canvas.
    ``border_mask``: image-space bool mask, False on each level's 1px border
    ring and outside levels — the numba-stencil zero-border convention of the
    FPGA channels.
    """

    reflect: Callable[[jax.Array], jax.Array]
    border_mask: Optional[jax.Array] = None
    #: (2, 2, Hc, Wc) polyphase form of ``border_mask`` for canvas_fn_poly
    #: implementations (mask[a, b, i, j] = border_mask[2i+a, 2j+b])
    border_mask_poly: Optional[jax.Array] = None
    #: True when the (float-typed) canvas holds uint8-valued content — lets
    #: integer-exact channel paths (ops.exact projections) engage even
    #: though the canvas dtype is f32/bf16
    exact_int: bool = False
    #: fast serving mode (WB_SERVING_MODE=fast, resolved at BUILD time by
    #: the caller): float content skips the dd double-float chains for
    #: plain f32 arithmetic (a relaxed, not bit-exact contract)
    fast: bool = False


@dataclasses.dataclass(frozen=True)
class ChannelFunction:
    """A named image->channels transform.

    ``fn`` maps a (H, W) image (dtype preserved from the resize stage) to a
    (C, H, W) channel tensor.  ``name`` is the canonical registry key, also
    written into saved models; ``aliases`` list additional accepted names
    (including the reference's dotted symbol paths, so models saved by the CPU
    reference load here).

    Canvas mode (the fast path): ``canvas_fn(canvas, ctx)`` computes channels
    for a whole packed multi-level canvas in one pass.  ``halo`` declares the
    image-space reflect halo the function needs around each level for its
    outputs to be exact at level edges (gradient radius + normalization
    radius); ``boundary`` selects reflect halos vs the numba-stencil
    zero-border convention.
    """

    name: str
    fn: Callable[[jax.Array], jax.Array]
    n_channels: int
    aliases: Tuple[str, ...] = ()
    halo: int = 1
    boundary: str = "reflect"  # or "stencil_zero"
    canvas_fn: Optional[Callable[[jax.Array, CanvasCtx], jax.Array]] = None
    #: polyphase canvas mode (the shrink=2 fast path): takes the 2x2
    #: polyphase planes (2, 2, Hc, Wc) of the full-res canvas and returns the
    #: *pooled* (C, Hc, Wc) channel canvas.  Stencils become cross-phase
    #: shifted adds and the 2x2 average pool becomes elementwise — no strided
    #: access anywhere, so XLA fuses the whole chain.
    canvas_fn_poly: Optional[Callable[[jax.Array, CanvasCtx], jax.Array]] = None

    def __call__(self, image: jax.Array) -> jax.Array:
        return self.fn(image)

    def __post_init__(self):
        # the reference persists channel funcs as dotted symbol paths via
        # __module__ + __qualname__ (/root/reference/waldboost/model.py:23);
        # exposing the registry name as instance attributes lets reference
        # code save models whose channel function is one of ours
        if "." in self.name:
            mod, qual = self.name.rsplit(".", 1)
        else:
            mod, qual = "waldboost_tpu.channels", self.name
        object.__setattr__(self, "__qualname__", qual)
        object.__setattr__(self, "__module__", mod)


_REGISTRY: Dict[str, ChannelFunction] = {}


def register_channel_function(cf: ChannelFunction) -> ChannelFunction:
    for key in (cf.name,) + tuple(cf.aliases):
        _REGISTRY[key] = cf
    return cf


def resolve_channel_function(name_or_cf) -> ChannelFunction:
    """Safe registry lookup (replaces the reference's ``eval``-based
    ``symbol_from_name``, /root/reference/waldboost/model.py:27-29).

    ``"a+b"`` names resolve to :func:`compose_channel_functions` — the
    multi-channel composition facility (e.g.
    ``"grad_hist_4_u1+grad_mag_u1"``, the quantized 5-channel FPGA
    pipeline)."""
    if isinstance(name_or_cf, ChannelFunction):
        return name_or_cf
    if name_or_cf not in _REGISTRY:
        # built-in submodules register on import; pull them in lazily so a
        # saved model loads without the user importing waldboost_tpu.fpga
        import importlib
        importlib.import_module("waldboost_tpu.fpga.channels")
    if name_or_cf not in _REGISTRY and isinstance(name_or_cf, str) \
            and "+" in name_or_cf:
        return compose_channel_functions(*name_or_cf.split("+"))
    try:
        return _REGISTRY[name_or_cf]
    except KeyError:
        raise KeyError(
            f"Unknown channel function '{name_or_cf}'. Registered: "
            f"{sorted(set(cf.name for cf in _REGISTRY.values()))}"
        ) from None


def compose_channel_functions(*parts) -> ChannelFunction:
    """Concatenate channel functions along the channel axis into one
    registry entry (channels stacked in argument order).

    The reference has no built-in facility — a user passes a lambda that
    ``np.concatenate``s the parts (channel_opts takes any callable,
    /root/reference/waldboost/channels.py:116-119); this is that, with the
    canvas/polyphase fast paths composed too, persisted by the "a+b" name.
    """
    cfs = [resolve_channel_function(p) for p in parts]
    assert len(cfs) >= 2
    name = "+".join(cf.name for cf in cfs)
    if name in _REGISTRY:
        return _REGISTRY[name]
    boundary = cfs[0].boundary
    assert all(cf.boundary == boundary for cf in cfs), \
        "composed channel functions must share a boundary convention"

    def fn(image):
        return jnp.concatenate([cf.fn(image) for cf in cfs], axis=0)

    canvas_fn = None
    if all(cf.canvas_fn is not None for cf in cfs):
        def canvas_fn(canvas, ctx):
            return jnp.concatenate(
                [cf.canvas_fn(canvas, ctx).astype(jnp.float32)
                 for cf in cfs], axis=0)

    canvas_fn_poly = None
    if all(cf.canvas_fn_poly is not None for cf in cfs):
        def canvas_fn_poly(planes, ctx):
            return jnp.concatenate(
                [cf.canvas_fn_poly(planes, ctx) for cf in cfs], axis=0)

    composed = ChannelFunction(
        name=name,
        fn=fn,
        n_channels=sum(cf.n_channels for cf in cfs),
        aliases=("+".join(p if isinstance(p, str) else p.name
                          for p in parts),),
        halo=max(cf.halo for cf in cfs),
        boundary=boundary,
        canvas_fn=canvas_fn,
        canvas_fn_poly=canvas_fn_poly,
    )
    return register_channel_function(composed)


# ---------------------------------------------------------------------------
# Built-in channel functions (float family)
# ---------------------------------------------------------------------------

def _grad_mag_fn(image: jax.Array, norm: int = 5, eps: float = 1e-3) -> jax.Array:
    """Locally-normalized gradient magnitude, 1 channel.
    Mirrors /root/reference/waldboost/channels.py:30-37."""
    gx, gy = imops.gradients(image.astype(jnp.float32))
    mag = jnp.sqrt(gx * gx + gy * gy)
    if norm is not None and norm > 1:
        H = imops.triangle_kernel(norm)
        nrm = imops.separable_filter_reflect(mag, H)
        mag = mag / (nrm + eps)
    return mag[None, :, :]


def _project_hist(gx: jax.Array, gy: jax.Array, n_bins: int, full: bool,
                  bias: float, exact: bool, fast: bool = False) -> jax.Array:
    """Stacked oriented projections of (... H, W) gradients -> (n_bins, ...).

    ``exact``: the gradients are uint8-image integers, so each bin equals
    the reference's NumPy-2 semantics ``f32(f64(gx*cos - gy*sin))`` via the
    exhaustively-verified plan of ops.exact.projection_plan (PARITY.md §1c).
    Non-integer inputs evaluate the same f64-promoted store in double-float
    arithmetic (ops.dd.proj_dd, round 5 — the round-4 plain-f32 projection
    was a few-ULP documented deviation).
    """
    plan = None
    if exact:
        from .ops.exact import projection_plan
        plan = projection_plan(n_bins, full)
    if plan is not None:
        from .ops.exact import project_bins
        chns = jnp.stack(project_bins(gx, gy, plan))
    elif fast:
        # fast serving mode: plain f32 projections
        max_theta = 2 * np.pi if full else np.pi
        theta = np.linspace(0, max_theta, n_bins + 1)[:-1]
        chns = jnp.stack([gx * np.float32(np.cos(t))
                          - gy * np.float32(np.sin(t)) for t in theta])
    else:
        from .ops.dd import proj_dd
        max_theta = 2 * np.pi if full else np.pi
        theta = np.linspace(0, max_theta, n_bins + 1)[:-1]
        chns = jnp.stack([proj_dd(gx, gy, np.cos(t), np.sin(t))
                          for t in theta])
    value = jnp.maximum(jnp.abs(chns) - bias, 0.0)
    return jnp.sign(chns) * value if full else value


def _grad_hist_fn(image: jax.Array, n_bins: int = 4, full: bool = False,
                  bias: float = 0.0, exact: Optional[bool] = None,
                  fast: bool = False) -> jax.Array:
    """Oriented-gradient projections, ``n_bins`` channels.
    Mirrors /root/reference/waldboost/channels.py:40-52.  ``fast``: float
    content computes plain f32 chains (no dd) — the fast serving mode's
    relaxed contract."""
    if exact is None:
        exact = image.dtype == jnp.uint8
    fast = fast and not exact
    gx, gy = imops.gradients(image.astype(jnp.float32),
                             float_dd=not exact and not fast)
    return _project_hist(gx, gy, n_bins, full, bias, exact, fast=fast)


def _grad_mag_canvas_fn(canvas: jax.Array, ctx: CanvasCtx, norm: int = 5,
                        eps: float = 1e-3) -> jax.Array:
    """Canvas-mode grad_mag: one gradient pass over the packed canvas (level
    halos hold reflected image pixels, so level-edge gradients are exact);
    the magnitude is then halo-reflected before the triangle normalization so
    the norm conv sees reflected *magnitudes*, exactly like the per-level
    reference (/root/reference/waldboost/channels.py:30-37).

    Shifted-adds throughout: single-input-channel convolutions are a poor
    shape for a matrix unit.
    """
    gx, gy = imops.gradients(canvas.astype(jnp.float32))
    mag = jnp.sqrt(gx * gx + gy * gy)
    if norm is not None and norm > 1:
        mag_r = ctx.reflect(mag)
        H = imops.triangle_kernel(norm)
        nrm = imops.separable_filter_reflect(mag_r, H)
        mag = mag / (nrm + eps)
    return mag[None, :, :]


def _grad_hist_canvas_fn(canvas: jax.Array, ctx: CanvasCtx, n_bins: int = 4,
                         full: bool = False, bias: float = 0.0) -> jax.Array:
    # single gradient pass (shifted adds); level halos make edges exact
    return _grad_hist_fn(canvas, n_bins=n_bins, full=full, bias=bias,
                         exact=ctx.exact_int or None, fast=ctx.fast)


def _shift(p: jax.Array, dr: int, dc: int) -> jax.Array:
    """p[i+dr, j+dc] with zero fill (|dr|, |dc| <= 1); static pad+slice.
    Edge fill only reaches canvas margins/gaps, which valid windows never
    read (halo-aware packer)."""
    if dr:
        pad = [(0, 0)] * (p.ndim - 2) + ([(1, 0), (0, 0)] if dr < 0 else [(0, 1), (0, 0)])
        p = jnp.pad(p, pad)
        p = p[..., 1:, :] if dr > 0 else p[..., :-1, :]
    if dc:
        pad = [(0, 0)] * (p.ndim - 2) + [(0, 0), (1, 0) if dc < 0 else (0, 1)]
        p = jnp.pad(p, pad)
        p = p[..., :, 1:] if dc > 0 else p[..., :, :-1]
    return p


def _gradients_poly(planes: jax.Array,
                    float_dd: bool = False) -> Tuple[jax.Array, jax.Array]:
    """Full-resolution smoothed gradients of a 2x2-polyphase canvas.

    ``planes``: (2, 2, H, W) with planes[a, b, i, j] = canvas[2i+a, 2j+b].
    Returns (gx, gy) in the same polyphase layout.  Cross-phase shifted adds
    replicate ops.image.gradients exactly (integer inputs make f32 sums
    exact, so the association is irrelevant; the term order still matches).

    ``float_dd``: float-image content — the [1,2,1] prefilter sums
    error-free and rounds ONCE (scipy.ndimage's f64 accumulator semantics;
    ops.image._conv121_dd has the single-plane form).
    """
    if float_dd:
        from .ops.dd import two_sum

        def tap3(a, b, c):
            s1, e1 = two_sum(a, 2.0 * b)
            s2, e2 = two_sum(s1, c)
            return s2 + (e1 + e2)
    else:
        def tap3(a, b, c):
            return a + 2.0 * b + c
    P = [[planes[0, 0], planes[0, 1]], [planes[1, 0], planes[1, 1]]]
    # sx[a][b] = x[2i+a, 2j+b-1] + 2 x[2i+a, 2j+b] + x[2i+a, 2j+b+1]
    sx = [[tap3(_shift(P[a][1], 0, -1), P[a][0], P[a][1]),
           tap3(P[a][0], P[a][1], _shift(P[a][0], 0, +1))]
          for a in (0, 1)]
    # gy[a][b] = sx[2i+a-1, j] - sx[2i+a+1, j]
    gy = [[_shift(sx[1][b], -1, 0) - sx[1][b] for b in (0, 1)],
          [sx[0][b] - _shift(sx[0][b], +1, 0) for b in (0, 1)]]
    # sy[a][b] = x[2i+a-1, 2j+b] + 2 x[2i+a, 2j+b] + x[2i+a+1, 2j+b]
    sy = [[tap3(_shift(P[1][b], -1, 0), P[0][b], P[1][b]) for b in (0, 1)],
          [tap3(P[0][b], P[1][b], _shift(P[0][b], +1, 0)) for b in (0, 1)]]
    # gx[a][b] = sy[i, 2j+b-1] - sy[i, 2j+b+1]
    gx = [[_shift(sy[a][1], 0, -1) - sy[a][1],
           sy[a][0] - _shift(sy[a][0], 0, +1)] for a in (0, 1)]
    gx = jnp.stack([jnp.stack(r) for r in gx])
    gy = jnp.stack([jnp.stack(r) for r in gy])
    return gx, gy


def _grad_hist_poly_fn(planes: jax.Array, ctx: CanvasCtx, n_bins: int = 4,
                       full: bool = False, bias: float = 0.0) -> jax.Array:
    """Polyphase grad_hist + 2x2 average pool, fused and stride-free.

    The pooled channel value sums in the reference's f32 order
    ``((TL + BL) + TR) + BR`` (/root/reference/waldboost/channels.py:55-64)
    then divides by 4; exact projections apply when the planes carry uint8
    content (bf16 plane dtype or ctx.exact_int).
    """
    exact = ctx.exact_int or planes.dtype == jnp.bfloat16
    fast = ctx.fast and not exact
    gx, gy = _gradients_poly(planes.astype(jnp.float32),
                             float_dd=not exact and not fast)  # (2,2,H,W)
    # (C, 2, 2, H, W) projections
    value = _project_hist(gx, gy, n_bins, full, bias, exact, fast=fast)
    pooled = (((value[:, 0, 0] + value[:, 1, 0]) + value[:, 0, 1])
              + value[:, 1, 1]) / 4.0
    return pooled


grad_mag = register_channel_function(
    ChannelFunction(
        name="waldboost_tpu.channels.grad_mag",
        fn=_grad_mag_fn,
        n_channels=1,
        aliases=("grad_mag", "waldboost.channels.grad_mag", "waldboost.nb_channels.grad_mag"),
        halo=6,  # gradient radius 1 + triangle norm radius 5
        canvas_fn=_grad_mag_canvas_fn,
    )
)

grad_hist = register_channel_function(
    ChannelFunction(
        name="waldboost_tpu.channels.grad_hist",
        fn=_grad_hist_fn,
        n_channels=4,
        aliases=("grad_hist", "waldboost.channels.grad_hist", "waldboost.nb_channels.grad_hist"),
        halo=1,  # gradient radius only
        canvas_fn=_grad_hist_canvas_fn,
        canvas_fn_poly=_grad_hist_poly_fn,
    )
)


default_channel_opts = dict(shrink=2, n_per_oct=8, smooth=1, channels=grad_hist)


# ---------------------------------------------------------------------------
# Pyramid plan (static, host-side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Level:
    octave: int      # which halved octave image this level resizes from
    height: int      # resize target of the octave image (pre-shrink)
    width: int
    out_height: int  # channel tensor size after optional shrink pooling
    out_width: int
    scale: float     # channel-grid coordinate * 1/scale = image coordinate


def _normalize_opts(channel_opts: dict) -> Tuple[int, int, int, ChannelFunction]:
    shrink = int(channel_opts["shrink"])
    n_per_oct = int(channel_opts["n_per_oct"])
    smooth = int(channel_opts["smooth"])
    cf = resolve_channel_function(channel_opts["channels"])
    if shrink not in (1, 2):
        raise ValueError("Shrink factor must be integer 1 <= shrink <= 2")
    return shrink, n_per_oct, smooth, cf


@functools.lru_cache(maxsize=None)
def pyramid_plan(h: int, w: int, shrink: int, n_per_oct: int) -> Tuple[Level, ...]:
    """Static description of every pyramid level for an (h, w) image.

    Pure host arithmetic replicating the generator loop at
    /root/reference/waldboost/channels.py:93-131.
    """
    levels: List[Level] = []
    oh, ow = h, w
    octave = 0
    factor = 2.0 ** (-1.0 / n_per_oct)
    while oh >= 8 and ow >= 8:
        for i in range(n_per_oct):
            s = factor ** i
            nw = int((ow * s) / shrink) * shrink
            nh = int((oh * s) / shrink) * shrink
            real_scale = nw / w
            levels.append(
                Level(
                    octave=octave,
                    height=nh,
                    width=nw,
                    out_height=nh // shrink,
                    out_width=nw // shrink,
                    scale=real_scale / shrink,
                )
            )
        oh, ow = oh // 2, ow // 2
        octave += 1
    return tuple(levels)


def _compute_octaves(image: jax.Array, n_octaves: int) -> List[jax.Array]:
    octaves = [image]
    for _ in range(n_octaves - 1):
        prev = octaves[-1]
        if prev.dtype == jnp.uint8 and prev.ndim == 2:
            # bit-identical matmul form of avg_pool_2 (uint8 is bf16-exact)
            octaves.append(imops.avg_pool_2_u8_matmul(prev))
        else:
            octaves.append(imops.avg_pool_2(prev))
    return octaves


def _compute_octaves_f32(image: jax.Array, n_octaves: int) -> List[jax.Array]:
    """Octave chain for the device resize paths, f32 throughout.

    For uint8 images the values are IDENTICAL to :func:`_compute_octaves`
    (pair sums stay exact in f32, the mod-256 wrap and the truncating /4 are
    reproduced explicitly) but every u8<->float conversion disappears (the
    uint8 round-trip after each pool and the per-level upcast).  Non-uint8 images fall back to
    the generic chain (then upcast), keeping reference dtype semantics.
    """
    if image.dtype != jnp.uint8 or image.ndim != 2:
        return [o.astype(jnp.float32)
                for o in _compute_octaves(image, n_octaves)]
    octaves = [image.astype(jnp.float32)]
    for _ in range(n_octaves - 1):
        octaves.append(imops.avg_pool_2_u8values_f32(octaves[-1]))
    return octaves


def _level_channels(oct_image: jax.Array, level: Level, shrink: int, smooth: int,
                    cf: ChannelFunction) -> jax.Array:
    im = imops.resize_bilinear(oct_image, level.height, level.width)
    chns = cf(im)
    if shrink == 2:
        chns = imops.avg_pool_2(chns)
    if smooth == 1:
        chns = imops.smooth_3x3(chns)
    return chns


def compute_pyramid(image: jax.Array, channel_opts: dict) -> List[Tuple[jax.Array, float]]:
    """Compute every pyramid level's channel tensor (CHW) on device.

    Returns a list of ``(chns, scale)`` with ``chns`` of static shape
    ``(C, out_height, out_width)``.  Call under ``jax.jit`` (the shapes are a
    pure function of ``image.shape`` and the opts).
    """
    shrink, n_per_oct, smooth, cf = _normalize_opts(channel_opts)
    h, w = image.shape[-2], image.shape[-1]
    plan = pyramid_plan(h, w, shrink, n_per_oct)
    if not plan:
        return []
    n_octaves = plan[-1].octave + 1
    octaves = _compute_octaves(image, n_octaves)
    out = []
    for level in plan:
        chns = _level_channels(octaves[level.octave], level, shrink, smooth, cf)
        out.append((chns, level.scale))
    return out


@functools.partial(jax.jit, static_argnames=("shrink", "n_per_oct", "smooth", "cf"))
def _pyramid_jit(image, shrink, n_per_oct, smooth, cf):
    opts = dict(shrink=shrink, n_per_oct=n_per_oct, smooth=smooth, channels=cf)
    return [c for c, _ in compute_pyramid(image, opts)]


def channel_pyramid(image, channel_opts: dict):
    """Generator of ``(chns_hwc, scale)`` per pyramid level — public API parity
    with /root/reference/waldboost/channels.py:111-146.

    ``image`` must be a 2-D array.  Channels are returned as (H, W, C) numpy
    arrays (the device pipeline is CHW internally).
    """
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError("Image must have 2 dimensions")
    shrink, n_per_oct, smooth, cf = _normalize_opts(channel_opts)
    plan = pyramid_plan(image.shape[0], image.shape[1], shrink, n_per_oct)
    chns_list = _pyramid_jit(jnp.asarray(image), shrink, n_per_oct, smooth, cf)
    for level, chns in zip(plan, chns_list):
        yield np.transpose(np.asarray(chns), (1, 2, 0)), level.scale
