"""Exact-arithmetic device numerics: rational bilinear resize and
f64-replicating oriented projections, in f32/int32 ops only.

Why this module exists
----------------------

The north-star contract is *detections identical to the CPU reference*.  Two
operations in the channel pipeline are not naively reproducible in device
f32:

1. **uint8 bilinear resize** (/root/reference/waldboost/channels.py:132):
   ``resize(...).astype(uint8)`` truncates the interpolated value.  The
   bilinear taps for ``n_in -> n_out`` are exact rationals with denominator
   ``2*n_out``, so the interpolated value is ``N / D`` with an exact integer
   numerator; whenever ``N`` is a multiple of ``D`` the truncation sits on an
   exact integer and any finite-precision lerp resolves it by rounding luck.
   This module computes ``floor(N / D)`` *exactly* (no epsilon nudges, no
   ties): the per-axis tap numerators are integers, the 4-corner combine is
   evaluated in f32 where products stay below 2^24 and in int32 beyond, and
   the final floor comes from an integer comparison.

2. **grad_hist projections** (/root/reference/waldboost/channels.py:40-52):
   under NumPy >= 2 (NEP 50), ``gx * c - gy * s`` promotes the f32 gradient
   arrays with the f64 cos/sin scalars to f64 and the store rounds once to
   f32, so the reference channel value is ``f32(f64-evaluated gx*c - gy*s)``.
   For uint8 images the gradients are *integers* (|g| <= 1020), so the exact
   real value ``E = gx*c - gy*s`` lives on a lattice small enough to verify
   exhaustively.  :func:`projection_plan` builds, per bin, the cheapest f32
   expression (split the f64 constant into <=12-bit chunks so products with
   <=12-bit integers are exact; fold shared chunks through ``gx - gy`` /
   ``gx + gy``; Fast2Sum the descending chain) whose output equals the
   reference's f32 store for **every** reachable integer pair — brute-force
   verified on the full (2*gmax+1)^2 lattice at plan-build time.  The single
   documented exception is the exact-cancellation line (e.g. gx == gy for
   the pi/4 bin, where cos/sin differ by one f64 ulp): there both sides are
   < 2^-40 in magnitude (value-identical to zero for every downstream
   purpose) but carry different bits; the plan records that exception set.

All device helpers here are pure jnp expressions over f32/int32, usable both
in XLA-traced code and inside Pallas kernels.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "axis_taps_exact",
    "combine_kind",
    "floordiv_exact",
    "floordiv_exact_rt",
    "combine4_exact",
    "projection_plan",
    "project_bins",
    "ProjectionPlan",
    "resize_exact_matmul_rt",
    "resize_lerp_rt",
]


# ---------------------------------------------------------------------------
# Exact per-axis resize taps
# ---------------------------------------------------------------------------

def axis_taps_exact(n_in: int, n_out: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Exact rational taps of skimage's order-1 resize for ``n_in -> n_out``.

    The reference's coordinate for output index k is
    ``c_k = (k + 0.5) * n_in / n_out - 0.5`` clipped to ``[0, n_in - 1]``
    (= ``((2k+1)*n_in - n_out) / (2*n_out)``), ``i0 = min(floor(c), n_in-2)``
    and ``frac = c - i0`` (/root/reference/waldboost/channels.py:132 via
    skimage; tests/refshims/skimage implements the same convention).

    Returns ``(i0 int32[n_out], fnum int32[n_out], den int)`` with
    ``frac_k = fnum[k] / den`` exactly; ``den`` is reduced by the gcd of all
    numerators (identity axes collapse to den == 1, fnum == 0).
    """
    k = np.arange(n_out, dtype=np.int64)
    den = 2 * n_out
    c_num = (2 * k + 1) * n_in - n_out          # coordinate * den, exact
    c_num = np.clip(c_num, 0, (n_in - 1) * den)
    if n_in > 1:
        i0 = np.minimum(c_num // den, n_in - 2)
    else:
        i0 = np.zeros_like(c_num)
    fnum = c_num - i0 * den                      # in [0, den]
    # normalize frac == 1 (the i0 <= n_in-2 clamp at exact-integer edge
    # coordinates) into the base index: value-identical (the weight moves
    # wholly to the i0+1 corner) and establishes den == 1 <=> identity axis
    one = fnum == den
    if one.any():
        i0 = np.where(one, np.minimum(i0 + 1, n_in - 1), i0)
        fnum = np.where(one, 0, fnum)
    g = math.gcd(den, int(np.gcd.reduce(fnum)) if n_out else den)
    if g > 1:
        fnum //= g
        den //= g
    assert den <= 1 << 15, (n_in, n_out, den)    # f32-exactness headroom
    return i0.astype(np.int32), fnum.astype(np.int32), int(den)


def combine_kind(den_r: int, den_c: int, vmax: int = 255) -> str:
    """Static choice of the exact 4-corner combine implementation."""
    if den_r == 1 and den_c == 1:
        return "identity"
    if den_c == 1:
        return "row_only"
    if den_r == 1:
        return "col_only"
    if (vmax + 1) * den_r * den_c < (1 << 24):
        return "f24"  # numerator exact in f32: no int32 anywhere
    if vmax * den_r * den_c < (1 << 31) - (1 << 16):
        return "i32"
    return "split"


def floordiv_exact(a: jax.Array, den: int) -> jax.Array:
    """``floor(a / den)`` for integer-valued f32 ``a`` with ``a < 2**24`` and
    ``den <= 2**15``: reciprocal multiply (off by at most one) plus an exact
    f32 integer fixup in both directions."""
    if den == 1:
        return a
    denf = jnp.float32(den)
    q0 = jnp.floor(a * jnp.float32(1.0 / den))
    q0 = q0 + jnp.where((q0 + 1.0) * denf <= a, jnp.float32(1.0),
                        jnp.float32(0.0)) \
        - jnp.where(q0 * denf > a, jnp.float32(1.0), jnp.float32(0.0))
    return q0


def combine4_exact(g00, g01, g10, g11, frn, fcn, den_r: int, den_c: int,
                   vmax: int = 255):
    """Exact ``floor`` of the bilinear 4-corner combine.

    ``g..``: integer-valued f32 corners (g[row corner][col corner]), values
    in ``[0, vmax]``.  ``frn`` / ``fcn``: f32 integer row/col frac numerators
    (broadcastable against the corners) over the static denominators
    ``den_r`` / ``den_c`` from :func:`axis_taps_exact`.  Returns f32 integers
    == ``floor((wr0*wc0*g00 + wr0*wc1*g01 + wr1*wc0*g10 + wr1*wc1*g11) /
    (den_r*den_c))`` computed in exact arithmetic (``wr0 = den_r - frn``,
    ``wr1 = frn`` etc.).

    Implementation is chosen statically by :func:`combine_kind`:
    ``identity`` -> g00; single-axis -> one exact floordiv; ``i32`` (any
    pyramid level up to ~FHD per-level sizes) -> exact int32 numerator plus
    an f32 quotient candidate fixed up by integer comparison; ``split``
    (very large levels) -> per-axis quotient/remainder split keeping every
    f32 quantity < 2^24 and every int32 quantity < 2^31.
    """
    kind = combine_kind(den_r, den_c, vmax)
    if kind == "identity":
        return g00
    if kind == "row_only":
        a = (jnp.float32(den_r) - frn) * g00 + frn * g10
        return floordiv_exact(a, den_r)
    if kind == "col_only":
        a = (jnp.float32(den_c) - fcn) * g00 + fcn * g01
        return floordiv_exact(a, den_c)

    wr0 = jnp.float32(den_r) - frn
    a = wr0 * g00 + frn * g10          # exact: <= vmax * den_r < 2^23
    b = wr0 * g01 + frn * g11
    return floor_colstage(a, b, fcn, den_r, den_c, vmax)


def floor_colstage(a, b, fcn, den_r: int, den_c: int, vmax: int = 255):
    """``floor((wc0*a + fcn*b) / (den_r*den_c))`` for exact integer-valued
    f32 row numerators ``a``/``b`` (<= vmax*den_r) — the second half of
    :func:`combine4_exact`, exposed for callers whose row combine already
    happened exactly elsewhere (e.g. integer-weighted selector matmuls,
    whose <=256 weights and <=255 pixels multiply exactly into the f32
    accumulator)."""
    kind = combine_kind(den_r, den_c, vmax)
    if kind in ("identity", "row_only"):
        return floordiv_exact(a, den_r)
    if kind == "col_only":
        wc0 = jnp.float32(den_c) - fcn
        return floordiv_exact(wc0 * a + fcn * b, den_c)
    wc0 = jnp.float32(den_c) - fcn
    D = den_r * den_c

    if kind == "f24":
        # gcd-reduced pyramid denominators are usually small enough that the
        # full numerator stays f32-exact — everything in f32, no converts
        N = wc0 * a + fcn * b          # exact: <= vmax * D < 2^24
        k0 = jnp.floor(N * jnp.float32(1.0 / D))   # off by at most one
        t = k0 * jnp.float32(D)                    # exact (k0 <= vmax)
        one = jnp.float32(1.0)
        zero = jnp.float32(0.0)
        return k0 + jnp.where(t + jnp.float32(D) <= N, one, zero) \
            - jnp.where(t > N, one, zero)

    if kind == "i32":
        ai = a.astype(jnp.int32)
        bi = b.astype(jnp.int32)
        wc0i = wc0.astype(jnp.int32)
        wc1i = fcn.astype(jnp.int32)
        N = wc0i * ai + wc1i * bi      # exact: <= vmax * D < 2^31
        v_ap = (wc0 * a + fcn * b) * jnp.float32(1.0 / D)
        k0 = jnp.floor(v_ap)           # off by at most one
        t = k0.astype(jnp.int32) * np.int32(D)
        one = jnp.float32(1.0)
        zero = jnp.float32(0.0)
        return k0 + jnp.where(t + np.int32(D) <= N, one, zero) \
            - jnp.where(t > N, one, zero)

    # split: den_r*den_c too large for a direct int32 numerator
    qa = floordiv_exact(a, den_r)
    ra = a - qa * jnp.float32(den_r)
    qb = floordiv_exact(b, den_r)
    rb = b - qb * jnp.float32(den_r)
    P = wc0 * qa + fcn * qb            # exact: <= vmax * den_c < 2^23
    q1 = floordiv_exact(P, den_c)
    r1 = P - q1 * jnp.float32(den_c)
    wc0i = wc0.astype(jnp.int32)
    wc1i = fcn.astype(jnp.int32)
    R = wc0i * ra.astype(jnp.int32) + wc1i * rb.astype(jnp.int32)
    T = r1.astype(jnp.int32) * np.int32(den_r) + R   # < 2 * D < 2^31
    return q1 + jnp.where(T >= np.int32(D), jnp.float32(1.0),
                          jnp.float32(0.0))


# ---------------------------------------------------------------------------
# Exact oriented projections (grad_hist bins)
# ---------------------------------------------------------------------------

#: term kinds: which integer base the (exactly representable) coefficient
#: multiplies — gx, gy, gx - gy, or gx + gy
_BASES = ("x", "y", "d", "e")


class ProjectionPlan:
    """Static per-channel-function projection plan (hashable).

    ``bins``: per bin, a tuple of ``(base, coeff)`` terms, |coeff|
    descending; the bin value is the Fast2Sum-compensated f32 sum of the
    exact products, equal to ``f32(gx*cos - gy*sin)`` as evaluated by the
    reference's f64 NumPy path for every integer pair within ``gmax`` —
    except on ``exception_bins``'s exact-cancellation line, where both
    sides are below ``tiny_bound`` in magnitude (verified exhaustively at
    build time, see :func:`projection_plan`).
    """

    def __init__(self, bins, gmax: int, exceptions, tiny_bound: float):
        # per bin: (mode, terms) — mode "plain" (left-to-right f32 sums) or
        # "f2s" (Fast2Sum-compensated), whichever cheapest verified
        self.bins = tuple(
            (str(mode), tuple((str(b), float(c)) for b, c in terms))
            for mode, terms in bins)
        self.gmax = int(gmax)
        #: per bin: number of lattice points where the reference's f64 path
        #: disagrees (all on exact-cancellation lines, all below tiny_bound)
        self.exceptions = tuple(int(e) for e in exceptions)
        self.tiny_bound = float(tiny_bound)

    def key(self):
        return (self.bins, self.gmax, self.exceptions, self.tiny_bound)

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, ProjectionPlan) and self.key() == other.key()

    def __repr__(self):
        return (f"ProjectionPlan(bins={len(self.bins)}, gmax={self.gmax}, "
                f"exceptions={self.exceptions})")


def _chunks_12bit(x: float, n: int) -> List[float]:
    """Split ``x`` into ``n`` trunc-toward-zero chunks of <= 12 mantissa
    bits each (descending magnitude; products with <= 12-bit integers are
    f32-exact)."""
    out = []
    r = float(x)
    for _ in range(n):
        if r == 0.0:
            break
        m, e = math.frexp(r)
        c = math.ldexp(math.trunc(m * 4096.0), e - 12)
        out.append(c)
        r -= c
    return out


def _fold_terms(c: float, s: float, n_chunks: int):
    """Terms for ``gx*c - gy*s`` with exact products and shared-structure
    folding.  Prefers the algebraic rewrites ``c = s + delta`` (->
    ``(gx-gy)*s + gx*delta``) and ``c = -s + delta`` (-> ``(gx+gy)*c -
    gy*delta``) when ``delta`` itself has <= 12 mantissa bits."""
    def nbits(v: float) -> int:
        if v == 0.0:
            return 0
        m = abs(math.frexp(v)[0]) * 2.0
        bits = 0
        while m != math.trunc(m) and bits < 64:
            m *= 2.0
            bits += 1
        return bits + 1

    terms: List[Tuple[str, float]] = []
    delta = c - s
    delta_e = c + s
    if s != 0.0 and delta != 0.0 and abs(delta) < abs(s) * 1e-12 \
            and nbits(delta) <= 12:
        # gx*c - gy*s = (gx - gy)*s + gx*(c - s)
        for ch in _chunks_12bit(s, n_chunks):
            terms.append(("d", ch))
        terms.append(("x", delta))
        return terms
    if s != 0.0 and delta_e != 0.0 and abs(delta_e) < abs(s) * 1e-12 \
            and nbits(delta_e) <= 12:
        # gx*c - gy*s = (gx + gy)*c - gy*(c + s)
        for ch in _chunks_12bit(c, n_chunks):
            terms.append(("e", ch))
        terms.append(("y", -delta_e))
        return terms
    if c == s:
        for ch in _chunks_12bit(c, n_chunks):
            terms.append(("d", ch))
        return terms
    if c == -s:
        for ch in _chunks_12bit(c, n_chunks):
            terms.append(("e", ch))
        return terms
    ca = _chunks_12bit(c, n_chunks)
    sa = _chunks_12bit(s, n_chunks)
    for i in range(max(len(ca), len(sa))):
        cc = ca[i] if i < len(ca) else 0.0
        ss = sa[i] if i < len(sa) else 0.0
        if cc == ss and cc != 0.0:
            terms.append(("d", cc))
        elif cc == -ss and cc != 0.0:
            terms.append(("e", cc))
        else:
            if cc != 0.0:
                terms.append(("x", cc))
            if ss != 0.0:
                terms.append(("y", -ss))
    terms.sort(key=lambda t: -abs(t[1]))
    return terms


def _eval_terms_np(terms, gx, gy, mode="f2s"):
    """Reference f32 simulation of :func:`_eval_terms_jnp` (NumPy f32 ops
    are IEEE round-to-nearest, same as the device)."""
    f32 = np.float32
    base = {"x": gx, "y": gy, "d": gx - gy, "e": gx + gy}
    shape = np.broadcast(gx, gy).shape
    prods = [(base[b] * f32(cf)).astype(f32) for b, cf in terms]
    if not prods:
        return np.zeros(shape, f32)
    # single-base plans (e.g. terms == [('y', -1)]) keep that base's
    # broadcast shape; normalize to the full lattice shape
    prods = [np.broadcast_to(p, shape) for p in prods]
    h = prods[0]
    ncomp = {"plain": 0, "f2s1": 1, "f2s2": 2}.get(mode, len(prods))
    errs = None
    for t, p in enumerate(prods[1:]):
        s = (h + p).astype(f32)
        if t < ncomp:
            e = (p - (s - h)).astype(f32)
            errs = e if errs is None else (errs + e).astype(f32)
        h = s
    return h if errs is None else (h + errs).astype(f32)


def _eval_terms_jnp(terms, gx, gy, mode="f2s"):
    """Exact-product chain in f32: ``plain`` left-to-right sums when the
    exhaustive verification accepts them, Fast2Sum-compensated otherwise."""
    base = {"x": lambda: gx, "y": lambda: gy,
            "d": lambda: gx - gy, "e": lambda: gx + gy}
    cache = {}

    def get(b):
        if b not in cache:
            cache[b] = base[b]()
        return cache[b]

    prods = []
    for b, cf in terms:
        v = get(b)
        prods.append(v if cf == 1.0 else (-v if cf == -1.0
                                          else v * jnp.float32(cf)))
    shape = jnp.broadcast_shapes(gx.shape, gy.shape)
    if not prods:
        return jnp.zeros(shape, jnp.float32)
    # single-base plans keep that base's shape; normalize only when needed
    # (statically resolved — full-shape inputs, e.g. in the kernels, pay
    # nothing)
    prods = [p if p.shape == shape else jnp.broadcast_to(p, shape)
             for p in prods]
    h = prods[0]
    ncomp = {"plain": 0, "f2s1": 1, "f2s2": 2}.get(mode, len(prods))
    errs = None
    for t, p in enumerate(prods[1:]):
        s = h + p
        if t < ncomp:
            e = p - (s - h)
            errs = e if errs is None else errs + e
        h = s
    return h if errs is None else h + errs


@functools.lru_cache(maxsize=32)
def projection_plan(n_bins: int = 4, full: bool = False,
                    gmax: int = 1020) -> Optional[ProjectionPlan]:
    """Build + exhaustively verify the exact projection plan for grad_hist.

    The reference computes ``chns[..., i] = gx*c - gy*s`` with f32 integer
    gradient arrays and f64 cos/sin scalars — f64 evaluation, one f32 store
    (NumPy >= 2 promotion; /root/reference/waldboost/channels.py:48-50).
    For every bin this builds the folded-chunk f32 chain and verifies it
    against that exact semantic over the FULL integer lattice
    ``[-gmax, gmax]^2`` (trying 2..5 chunks, keeping the cheapest that
    matches).  Mismatches are tolerated only where |both sides| < 2^-40
    (exact-cancellation lines, counted in ``plan.exceptions``).  Returns
    None if any bin cannot be verified (callers fall back to the legacy
    f32 path and parity stays at the documented f32 deviation).
    """
    max_theta = 2 * np.pi if full else np.pi
    theta = np.linspace(0, max_theta, n_bins + 1)[:-1]
    cs, sn = np.cos(theta), np.sin(theta)

    g = np.arange(-gmax, gmax + 1, dtype=np.float64)
    gx64 = g[:, None]
    gy64 = g[None, :]
    gx32 = gx64.astype(np.float32)
    gy32 = gy64.astype(np.float32)
    tiny = 2.0 ** -40

    bins = []
    exceptions = []

    def cost(mode, n_terms):
        # VPU op estimate: products + 3 per compensated add + 1 per plain
        # add (+1 folding the error term back in)
        ncomp = {"plain": 0, "f2s1": 1, "f2s2": 2}.get(mode, n_terms - 1)
        ncomp = min(ncomp, max(n_terms - 1, 0))
        return n_terms + 3 * ncomp + (n_terms - 1 - ncomp) \
            + (1 if ncomp else 0)

    # cheapest verified evaluation wins: plain left-to-right sums beat
    # compensated chains ~2x in elementwise ops when the lattice accepts
    # them.  (Dropping the sub-2^-42 fold-delta terms also verifies, but
    # the full verified chains are kept.)
    for c, s in zip(cs, sn):
        ref = (gx64 * c - gy64 * s).astype(np.float32)
        candidates = []
        seen = set()
        for n_chunks in (1, 2, 3, 4, 5):
            terms = _fold_terms(float(c), float(s), n_chunks)
            key = tuple(terms)
            if not terms or key in seen:
                continue
            seen.add(key)
            for mode in ("plain", "f2s1", "f2s2", "f2s"):
                candidates.append((cost(mode, len(terms)), mode, terms))
        candidates.sort(key=lambda x: x[0])
        chosen = None
        n_exc = 0
        for _, mode, terms in candidates:
            got = _eval_terms_np(terms, gx32, gy32, mode)
            neq = got != ref
            if not neq.any():
                chosen, n_exc = (mode, terms), 0
                break
            bad = neq & ~((np.abs(got) < tiny) & (np.abs(ref) < tiny))
            if not bad.any():
                chosen, n_exc = (mode, terms), int(neq.sum())
                break
        if chosen is None:
            return None
        bins.append(chosen)
        exceptions.append(n_exc)
    return ProjectionPlan(bins, gmax, exceptions, tiny)


def project_bins(gx: jax.Array, gy: jax.Array,
                 plan: ProjectionPlan) -> List[jax.Array]:
    """Per-bin exact f32 projections ``f32(gx*cos_k - gy*sin_k)`` of
    integer-valued f32 gradients (pre-abs / pre-bias values)."""
    return [_eval_terms_jnp(terms, gx, gy, mode)
            for mode, terms in plan.bins]


# ---------------------------------------------------------------------------
# Exact resize as matmuls (canvas path)
# ---------------------------------------------------------------------------

def _weight_matrix(i0: np.ndarray, wnum: np.ndarray, n_in: int) -> jax.Array:
    """(n_out, n_in) matrix with integer weights ``den - wnum`` at ``i0`` and
    ``wnum`` at ``min(i0+1, n_in-1)`` — materialized on device from the tap
    vectors (dense host constants would bloat the program at 4K)."""
    i0 = jnp.asarray(np.maximum(i0, 0), jnp.int32)
    i1 = jnp.minimum(i0 + 1, n_in - 1)
    cols = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    return jnp.where(cols == i0[:, None], wnum[0][:, None], 0.0) \
        + jnp.where(cols == i1[:, None], wnum[1][:, None], 0.0)


def resize_exact_matmul(x: jax.Array, taps_r, taps_c,
                        vmax: int = 255) -> jax.Array:
    """Exact ``floor`` bilinear resize of an integer-valued f32 image via
    HIGHEST-precision matmuls (integer weights stay exact in the f32
    accumulator below 2^24) plus an elementwise quotient/remainder split.
    ``taps_*``: ``(i0, fnum, den)`` from :func:`axis_taps_exact`."""
    i0r, fnr, den_r = taps_r
    i0c, fnc, den_c = taps_c
    if den_r == 1 and den_c == 1 and len(i0r) == x.shape[-2] \
            and len(i0c) == x.shape[-1]:
        return x  # identity level: all fracs zero at the source size
    hi = jax.lax.Precision.HIGHEST
    fnr_d = jnp.asarray(fnr, jnp.float32)
    fnc_d = jnp.asarray(fnc, jnp.float32)
    Rh = _weight_matrix(i0r, (jnp.float32(den_r) - fnr_d, fnr_d),
                        x.shape[-2])
    Rw = _weight_matrix(i0c, (jnp.float32(den_c) - fnc_d, fnc_d),
                        x.shape[-1])
    A = jnp.matmul(Rh, x, precision=hi)            # <= vmax*den_r, exact
    if den_r == 1:
        qa, ra = A, None
    else:
        qa = floordiv_exact(A, den_r)
        ra = A - qa * jnp.float32(den_r)
    P = jnp.matmul(qa, Rw.T, precision=hi)         # <= vmax*den_c, exact
    q1 = floordiv_exact(P, den_c)
    if ra is None:
        return q1
    r1 = P - q1 * jnp.float32(den_c)
    D = den_r * den_c
    if 2 * D < (1 << 24):
        R = jnp.matmul(ra, Rw.T, precision=hi)     # < den_c*den_r, exact
        T = r1 * jnp.float32(den_r) + R            # < 2*D, exact f32
        return q1 + jnp.where(T >= jnp.float32(D), jnp.float32(1.0),
                              jnp.float32(0.0))
    # large levels: split the remainder so each matmul stays < 2^23, then
    # recombine + compare in int32
    S = max((1 << 23) // den_c, 1)
    ra_hi = floordiv_exact(ra, S)
    ra_lo = ra - ra_hi * jnp.float32(S)
    R_hi = jnp.matmul(ra_hi, Rw.T, precision=hi)
    R_lo = jnp.matmul(ra_lo, Rw.T, precision=hi)
    R = R_hi.astype(jnp.int32) * np.int32(S) + R_lo.astype(jnp.int32)
    T = r1.astype(jnp.int32) * np.int32(den_r) + R
    return q1 + jnp.where(T >= np.int32(D), jnp.float32(1.0),
                          jnp.float32(0.0))


# ---------------------------------------------------------------------------
# Runtime-geometry exact resize (true-size serving inside shape buckets)
# ---------------------------------------------------------------------------

def floordiv_exact_rt(a: jax.Array, den: jax.Array) -> jax.Array:
    """:func:`floordiv_exact` with a TRACED integer-valued f32 divisor.

    Valid whenever ``a`` is an exact integer in f32, ``den <= 2**15`` and the
    quotient is ``< 2**8`` (the resize-combine regime): the f32 reciprocal is
    correctly rounded, so ``a * (1/den)`` is off by well under one and the
    two integer-comparison fixups (exact products: ``q <= 2^8``,
    ``den <= 2^15``) resolve the floor exactly.  ``den == 1`` degenerates to
    the identity (reciprocal is exactly 1.0)."""
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    q0 = jnp.floor(a * (one / den))
    return q0 + jnp.where((q0 + one) * den <= a, one, zero) \
        - jnp.where(q0 * den > a, one, zero)


def _weight_matrix_rt(i0: jax.Array, i1: jax.Array, w0: jax.Array,
                      w1: jax.Array, n_in: int) -> jax.Array:
    """(n_out, n_in) two-tap matrix from TRACED tap vectors: weight ``w0`` at
    column ``i0`` plus ``w1`` at column ``i1`` (weights add when the taps
    coincide, matching ops.warp.build_resize_matrix's ``+=``)."""
    cols = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    return jnp.where(cols == i0[:, None], w0[:, None], 0.0) \
        + jnp.where(cols == i1[:, None], w1[:, None], 0.0)


def resize_exact_matmul_rt(x: jax.Array, taps_r, taps_c,
                           vmax: int = 255) -> jax.Array:
    """Runtime-geometry form of :func:`resize_exact_matmul`.

    Every tap quantity is a TRACED array, so ONE compiled program serves any
    source/target geometry — the true-size bucketed serving path
    (parallel.bucket).  ``taps_* = (i0, i1, fnum, den)``: int32[n_out] base /
    neighbour source indices (clamps precomputed on host), f32[n_out]
    integer-valued frac numerators, and a traced f32 scalar denominator
    (gcd-reduced, ``<= 2**15``, ``== 1`` on identity axes).  Output rows/cols
    beyond the real target extent may carry arbitrary (finite) taps — their
    values are garbage-by-design and masked downstream; source columns beyond
    the tap range get zero weight, so content outputs are bitwise equal to
    the static :func:`resize_exact_matmul` at the real geometry (both compute
    the same exact integer floor).

    Traced denominators preclude the static kind specialization, so this uses
    one universal schedule — the quotient/remainder split with a static
    ``S=256`` remainder split — whose bounds hold for EVERY den pair
    ``<= 2**15``: each f32 matmul accumulation stays ``< 2**23`` (exact) and
    each int32 recombine ``< 2**31``."""
    i0r, i1r, fnr, den_r = taps_r
    i0c, i1c, fnc, den_c = taps_c
    hi = jax.lax.Precision.HIGHEST
    Rh = _weight_matrix_rt(i0r, i1r, den_r - fnr, fnr, x.shape[-2])
    Rw = _weight_matrix_rt(i0c, i1c, den_c - fnc, fnc, x.shape[-1])
    A = jnp.matmul(Rh, x, precision=hi)        # <= vmax*den_r < 2^23, exact
    qa = floordiv_exact_rt(A, den_r)
    ra = A - qa * den_r                        # < den_r <= 2^15
    P = jnp.matmul(qa, Rw.T, precision=hi)     # <= vmax*den_c < 2^23, exact
    q1 = floordiv_exact_rt(P, den_c)
    r1 = P - q1 * den_c                        # < den_c
    ra_hi = floordiv_exact(ra, 256)            # < 2^7
    ra_lo = ra - ra_hi * jnp.float32(256.0)    # < 2^8
    R_hi = jnp.matmul(ra_hi, Rw.T, precision=hi)   # <= 128*den_c < 2^22
    R_lo = jnp.matmul(ra_lo, Rw.T, precision=hi)   # <= 255*den_c < 2^23
    R = R_hi.astype(jnp.int32) * np.int32(256) + R_lo.astype(jnp.int32)
    den_ri = den_r.astype(jnp.int32)
    D = den_ri * den_c.astype(jnp.int32)       # <= 2^30
    T = r1.astype(jnp.int32) * den_ri + R      # < 2*D <= 2^31 - 1
    return q1 + jnp.where(T >= D, jnp.float32(1.0), jnp.float32(0.0))


def resize_lerp_rt(x: jax.Array, taps_r, taps_c) -> jax.Array:
    """Runtime-geometry bilinear resize for FLOAT images: the same
    HIGHEST-precision einsum as the static float canvas path
    (model._channel_canvas_fast) with device-built two-tap matrices from
    traced ``(i0, i1, frac)`` vectors.  Content outputs are bitwise equal to
    the per-size path: each output reduces exactly two nonzero products per
    axis (f32 addition of the surrounding exact zeros is the identity)."""
    i0r, i1r, frr = taps_r
    i0c, i1c, frc = taps_c
    one = jnp.float32(1.0)
    Rh = _weight_matrix_rt(i0r, i1r, one - frr, frr, x.shape[-2])
    Rw = _weight_matrix_rt(i0c, i1c, one - frc, frc, x.shape[-1])
    return jnp.einsum("ah,hw,bw->ab", Rh, x, Rw,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
