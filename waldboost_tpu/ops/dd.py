"""Double-float (f32 pair) arithmetic for the float-image exact path.

The reference's float pipeline computes its resize lerp and its grad_hist
projection store in FLOAT64 and rounds once to the image dtype
(/root/reference/waldboost/channels.py:132 ``resize(...).astype(dtype)``;
:48-50 ``chns[...,i] = gx*c - gy*s`` — a NumPy-2 f64 promotion stored into
an f32 array).  This module evaluates those expressions without f64, in
UNEVALUATED f32 PAIRS (hi + lo, "double-float"): every
product of f32 operands is error-free (TwoProd), pair sums carry a
compensation term, and one final f32 add rounds the pair to the nearest
f32 — ~2^-47 relative accuracy vs f64's 2^-53, which rounds to the SAME
f32 except when the f64 chain lands within ~2^-47-relative of an f32
rounding boundary (measured: zero mismatches on the float golden corpus;
PARITY.md "Floating-point status").

IMPORTANT: under --xla_allow_excess_precision, f32->bf16->f32 round-trips
fold to no-ops.  Everything here uses pure f32 multiplies/adds (Veltkamp
splitting, no dtype round-trips), so no such folding applies.  The
algebra assumes each multiply and add rounds on its own: a compiler that
contracts ``a*b+c`` into one fused multiply-add, or reassociates, breaks
it (chip_smoke.py measures the GPU's float channels against the CPU's).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dd_const", "two_sum", "two_prod", "dd_add", "dd_mul_f32",
           "dd_mul", "dd_neg", "dd_round", "lerp_dd", "proj_dd"]

_SPLIT = np.float32(4097.0)  # Veltkamp split constant: 2^12 + 1


def dd_const(v) -> Tuple[np.float32, np.float32]:
    """Represent a python/np f64 scalar as an (hi, lo) f32 pair (48-bit)."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return hi, lo


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Veltkamp split of f32 into hi + lo with 12-bit halves (exact)."""
    c = _SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(x, y):
    """(hi, lo) + (hi, lo) -> (hi, lo); Dekker add2 (~2^-47 relative)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = two_sum(s, e)
    return hi, lo


def dd_neg(x):
    return -x[0], -x[1]


def dd_mul_f32(a, c):
    """f32 array/scalar ``a`` times dd ``c`` -> dd."""
    ch, cl = c
    p, e = two_prod(a, ch)
    e = e + a * cl
    hi, lo = two_sum(p, e)
    return hi, lo


def dd_mul(x, y):
    """dd * dd -> dd."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    hi, lo = two_sum(p, e)
    return hi, lo


def dd_round(x):
    """Round the pair to the nearest f32 (one f32 add of hi + lo)."""
    return x[0] + x[1]


def lerp_dd(top, bot, fr_hi, fr_lo, omfr_hi, omfr_lo):
    """One resize-axis lerp in dd: ``top * (1 - fr) + bot * fr``.

    ``top``/``bot``: dd pairs (pass (x, 0) for f32 inputs); the frac
    constants arrive pre-split (dd_const of the f64 ``fr`` and ``1 - fr``)
    broadcast to the output shape.  Matches the refshim's float branch
    expression order (tests/refshims/skimage: x[i0]*(1-fr) + x[i1]*fr).
    """
    t = dd_mul(top, (omfr_hi, omfr_lo))
    b = dd_mul(bot, (fr_hi, fr_lo))
    return dd_add(t, b)


def proj_dd(gx, gy, c, s):
    """grad_hist projection ``gx * c - gy * s`` in dd, rounded to f32.

    ``gx``/``gy`` f32 arrays; ``c``/``s`` f64 scalars (np.cos/np.sin of the
    bin angle).  Replicates the reference's NumPy-2 f64-promoted store
    (/root/reference/waldboost/channels.py:44-50) to ~2^-47."""
    a = dd_mul_f32(gx, dd_const(c))
    b = dd_mul_f32(gy, dd_const(s))
    return dd_round(dd_add(a, dd_neg(b)))
