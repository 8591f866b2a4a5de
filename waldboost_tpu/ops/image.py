"""Core image ops: separable convolution, pooling, smoothing, bilinear resize.

All functions operate on CHW (``(C, H, W)``) or HW arrays — channel-major is
the on-device layout of this framework: the last (contiguous) dimension is
image width, so row-wise stencils read contiguous memory.

Reference-semantics notes (these quirks are load-bearing for detection parity
with the CPU reference — see SURVEY.md §7 "hard parts"):

* ``avg_pool_2`` sums in the *input dtype* (so uint8 inputs wrap around mod
  256, exactly like the numba kernel at
  /root/reference/waldboost/channels.py:55-64), divides in float and
  truncate-casts back to the input dtype.
* ``smooth_3x3`` reproduces the numba ``@stencil`` boundary behaviour of
  /root/reference/waldboost/channels.py:78-90: output pixels whose 3x3
  neighbourhood leaves the image are 0.
* ``gradients`` uses scipy ``convolve1d``'s default *reflect* (symmetric)
  boundary and its convolution (kernel-flipping) orientation:
  ``D = [-1, 0, 1]`` yields ``out[i] = x[i-1] - x[i+1]``
  (/root/reference/waldboost/channels.py:16-21).
* ``resize_bilinear`` matches ``skimage.transform.resize(..., order=1,
  anti_aliasing=False, preserve_range=True)``: half-pixel-centre coordinate
  convention with edge clamping (/root/reference/waldboost/channels.py:132),
  followed by a truncating cast back to the input dtype.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "avg_pool_2",
    "max_pool_2",
    "smooth_3x3",
    "gradients",
    "separable_filter_reflect",
    "triangle_kernel",
    "resize_bilinear",
]


def _is_integer(dtype) -> bool:
    return jnp.issubdtype(dtype, jnp.integer)


def _pool_2(arr: jax.Array, init, op) -> jax.Array:
    """2x2/stride-2 reduce_window over the last two dims (odd edges dropped),
    one fused reduction instead of four strided slices."""
    dims = (1,) * (arr.ndim - 2) + (2, 2)
    return jax.lax.reduce_window(arr, init, op, dims, dims, "VALID")


def avg_pool_2(arr: jax.Array) -> jax.Array:
    """Non-overlapping 2x2 average pool over the last two (H, W) dims.

    Odd trailing rows/cols are dropped.  Sums are computed in the input dtype
    (uint8 wraps — reference parity), divided by 4 in float32, then
    truncate-cast back to the input dtype.

    Float inputs reproduce the reference's f32 summation association
    ``((TL + BL) + TR) + BR`` (the left-to-right numba expression at
    /root/reference/waldboost/channels.py:55-64) term for term — the order
    is observable for irrational channel values.  Integer inputs sum exactly
    under any association, so they keep the reduce_window path.
    """
    if _is_integer(arr.dtype):
        zero = jnp.zeros((), arr.dtype)
        dims_r = (1,) * (arr.ndim - 2) + (2, 1)
        dims_c = (1,) * (arr.ndim - 2) + (1, 2)
        s = jax.lax.reduce_window(arr, zero, jax.lax.add, dims_r, dims_r,
                                  "VALID")
        s = jax.lax.reduce_window(s, zero, jax.lax.add, dims_c, dims_c,
                                  "VALID")
        out = s.astype(jnp.float32) / 4.0
        return out.astype(arr.dtype)  # float->int converts toward zero
    h = (arr.shape[-2] // 2) * 2
    w = (arr.shape[-1] // 2) * 2
    x = arr[..., :h, :w]
    q = x.reshape(x.shape[:-2] + (h // 2, 2, w // 2, 2))
    tl = q[..., 0, :, 0]
    bl = q[..., 1, :, 0]
    tr = q[..., 0, :, 1]
    br = q[..., 1, :, 1]
    return ((((tl + bl) + tr) + br) / 4).astype(arr.dtype)


@functools.lru_cache(maxsize=None)
def _pair_sum_matrix(n: int, left: bool) -> np.ndarray:
    """0/1 matrix summing adjacent pairs: left form (n//2, n), right (n, n//2)."""
    P = np.zeros((n // 2, n), np.float32)
    idx = np.arange(n // 2)
    P[idx, 2 * idx] = 1.0
    P[idx, 2 * idx + 1] = 1.0
    return P if left else P.T.copy()


def avg_pool_2_u8_matmul(arr: jax.Array) -> jax.Array:
    """uint8 avg_pool_2 as two DEFAULT-precision matmuls — bit-identical to
    :func:`avg_pool_2`.

    uint8 values (<= 255) are exact in bf16 and pair sums are exact in the
    f32 accumulator; the mod-256 after each pass reproduces the reference's
    uint8 wraparound (/root/reference/waldboost/channels.py:55-64), and the
    (row pairs, then col pairs) order matches avg_pool_2's two-pass
    reduce_window association.
    """
    assert arr.dtype == jnp.uint8 and arr.ndim == 2
    h, w = (arr.shape[0] // 2) * 2, (arr.shape[1] // 2) * 2
    Pr = jnp.asarray(_pair_sum_matrix(h, True), jnp.bfloat16)
    Pc = jnp.asarray(_pair_sum_matrix(w, False), jnp.bfloat16)
    x = arr[:h, :w].astype(jnp.bfloat16)
    s = jnp.dot(Pr, x, preferred_element_type=jnp.float32)
    s = jnp.where(s >= 256.0, s - 256.0, s)  # u8 wrap (pair sums <= 510)
    s = jnp.dot(s.astype(jnp.bfloat16), Pc,
                preferred_element_type=jnp.float32)
    s = jnp.where(s >= 256.0, s - 256.0, s)
    return (s * 0.25).astype(jnp.uint8)


def avg_pool_2_u8values_f32(arr: jax.Array) -> jax.Array:
    """avg_pool_2 of a uint8-VALUED f32 image, staying f32 (no u8 casts).

    Value-identical to ``avg_pool_2`` on the uint8 original: pair sums are
    exact in f32/bf16 (<= 510), the reference's uint8 wraparound is the
    explicit mod-256 select, and the truncating /4 is a floor (values are
    non-negative).  Keeping the chain f32/bf16 drops two u8 conversions per
    octave plus the downstream upcast.
    """
    assert arr.ndim == 2
    h, w = (arr.shape[0] // 2) * 2, (arr.shape[1] // 2) * 2
    Pr = jnp.asarray(_pair_sum_matrix(h, True), jnp.bfloat16)
    Pc = jnp.asarray(_pair_sum_matrix(w, False), jnp.bfloat16)
    x = arr[:h, :w].astype(jnp.bfloat16)  # uint8-valued: exact
    s = jnp.dot(Pr, x, preferred_element_type=jnp.float32)
    s = jnp.where(s >= 256.0, s - 256.0, s)  # u8 wrap (pair sums <= 510)
    s = jnp.dot(s.astype(jnp.bfloat16), Pc,
                preferred_element_type=jnp.float32)
    s = jnp.where(s >= 256.0, s - 256.0, s)
    return jnp.floor(s * 0.25)


def max_pool_2(arr: jax.Array) -> jax.Array:
    """Non-overlapping 2x2 max pool over the last two dims (odd edges dropped).

    Mirrors /root/reference/waldboost/channels.py:67-75.
    """
    if _is_integer(arr.dtype):
        init = jnp.asarray(jnp.iinfo(arr.dtype).min, arr.dtype)
    else:
        init = jnp.asarray(-jnp.inf, arr.dtype)
    return _pool_2(arr, init, jax.lax.max)


def smooth_3x3(arr: jax.Array) -> jax.Array:
    """3x3 binomial ([1 2 1] x [1 2 1]) / 16 smoothing over the last two dims.

    Border pixels (where the 3x3 window leaves the image) are 0, matching the
    numba stencil default of /root/reference/waldboost/channels.py:78-90.
    The nine taps are summed in the stencil expression's left-to-right f32
    order (row-major, /root/reference/waldboost/channels.py:80-83) — the
    association is observable for irrational channel values.  Integer inputs
    compute exactly (values fit f32) and truncate-cast back.  Shifted adds:
    single-channel convs are a poor shape for a matrix unit.
    """
    dtype = arr.dtype
    work = arr.astype(jnp.float32)

    def at(dr, dc):
        return work[..., 1 + dr:work.shape[-2] - 1 + dr,
                    1 + dc:work.shape[-1] - 1 + dc]

    v = at(-1, -1) + 2.0 * at(-1, 0) + at(-1, 1) \
        + 2.0 * at(0, -1) + 4.0 * at(0, 0) + 2.0 * at(0, 1) \
        + at(1, -1) + 2.0 * at(1, 0) + at(1, 1)
    v = (v / 16.0).astype(dtype)
    pad = [(0, 0)] * (arr.ndim - 2) + [(1, 1), (1, 1)]
    return jnp.pad(v, pad)


def _pad_reflect(x: jax.Array, n: int, axis: int) -> jax.Array:
    """Symmetric ('reflect' in scipy.ndimage parlance) padding: d c b a | a b c d."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (n, n)
    return jnp.pad(x, pad, mode="symmetric")


def _conv1d_lastdims(x: jax.Array, kernel: np.ndarray, axis: int) -> jax.Array:
    """Correlate the (already padded) array with ``kernel`` along ``axis`` via
    shifted adds.  Kernel is a small static numpy vector; taps with weight 0
    are skipped and +-1/2 weights stay as adds, so XLA fuses everything into a
    single VPU loop."""
    k = len(kernel)
    out = None
    for j, wgt in enumerate(kernel):
        if wgt == 0:
            continue
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(j, x.shape[axis] - (k - 1 - j))
        term = x[tuple(sl)]
        if wgt != 1:
            term = term * jnp.asarray(wgt, x.dtype)
        out = term if out is None else out + term
    return out


def separable_filter_reflect(x: jax.Array, k0: np.ndarray, k1: np.ndarray | None = None) -> jax.Array:
    """Separable correlation with symmetric-reflect boundary over the last two
    dims; equivalent to scipy ``convolve1d(convolve1d(x, k0, axis=0), k1, axis=1)``
    with mode='reflect' for *symmetric* kernels (scipy flips the kernel; the
    callers here only use symmetric kernels via this entry point).
    Mirrors ``separable_convolve`` at /root/reference/waldboost/channels.py:24-27.
    """
    k1 = k0 if k1 is None else k1
    h = len(k0) // 2
    x = _pad_reflect(x, h, axis=-2)
    x = _conv1d_lastdims(x, np.asarray(k0, np.float32), axis=-2)
    h = len(k1) // 2
    x = _pad_reflect(x, h, axis=-1)
    x = _conv1d_lastdims(x, np.asarray(k1, np.float32), axis=-1)
    return x


def conv2d_exact(x: jax.Array, kern: np.ndarray) -> jax.Array:
    """(H, W) or (B, H, W) input x (O, 3, 3) kernels -> (O, H-2, W-2) /
    (B, O, H-2, W-2) VALID correlation at HIGHEST precision (a default f32
    conv may run in bf16 or TF32 passes)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    out = jax.lax.conv_general_dilated(
        x[:, None], jnp.asarray(kern[:, None]), window_strides=(1, 1),
        padding="VALID", dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    return out[0] if squeeze else out


# correlation kernels of the reference's smoothed gradients
# (scipy convolve1d flips [-1,0,1] -> x[i-1]-x[i+1]):
GRAD_KX = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
GRAD_KY = GRAD_KX.T.copy()


def triangle_kernel(n: int) -> np.ndarray:
    """Normalized triangle kernel, /root/reference/waldboost/channels.py:11-13."""
    H = (np.concatenate([np.arange(n + 1), np.arange(n - 1, -1, -1)]) + 1).astype(np.float32)
    return H / H.sum()


def gradients(image: jax.Array,
              float_dd: bool = False) -> tuple[jax.Array, jax.Array]:
    """Smoothed image gradients, matching
    /root/reference/waldboost/channels.py:16-21 exactly:

        gy = conv1d(conv1d(im, [1,2,1], axis=1), [-1,0,1], axis=0)
        gx = conv1d(conv1d(im, [1,2,1], axis=0), [-1,0,1], axis=1)

    where scipy's convolve1d flips the kernel, so the derivative tap computes
    ``x[i-1] - x[i+1]``; boundary mode is symmetric reflect.  Input: (H, W)
    float32.  Returns (gx, gy).
    """
    image = image.astype(jnp.float32)
    # [1,2,1] prefilter: scipy.ndimage accumulates in FLOAT64 and rounds
    # once at the f32 store; with ``float_dd`` the 3-term sum computes
    # error-free and rounds once (ops.dd) — for float-image content, where
    # the two-rounding f32 chain deviated (part of round-4's ULP bound).
    # Integer-valued content keeps the plain chain (already exact, no dd
    # tax).  The derivative tap (x[i-1] - x[i+1]) is a single f32 subtract
    # — exact either way.
    conv = _conv121_dd if float_dd else _conv121_f32
    t = _pad_reflect(image, 1, axis=-1)
    t = conv(t, axis=-1)
    t = _pad_reflect(t, 1, axis=-2)
    gy = t[..., :-2, :] - t[..., 2:, :]  # x[i-1] - x[i+1]
    s = _pad_reflect(image, 1, axis=-2)
    s = conv(s, axis=-2)
    s = _pad_reflect(s, 1, axis=-1)
    gx = s[..., :, :-2] - s[..., :, 2:]
    return gx, gy


def _taps121(x: jax.Array, axis: int):
    if axis == -1:
        return x[..., :-2], x[..., 1:-1], x[..., 2:]
    return x[..., :-2, :], x[..., 1:-1, :], x[..., 2:, :]


def _conv121_f32(x: jax.Array, axis: int) -> jax.Array:
    a, b, c = _taps121(x, axis)
    return a + 2.0 * b + c


def _conv121_dd(x: jax.Array, axis: int) -> jax.Array:
    """Valid-mode [1,2,1] correlation along ``axis`` with scipy's f64
    accumulation semantics: the 3-term sum is computed error-free in f32
    pairs (2*b is exact; Knuth two_sum twice) and rounded ONCE."""
    from .dd import two_sum

    a, b, c = _taps121(x, axis)
    s1, e1 = two_sum(a, 2.0 * b)
    s2, e2 = two_sum(s1, c)
    return s2 + (e1 + e2)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _resize_bilinear_f32(image: jax.Array, nh: int, nw: int) -> jax.Array:
    h, w = image.shape[-2], image.shape[-1]
    if (nh, nw) == (h, w):
        return image.astype(jnp.float32)

    def axis_weights(n_in: int, n_out: int):
        # skimage/warp convention: out pixel k samples input (k+0.5)*in/out-0.5
        coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        coords = np.clip(coords, 0.0, n_in - 1.0)
        i0 = np.floor(coords).astype(np.int32)
        i0 = np.minimum(i0, n_in - 2) if n_in > 1 else np.zeros_like(i0)
        frac = (coords - i0).astype(np.float32)
        return i0, frac

    x = image.astype(jnp.float32)
    i0, fr = axis_weights(h, nh)
    if nh != h:
        top = jnp.take(x, i0, axis=-2)
        bot = jnp.take(x, np.minimum(i0 + 1, h - 1), axis=-2)
        frow = jnp.asarray(fr)[..., :, None]
        x = top * (1.0 - frow) + bot * frow
    j0, fc = axis_weights(w, nw)
    if nw != w:
        left = jnp.take(x, j0, axis=-1)
        right = jnp.take(x, np.minimum(j0 + 1, w - 1), axis=-1)
        fcol = jnp.asarray(fc)
        x = left * (1.0 - fcol) + right * fcol
    return x


@functools.partial(jax.jit, static_argnums=(1, 2))
def _resize_bilinear_exact_int(image: jax.Array, nh: int, nw: int) -> jax.Array:
    """Exact-arithmetic resize + floor for integer-valued images: the
    truncated bilinear value is ``floor(N / D)`` with an exact integer
    numerator (taps are rationals), computed via ops.exact.combine4_exact —
    no epsilon nudges, no float ties (PARITY.md §1)."""
    from .exact import axis_taps_exact, combine4_exact

    h, w = image.shape[-2], image.shape[-1]
    x = image.astype(jnp.float32)
    i0r, fnr, den_r = axis_taps_exact(h, nh)
    i0c, fnc, den_c = axis_taps_exact(w, nw)
    i1r = np.minimum(i0r + 1, h - 1)
    i1c = np.minimum(i0c + 1, w - 1)
    top = jnp.take(x, i0r, axis=-2)
    bot = jnp.take(x, i1r, axis=-2)
    g00 = jnp.take(top, i0c, axis=-1)
    g01 = jnp.take(top, i1c, axis=-1)
    g10 = jnp.take(bot, i0c, axis=-1)
    g11 = jnp.take(bot, i1c, axis=-1)
    frn = jnp.asarray(fnr, jnp.float32)[..., :, None]
    fcn = jnp.asarray(fnc, jnp.float32)
    return combine4_exact(g00, g01, g10, g11, frn, fcn, den_r, den_c)


def resize_bilinear(image: jax.Array, nh: int, nw: int) -> jax.Array:
    """Bilinear resize over the last two dims with skimage ``resize(order=1,
    anti_aliasing=False)`` semantics, followed by a truncating cast back to the
    input dtype (the reference does ``.astype(dtype)`` at
    /root/reference/waldboost/channels.py:132).  ``nh``/``nw`` are static.

    Integer dtypes: the truncated value is computed in EXACT arithmetic
    (integer tap numerators, one final floor — ops.exact.combine4_exact), so
    exact-integer interpolation ties resolve deterministically toward the
    exact result; the f64 reference shims and oracle adopt the same
    convention (PARITY.md §1).  Float dtypes keep the f32 lerp (the reference
    computes in f64 and keeps floats unrounded — documented deviation).
    """
    nh, nw = int(nh), int(nw)
    if _is_integer(image.dtype):
        if (nh, nw) == (image.shape[-2], image.shape[-1]):
            return image
        return _resize_bilinear_exact_int(image, nh, nw).astype(image.dtype)
    return _resize_bilinear_f32_dd(image, nh, nw).astype(image.dtype)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _resize_bilinear_f32_dd(image: jax.Array, nh: int, nw: int) -> jax.Array:
    """Float-image resize replicating the reference's FLOAT64 two-pass lerp
    (rounded once to f32) in double-float arithmetic: the row pass's
    UNROUNDED result feeds the column pass as an (hi, lo) pair, fracs are
    f64 constants pre-split, and one final add rounds — bitwise equal to
    ``f32(f64 chain)`` on the measured corpora (ops.dd; the round-4 f32
    lerp carried a 260-ULP bound here)."""
    from .dd import dd_const, dd_round, lerp_dd
    from .warp import resize_taps64

    h, w = image.shape[-2], image.shape[-1]
    x = (image.astype(jnp.float32),
         jnp.zeros(image.shape, jnp.float32))
    if nh != h:
        i0, fr = resize_taps64(h, nh)
        top = tuple(jnp.take(c, i0, axis=-2) for c in x)
        bot = tuple(jnp.take(c, np.minimum(i0 + 1, h - 1), axis=-2)
                    for c in x)
        sh = (-1, 1) if image.ndim == 2 else \
            (1,) * (image.ndim - 2) + (-1, 1)
        cs = [jnp.asarray(v.reshape(sh)) for v in
              (fr.astype(np.float32), (fr - fr.astype(np.float32))
               .astype(np.float32),
               (1.0 - fr).astype(np.float32),
               ((1.0 - fr) - (1.0 - fr).astype(np.float32))
               .astype(np.float32))]
        x = lerp_dd(top, bot, *cs)
    if nw != w:
        j0, fc = resize_taps64(w, nw)
        left = tuple(jnp.take(c, j0, axis=-1) for c in x)
        right = tuple(jnp.take(c, np.minimum(j0 + 1, w - 1), axis=-1)
                      for c in x)
        cs = [jnp.asarray(v) for v in
              (fc.astype(np.float32), (fc - fc.astype(np.float32))
               .astype(np.float32),
               (1.0 - fc).astype(np.float32),
               ((1.0 - fc) - (1.0 - fc).astype(np.float32))
               .astype(np.float32))]
        x = lerp_dd(left, right, *cs)
    return dd_round(x)
