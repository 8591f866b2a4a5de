"""Independent numpy/scipy oracle implementing the CPU reference's semantics.

Used as golden data for parity tests of the device implementation.  This mirrors
the *documented behaviour* of /root/reference/waldboost (scipy convolve1d
reflect-boundary gradients, skimage order-1/no-AA resize convention, numba
stencil zero borders, dtype-exact pooling), implemented independently so the
device code is checked against a second, separately-written program.
"""

import numpy as np
from scipy.ndimage import convolve1d


def triangle_kernel(n):
    H = (np.concatenate([np.arange(n + 1), np.arange(n - 1, -1, -1)]) + 1).astype("f")
    return H / H.sum()


def gradients(image):
    H = np.array([1, 2, 1], "f4")
    D = np.array([-1, 0, 1], "f4")
    gy = convolve1d(convolve1d(image, H, axis=1), D, axis=0)
    gx = convolve1d(convolve1d(image, H, axis=0), D, axis=1)
    return gx, gy


def separable_convolve(image, k0, k1=None):
    output = convolve1d(image, k0, axis=0)
    return convolve1d(output, k1 if k1 is not None else k0, axis=1)


def grad_mag(image, norm=5, eps=1e-3):
    gx, gy = gradients(image.astype("f"))
    mag = np.sqrt(gx ** 2 + gy ** 2)
    if norm is not None and norm > 1:
        H = triangle_kernel(norm)
        nrm = separable_convolve(mag, H)
        mag = mag / (nrm + eps)
    return mag[..., None]


def grad_hist(image, n_bins=4, full=False, bias=0):
    image = image.astype("f")
    gx, gy = gradients(image)
    max_theta = 2 * np.pi if full else np.pi
    theta = np.linspace(0, max_theta, n_bins + 1)
    cs, sn = np.cos(theta[:-1]), np.sin(theta[:-1])
    u, v = gx.shape
    chns = np.empty((u, v, n_bins), gx.dtype)
    for i, (c, s) in enumerate(zip(cs, sn)):
        chns[..., i] = gx * c - gy * s
    value = np.fmax(np.abs(chns) - bias, 0)
    return np.sign(chns) * value if full else value


def avg_pool_2(arr):
    u, v = arr.shape[0], arr.shape[1]
    ul, vl = u - u % 2, v - v % 2
    s = (arr[0:ul:2, 0:vl:2, ...] + arr[1:ul:2, 0:vl:2, ...]
         + arr[0:ul:2, 1:vl:2, ...] + arr[1:ul:2, 1:vl:2, ...])
    return (s / 4).astype(arr.dtype)


def max_pool_2(arr):
    u, v = arr.shape[0], arr.shape[1]
    ul, vl = u - u % 2, v - v % 2
    m0 = np.fmax(arr[0:ul:2, 0:vl:2, ...], arr[1:ul:2, 0:vl:2, ...])
    m1 = np.fmax(arr[0:ul:2, 1:vl:2, ...], arr[1:ul:2, 1:vl:2, ...])
    return np.fmax(m0, m1)


def smooth_image_3d(arr):
    """3x3 binomial/16; border rows/cols of the output are 0 (numba stencil
    default boundary).  Float inputs sum the nine taps in the stencil
    expression's left-to-right f32 order (the association is observable for
    irrational channel values); integer inputs compute exactly in int64."""
    out = np.zeros_like(arr)
    u, v = arr.shape[:2]
    is_int = np.issubdtype(arr.dtype, np.integer)
    work = arr.astype(np.int64) if is_int else arr.astype(np.float32)

    def at(dr, dc):
        return work[1 + dr:u - 1 + dr, 1 + dc:v - 1 + dc]

    s = at(-1, -1) + 2 * at(-1, 0) + at(-1, 1) \
        + 2 * at(0, -1) + 4 * at(0, 0) + 2 * at(0, 1) \
        + at(1, -1) + 2 * at(1, 0) + at(1, 1)
    interior = s / np.float32(16) if not is_int else s / 16
    if is_int:
        interior = interior.astype(arr.dtype)
    out[1:u - 1, 1:v - 1] = interior
    return out


def resize_bilinear(image, nh, nw):
    """skimage resize(order=1, anti_aliasing=False, preserve_range=True)
    semantics: half-pixel-centre sampling, edge clamped, truncate-cast back
    to the input dtype.  Integer images are interpolated in EXACT integer
    arithmetic (int64 tap numerators, one final floor division) so the
    truncation has no float ties — the same convention as the device
    (waldboost_tpu.ops.exact) and the reference shim (PARITY.md §1)."""
    h, w = image.shape
    if (nh, nw) == (h, w):
        return image.copy()

    def exact_axis(n_in, n_out):
        k = np.arange(n_out, dtype=np.int64)
        den = 2 * n_out
        c_num = np.clip((2 * k + 1) * n_in - n_out, 0, (n_in - 1) * den)
        i0 = np.minimum(c_num // den, n_in - 2) if n_in > 1 \
            else np.zeros_like(c_num)
        return i0, c_num - i0 * den, den

    if np.issubdtype(image.dtype, np.integer):
        x = image.astype(np.int64)
        i0, fr, den_r = exact_axis(h, nh)
        j0, fc, den_c = exact_axis(w, nw)
        a = (den_r - fr)[:, None] * x[i0, :] \
            + fr[:, None] * x[np.minimum(i0 + 1, h - 1), :]
        num = (den_c - fc)[None, :] * a[:, j0] \
            + fc[None, :] * a[:, np.minimum(j0 + 1, w - 1)]
        return (num // (den_r * den_c)).astype(image.dtype)

    x = image.astype("f8")

    def coords(n_in, n_out):
        c = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        c = np.clip(c, 0, n_in - 1)
        i0 = np.minimum(np.floor(c).astype(int), max(n_in - 2, 0))
        return i0, c - i0

    i0, fr = coords(h, nh)
    j0, fc = coords(w, nw)
    top = x[i0, :]
    bot = x[np.minimum(i0 + 1, h - 1), :]
    x = top * (1 - fr[:, None]) + bot * fr[:, None]
    left = x[:, j0]
    right = x[:, np.minimum(j0 + 1, w - 1)]
    x = left * (1 - fc[None, :]) + right * fc[None, :]
    return x.astype(image.dtype)


def channel_pyramid(image, channel_opts):
    """Reference channel_pyramid generator
    (/root/reference/waldboost/channels.py:111-146 semantics)."""
    shrink = channel_opts["shrink"]
    n_per_oct = channel_opts["n_per_oct"]
    smooth = channel_opts["smooth"]
    channels = channel_opts["channels"]
    dtype = image.dtype
    factor = 2 ** (-1 / n_per_oct)
    base = image.copy()
    while base.shape[0] >= 8 and base.shape[1] >= 8:
        h, w = base.shape[:2]
        for i in range(n_per_oct):
            s = factor ** i
            nw, nh = int((w * s) / shrink) * shrink, int((h * s) / shrink) * shrink
            real_scale = nw / image.shape[1]
            im = resize_bilinear(base, nh, nw).astype(dtype)
            chns = channels(im)
            if shrink == 2:
                chns = avg_pool_2(chns)
            if smooth == 1:
                chns = smooth_image_3d(chns)
            yield np.atleast_3d(chns), real_scale / shrink
        base = avg_pool_2(base)


def predict_on_image(stages, thetas, X, window):
    """Reference dense-grid cascade with survivor compaction
    (/root/reference/waldboost/model.py:216-259 semantics).

    stages: list of dicts(feature (K,3), threshold, left, right, prediction).
    Returns rs, cs, hs, n_weak."""
    u, v, _ = X.shape
    m, n = window
    rs, cs = np.indices((max(u - m, 0), max(v - n, 0)))
    rs, cs = rs.flatten(), cs.flatten()
    hs = np.zeros_like(rs, np.float32)
    n_weak = 0
    for stage, theta in zip(stages, thetas):
        if not rs.size:
            break
        hs = hs + tree_predict_on_image(stage, X, rs, cs)
        n_weak += hs.size
        mask = hs >= theta
        rs, cs, hs = rs[mask], cs[mask], hs[mask]
    return rs, cs, hs, n_weak


def tree_predict_on_image(stage, X, rs, cs):
    node = np.zeros(rs.size, int)
    left = np.asarray(stage["left"])
    right = np.asarray(stage["right"])
    feature = np.asarray(stage["feature"]).reshape(-1, 3)
    thr = np.asarray(stage["threshold"])
    pred = np.asarray(stage["prediction"])
    for k in np.flatnonzero(left >= 0):
        r, c, ch = feature[k]
        idx = np.flatnonzero(node == k)
        if not idx.size:
            continue
        b = X[rs[idx] + r, cs[idx] + c, ch] <= thr[k]
        node[idx] = np.where(b, left[k], right[k])
    return pred[node].astype(np.float32)


def predict_samples(stages, thetas, X):
    """Reference Model.predict semantics (/root/reference/waldboost/model.py:181-214)."""
    N = X.shape[0]
    H = np.zeros(N, np.float32)
    mask = np.ones(N, bool)
    for stage, theta in zip(stages, thetas):
        resp = np.zeros(N, np.float32)
        if mask.any():
            idx = np.flatnonzero(mask)
            rs = np.zeros(idx.size, int)
            Xi = X[idx]
            node = np.zeros(idx.size, int)
            feature = np.asarray(stage["feature"]).reshape(-1, 3)
            left = np.asarray(stage["left"])
            right = np.asarray(stage["right"])
            thr = np.asarray(stage["threshold"])
            pred = np.asarray(stage["prediction"])
            for k in np.flatnonzero(left >= 0):
                sel = np.flatnonzero(node == k)
                if not sel.size:
                    continue
                r, c, ch = feature[k]
                b = Xi[sel, r, c, ch] <= thr[k]
                node[sel] = np.where(b, left[k], right[k])
            resp[idx] = pred[node]
        H[mask] += resp[mask]
        if theta == -np.inf:
            continue
        mask = np.logical_and(mask, H >= theta)
    H[~mask] = -np.inf
    return H, mask
