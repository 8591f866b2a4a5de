"""On-device decision-tree fitting via weighted histograms.

Device replacement for both of the reference's tree trainers:

* the sklearn CART wrapper (/root/reference/waldboost/training.py:34-50), and
* the FPGA scratch trainer's weighted-histogram information-gain split
  (/root/reference/waldboost/fpga/training.py:15-57), which SURVEY.md §7
  identifies as the cleaner, already-quantized spec to follow.

The tree is grown as a *complete* heap-ordered tree of static depth
``max_depth`` (node k's children are 2k+1 / 2k+2), with per-node early
leaf-termination (``min_samples_leaf``) recorded in the left/right arrays.
Every quantity is a fixed-shape array op: per-(node, class, feature)
cumulative weighted histograms as blocked indicator contractions, entropy
gain, and a flat argmax — no data-dependent shapes anywhere, so the whole fit
jits (under a mesh it runs replicated on gathered pools, see
waldboost_tpu.parallel.train_step).

Numerical notes:
* Binning is selectable; the default is per-feature QUANTILE edges
  (outlier-robust; AUC == sklearn CART within noise, PARITY.md) with
  thresholds that are actual data values,
  ``bin(x) =`` count of edges ``< x`` so ``x <= threshold <=> bin(x) <= b``
  exactly.  ``binning="uniform"`` keeps the global grid
  ``fmin + (b+1)*width`` with ``bin(x) = clip(ceil((x-fmin)/width)-1, 0,
  B-1)`` — the same exact fit/inference consistency, and exact splits for
  integer-valued channels with range <= B.
* Entropy uses a 0*log(0)=0 convention (the reference's raw ``p*log2(p)`` can
  produce NaN on pure nodes; this is a deliberate robustness improvement).
* Class balancing matches the FPGA trainer (each class's split-weights sum to
  0.5, /root/reference/waldboost/fpga/training.py:105-107); leaf predictions
  use the *raw* weights with +1e-3 smoothing
  (/root/reference/waldboost/fpga/training.py:158-162).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fit_tree_complete", "TreeFitResult", "prune_heap_tree",
           "indicator_histogram"]


class TreeFitResult(NamedTuple):
    feature: jax.Array    # (n_nodes,) int32 flat feature index, -1 for leaf
    threshold: jax.Array  # (n_nodes,) float32
    left: jax.Array       # (n_nodes,) int32 (-1 leaf)
    right: jax.Array      # (n_nodes,) int32
    pred: jax.Array       # (n_nodes,) float32 log-odds


def _entropy2(p0: jax.Array, p1: jax.Array) -> jax.Array:
    """Binary entropy of unnormalized masses, with 0*log(0) = 0."""
    tot = p0 + p1
    tot = jnp.where(tot > 0, tot, 1.0)
    q0 = p0 / tot
    q1 = p1 / tot
    h0 = jnp.where(q0 > 0, -q0 * jnp.log2(jnp.where(q0 > 0, q0, 1.0)), 0.0)
    h1 = jnp.where(q1 > 0, -q1 * jnp.log2(jnp.where(q1 > 0, q1, 1.0)), 0.0)
    return h0 + h1


def hist_mode_from_env() -> str:
    """Resolve the histogram implementation OUTSIDE any jit: "einsum" (the
    indicator contraction, f32 at HIGHEST precision) or "scatter" (the
    vmapped segment-sum, ``WB_HIST_EINSUM=0``).  Callers resolve this per
    call and pass it as the STATIC ``hist_mode`` argument; reading the env
    inside the traced function would bake the first value into the jit
    cache and silently ignore later toggles."""
    if os.environ.get("WB_HIST_EINSUM", "1") != "1":
        return "scatter"
    return "einsum"


#: rows per indicator block: the (rows, F, B-1) f32 operand of one block is
#: 512 * 576 * 255 * 4 B = 0.3 GB at a 12x12x4 window and 256 bins
HIST_CHUNK = 512


def indicator_histogram(wc: jax.Array, xf: jax.Array, edges: jax.Array,
                        chunk: int = HIST_CHUNK) -> jax.Array:
    """Cumulative class masses ``l[c, f, b] = sum_n wc[c, n] * [x_nf <=
    edges_bf]`` for (C, N) weights, (N, F) features and (B-1, F) edges.

    One f32 indicator contraction at HIGHEST precision per block of
    ``chunk`` rows, accumulated by a scan in block order: memory stays
    bounded at any pool size, and the summation order is fixed by the
    shapes alone (no scatter atomics)."""
    C, N = wc.shape
    F = xf.shape[1]
    chunk = max(1, min(int(chunk), N))
    pad = -N % chunk
    if pad:  # zero-weight rows add exact zeros
        wc = jnp.pad(wc, ((0, 0), (0, pad)))
        xf = jnp.pad(xf, ((0, pad), (0, 0)))
    n_blk = (N + pad) // chunk
    wcb = wc.reshape(C, n_blk, chunk).transpose(1, 0, 2)  # (n_blk, C, chunk)
    xb = xf.reshape(n_blk, chunk, F)
    et = edges.T[None, :, :]                               # (1, F, B-1)

    def block(acc, wx):
        w, x = wx
        ind = (x[:, :, None] <= et).astype(jnp.float32)     # (chunk, F, B-1)
        return acc + jnp.einsum("cn,nfb->cfb", w, ind,
                                precision=jax.lax.Precision.HIGHEST), None

    acc = jnp.zeros((C, F, edges.shape[0]), jnp.float32)
    return jax.lax.scan(block, acc, (wcb, xb))[0]


@functools.partial(
    jax.jit,
    static_argnames=("max_depth", "n_bins", "min_samples_leaf", "binning",
                     "hist_mode"),
)
def fit_tree_complete(
    xf: jax.Array,            # (N, F) float32 flattened sample features
    y: jax.Array,             # (N,) int32 class labels {0, 1}
    w_split: jax.Array,       # (N,) float32 class-balanced split weights
    w_pred: jax.Array,        # (N,) float32 raw weights for leaf predictions
    valid: jax.Array,         # (N,) bool padding mask
    max_depth: int = 2,
    n_bins: int = 256,
    min_samples_leaf: int = 1,
    feature_mask: Optional[jax.Array] = None,  # (max_depth, F) bool allowed per depth
    binning: str = "quantile",
    hist_mode: str = "auto",  # see hist_mode_from_env (static)
) -> TreeFitResult:
    N, F = xf.shape
    B = int(n_bins)
    D = int(max_depth)
    n_nodes = 2 ** (D + 1) - 1
    if hist_mode == "auto":
        # trace-time fallback for direct callers; the package's own call
        # sites resolve outside the jit so env toggles take effect
        hist_mode = hist_mode_from_env()
    use_einsum_hist = hist_mode != "scatter"

    xf = xf.astype(jnp.float32)
    w_split = jnp.where(valid, w_split, 0.0).astype(jnp.float32)
    w_pred = jnp.where(valid, w_pred, 0.0).astype(jnp.float32)

    if binning == "quantile":
        # -- per-feature QUANTILE grid (LightGBM-style): outlier features
        # stretch a uniform [fmin, fmax] grid until most mass shares a few
        # bins (the measured round-2 training-quality gap); quantile edges
        # put ~equal sample counts in every bin at any B.  bin(x) = count
        # of edges < x, so ``x <= edges[b]  <=>  bin(x) <= b`` exactly
        # (fit/inference consistency, duplicate edges included).
        # Edges come from a deterministic strided SUBSAMPLE of <=2048
        # rows: the (N, F) axis-0 device sort is the cost of this binning
        # and edge ESTIMATES from a quarter of the pool bin identically for
        # boosting purposes (LightGBM subsamples the same way).  Stride
        # keeps the choice independent of the mesh (same rows at any
        # device count).
        stride = max(1, -(-N // 2048))
        xsub = xf[::stride]
        vsub = valid[::stride]
        Ns = xsub.shape[0]
        xs = jnp.sort(jnp.where(vsub[:, None], xsub, jnp.inf), axis=0)
        nv = jnp.sum(vsub).astype(jnp.float32)
        ranks = jnp.arange(1, B, dtype=jnp.float32) * (nv / B)
        idx = jnp.clip(jnp.ceil(ranks).astype(jnp.int32) - 1, 0, Ns - 1)
        edges = xs[idx, :]                      # (B-1, F) nondecreasing
        edges = jnp.where(jnp.isfinite(edges), edges, jnp.float32(3e38))
        # bin(x) = count of edges < x (== searchsorted side='left'), as a
        # fused broadcast compare+reduce instead of searchsorted's serial
        # gather rounds
        bins = jnp.sum(edges[None, :, :] < xf[:, None, :], axis=1,
                       dtype=jnp.int32)
        edges_cmp = edges  # (B-1, F): bins <= b  <=>  x <= edges[b]

        def thr_of(best_f, best_b):
            return edges[jnp.clip(best_b, 0, B - 2), best_f]
    else:
        # -- global per-feature uniform quantization grid -------------------
        fmin = jnp.min(jnp.where(valid[:, None], xf, jnp.inf), axis=0)
        fmax = jnp.max(jnp.where(valid[:, None], xf, -jnp.inf), axis=0)
        fmin = jnp.where(jnp.isfinite(fmin), fmin, 0.0)
        fmax = jnp.where(jnp.isfinite(fmax), fmax, 0.0)
        width = jnp.maximum((fmax - fmin) / B, 1e-12)
        bins = jnp.clip(jnp.ceil((xf - fmin[None, :]) / width[None, :]) - 1,
                        0, B - 1)
        bins = bins.astype(jnp.int32)  # (N, F)
        # einsum-histogram comparison edges, matching thr_of's expression
        # (the direct x <= edge comparison is self-consistent with the
        # thresholds inference applies)
        edges_cmp = fmin[None, :] + jnp.arange(
            1, B, dtype=jnp.float32)[:, None] * width[None, :]

        def thr_of(best_f, best_b):
            return fmin[best_f] + (best_b + 1).astype(jnp.float32) * width[best_f]

    # -- outputs ------------------------------------------------------------
    feature = jnp.full(n_nodes, -1, jnp.int32)
    threshold = jnp.zeros(n_nodes, jnp.float32)
    left = jnp.full(n_nodes, -1, jnp.int32)
    right = jnp.full(n_nodes, -1, jnp.int32)
    w0_acc = jnp.zeros(n_nodes, jnp.float32)
    w1_acc = jnp.zeros(n_nodes, jnp.float32)

    node = jnp.zeros(N, jnp.int32)  # heap node id per sample

    def accumulate_pred(w0_acc, w1_acc, node, d):
        """Add per-node class masses for nodes at heap level d.  A masked
        reduction, not a scatter-add: a GPU scatter-add sums in the order
        its atomics land, so the leaf values would vary from run to run."""
        base = 2 ** d - 1
        at_level = jnp.logical_and(node >= base, valid)
        hit = jnp.logical_and(at_level[:, None],
                              node[:, None] == jnp.arange(n_nodes)[None, :])

        def mass(c):  # (n_nodes,) class-c weight per node
            m = jnp.logical_and(hit, (y == c)[:, None])
            return jnp.sum(jnp.where(m, w_pred[:, None], 0.0), axis=0)

        return w0_acc + mass(0), w1_acc + mass(1)

    for d in range(D):
        n_level = 2 ** d
        base = n_level - 1
        w0_acc, w1_acc = accumulate_pred(w0_acc, w1_acc, node, d)

        at_level = jnp.logical_and(node >= base, valid)
        local = jnp.where(at_level, node - base, n_level)  # trash slot n_level

        # -- histograms: (F, n_level, B) cumulative class masses ------------
        if use_einsum_hist:
            # matmul path: l[c, f, b] = sum_n wc[c, n] * [x_nf <= edge_bf]
            # as (C, chunk) @ (chunk, F*(B-1)) indicator contractions (the
            # vmapped per-feature segment-sum alternative lowers to F
            # serial scatters).  The indicator is exact {0, 1}; HIGHEST
            # keeps the weights f32 (a TF32 or bf16 pass would round their
            # mantissa and could perturb split ranking near ties), so the
            # sums differ from the scatter path's only in summation order.
            # WB_HIST_EINSUM=0 selects the scatter path, whose float
            # scatter-add is order-nondeterministic on the GPU.
            C2 = n_level * 2
            cls = jnp.where(at_level, local * 2 + y, C2)
            wc = jnp.where(cls[None, :] == jnp.arange(C2)[:, None],
                           w_split[None, :], 0.0)            # (C2, N) f32
            l_part = indicator_histogram(wc, xf, edges_cmp)
            tot_c = jnp.sum(wc, axis=1)                      # exact totals
            l_all = jnp.concatenate(
                [l_part, jnp.broadcast_to(tot_c[:, None, None],
                                          (C2, F, 1))], axis=-1)
            l_all = l_all.reshape(n_level, 2, F, B)
            l0 = jnp.transpose(l_all[:, 0], (1, 0, 2))       # (F, n_level, B)
            l1 = jnp.transpose(l_all[:, 1], (1, 0, 2))
        else:
            seg_nc = local * 2 + y  # (N,)
            segid = seg_nc[:, None] * B + bins  # (N, F)
            n_seg = (n_level + 1) * 2 * B

            def per_feature(seg_col):
                return jax.ops.segment_sum(w_split, seg_col,
                                           num_segments=n_seg)

            hist = jax.vmap(per_feature, in_axes=1)(segid)  # (F, n_seg)
            hist = hist.reshape(F, n_level + 1, 2, B)[:, :n_level]

            l0 = jnp.cumsum(hist[:, :, 0, :], axis=-1)  # (F, n_level, B)
            l1 = jnp.cumsum(hist[:, :, 1, :], axis=-1)
        l0_tot = l0[..., -1:]
        l1_tot = l1[..., -1:]
        r0 = l0_tot - l0
        r1 = l1_tot - l1
        tot = l0_tot + l1_tot
        tot_safe = jnp.where(tot > 0, tot, 1.0)
        left_w = (l0 + l1) / tot_safe
        right_w = (r0 + r1) / tot_safe
        gain = _entropy2(l0_tot, l1_tot) - (
            left_w * _entropy2(l0 + 1e-4, l1 + 1e-4)
            + right_w * _entropy2(r0 + 1e-4, r1 + 1e-4)
        )  # (F, n_level, B)
        # last bin = empty right side; exclude as a split candidate
        gain = gain.at[..., B - 1].set(-jnp.inf)
        if feature_mask is not None:
            gain = jnp.where(feature_mask[d][:, None, None], gain, -jnp.inf)

        flat = gain.transpose(1, 0, 2).reshape(n_level, F * B)
        best = jnp.argmax(flat, axis=1)              # (n_level,)
        best_f = (best // B).astype(jnp.int32)
        best_b = (best % B).astype(jnp.int32)
        best_thr = thr_of(best_f, best_b)

        # -- leaf decision ---------------------------------------------------
        cnt = jax.ops.segment_sum(
            at_level.astype(jnp.float32), jnp.where(at_level, local, n_level),
            num_segments=n_level + 1)[:n_level]
        # a node needs at least 2 samples to split (sklearn min_samples_split)
        make_leaf = cnt < float(max(min_samples_leaf, 2))

        ids = base + jnp.arange(n_level, dtype=jnp.int32)
        feature = feature.at[ids].set(jnp.where(make_leaf, -1, best_f))
        threshold = threshold.at[ids].set(jnp.where(make_leaf, 0.0, best_thr))
        left = left.at[ids].set(jnp.where(make_leaf, -1, 2 * ids + 1))
        right = right.at[ids].set(jnp.where(make_leaf, -1, 2 * ids + 2))

        # -- route samples ----------------------------------------------------
        node_f = best_f[jnp.clip(local, 0, n_level - 1)]
        node_t = best_thr[jnp.clip(local, 0, n_level - 1)]
        node_leaf = make_leaf[jnp.clip(local, 0, n_level - 1)]
        xv = jnp.take_along_axis(xf, node_f[:, None], axis=1)[:, 0]
        go_right = xv > node_t
        child = 2 * node + 1 + go_right.astype(jnp.int32)
        node = jnp.where(jnp.logical_and(at_level, jnp.logical_not(node_leaf)),
                         child, node)

    w0_acc, w1_acc = accumulate_pred(w0_acc, w1_acc, node, D)
    pred = jnp.log((w1_acc + 1e-3) / (w0_acc + 1e-3)) / 2.0
    return TreeFitResult(feature=feature, threshold=threshold, left=left,
                         right=right, pred=pred.astype(jnp.float32))


def prune_heap_tree(feature: np.ndarray, threshold: np.ndarray,
                    left: np.ndarray, right: np.ndarray, pred: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Drop unreachable heap nodes (children of early leaves) and renumber in
    BFS order.  Host-side post-processing of :func:`fit_tree_complete`."""
    feature = np.asarray(feature)
    order = []
    remap = {}
    queue = [0]
    while queue:
        k = queue.pop(0)
        remap[k] = len(order)
        order.append(k)
        if left[k] >= 0:
            queue.append(int(left[k]))
            queue.append(int(right[k]))
    idx = np.array(order, int)
    new_left = np.array([remap[int(l)] if l >= 0 else -1 for l in left[idx]], np.int32)
    new_right = np.array([remap[int(r)] if r >= 0 else -1 for r in right[idx]], np.int32)
    return (feature[idx].astype(np.int32), threshold[idx].astype(np.float32),
            new_left, new_right, pred[idx].astype(np.float32))
