"""Fully on-device, mesh-shardable WaldBoost training step.

One boosting stage — exp-loss weights, histogram tree fit, score update, SPRT
threshold, stage statistics — as a single jitted program over fixed-capacity
(padded + masked) sample pools.  Under a mesh, the pools are sharded over the
data axis at rest; the stage gathers them with ONE all-gather and
computes the statistics replicated (a WaldBoost pool is a few MB, and
replicated f32 reductions make the trained model bitwise mesh-invariant —
partial-sum psums round differently per mesh size), then writes the updated
scores/validity back sharded.  (SURVEY.md §2/§5 parallel-inventory: jax
collectives replace the reference's single-host multiprocessing.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fit import TreeFitResult, fit_tree_complete
from ..training import fit_rejection_threshold_device
from .mesh import data_sharding, replicated

__all__ = ["StageResult", "make_train_step", "tree_predict_device"]


class StageResult(NamedTuple):
    tree: TreeFitResult
    theta: jax.Array   # ()
    H0: jax.Array      # updated scores (padded)
    H1: jax.Array
    p0: jax.Array      # ()
    p1: jax.Array      # ()
    loss: jax.Array    # ()
    v0: jax.Array = None  # post-stage validity masks (SPRT-pruned pools)
    v1: jax.Array = None
    n0: jax.Array = None  # () int32 post-prune pool counts (sum(v0)/sum(v1)):
    n1: jax.Array = None  # computed in-step so the host reads ONE result


def tree_predict_device(tree: TreeFitResult, xf: jax.Array, max_depth: int) -> jax.Array:
    """Evaluate a heap-layout tree on flattened samples (N, F) -> (N,)."""
    N = xf.shape[0]
    node = jnp.zeros(N, jnp.int32)
    for _ in range(max_depth):
        f = jnp.take(tree.feature, node)
        leaf = f < 0
        fv = jnp.take_along_axis(xf, jnp.maximum(f, 0)[:, None], axis=1)[:, 0]
        go_right = fv > jnp.take(tree.threshold, node)
        child = 2 * node + 1 + go_right.astype(jnp.int32)
        node = jnp.where(leaf, node, child)
    return jnp.take(tree.pred, node)


def _stage_body(x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt,
                feature_mask=None,
                alpha=0.1, max_depth=2, n_bins=256, min_samples_leaf=1,
                mesh=None, clip=None, quantizer=None,
                integer_thresholds=False, binning="quantile",
                hist_mode="auto"):
    """x0/x1: (N?, F) flattened padded pools; H: scores; v: valid masks.
    ``theta_in``/``use_sprt``: rejection-schedule override (use_sprt=True ->
    estimate theta from data).

    Under a mesh, the fit inputs are gathered to every chip and the stage
    statistics compute REPLICATED: f32 reductions are then evaluated in the
    same order on every mesh size, so the trained model is bitwise
    mesh-invariant (partial-sum psums round differently per mesh and flip
    near-tie feature argmaxes).  A WaldBoost pool is a few MB — the
    all-gather is noise next to mining — while pools stay sharded at rest
    and the score/prune updates still write back sharded."""
    gather = lambda a: a
    if mesh is not None:
        rep = replicated(mesh)
        gather = lambda a: jax.lax.with_sharding_constraint(a, rep)
        x0, H0, v0 = gather(x0), gather(H0), gather(v0)
        x1, H1, v1 = gather(x1), gather(H1), gather(v1)
    n0 = jnp.maximum(jnp.sum(v0), 1).astype(jnp.float32)
    n1 = jnp.maximum(jnp.sum(v1), 1).astype(jnp.float32)
    # exp-loss weights (/root/reference/waldboost/training.py:14-15,159-161)
    W0 = jnp.where(v0, jnp.exp(H0), 0.0) / n0 / 2
    W1 = jnp.where(v1, jnp.exp(-H1), 0.0) / n1 / 2

    xf = jnp.concatenate([x0, x1], axis=0)
    y = jnp.concatenate([jnp.zeros(x0.shape[0], jnp.int32),
                         jnp.ones(x1.shape[0], jnp.int32)])
    w = jnp.concatenate([W0, W1])
    valid = jnp.concatenate([v0, v1])
    # class-balanced split weights (each class sums to 0.5)
    s0 = jnp.maximum(jnp.sum(W0), 1e-30)
    s1 = jnp.maximum(jnp.sum(W1), 1e-30)
    wb = jnp.concatenate([W0 / (s0 * 2), W1 / (s1 * 2)])

    tree = fit_tree_complete(xf, y, wb, w, valid, max_depth=max_depth,
                             n_bins=n_bins, min_samples_leaf=min_samples_leaf,
                             feature_mask=feature_mask, binning=binning,
                             hist_mode=hist_mode)
    # FPGA mode: integer-floored thresholds + clipped/quantized responses
    # BEFORE score accumulation (the host path's DTree.fit post-transforms,
    # /root/reference/waldboost/fpga/training.py:160-168)
    if integer_thresholds:
        tree = tree._replace(threshold=jnp.floor(tree.threshold))
    pred = tree.pred
    if clip is not None:
        pred = jnp.clip(pred, -float(clip), float(clip))
    if quantizer:
        q = jnp.float32(quantizer)
        pred = jnp.round(q * pred) / q
    tree = tree._replace(pred=pred)

    # the updated scores leave the step sharded; pinning them replicated
    # here keeps the threshold fit and the stage sums below from being
    # partitioned into mesh-dependent partial sums
    H0n = gather(H0 + tree_predict_device(tree, x0, max_depth))
    H1n = gather(H1 + tree_predict_device(tree, x1, max_depth))

    theta_est = fit_rejection_threshold_device(H0n, H1n, P0, P1, alpha,
                                               v0=v0, v1=v1)
    theta = jnp.where(use_sprt, theta_est, theta_in)

    p0 = jnp.sum(jnp.logical_and(H0n >= theta, v0)) / n0
    p1 = jnp.sum(jnp.logical_and(H1n >= theta, v1)) / n1
    loss = (jnp.sum(jnp.where(v0, jnp.exp(H0n), 0.0)) / n0
            + jnp.sum(jnp.where(v1, jnp.exp(-H1n), 0.0)) / n1) / 2
    # SPRT pruning: rejected samples leave the pool (the reference rescores
    # then drops -inf samples, /root/reference/waldboost/samples.py:287-299)
    v0n = jnp.logical_and(v0, H0n >= theta)
    v1n = jnp.logical_and(v1, H1n >= theta)
    return StageResult(tree=tree, theta=theta, H0=H0n, H1=H1n, p0=p0, p1=p1,
                       loss=loss, v0=v0n, v1=v1n,
                       n0=jnp.sum(v0n, dtype=jnp.int32),
                       n1=jnp.sum(v1n, dtype=jnp.int32))


def make_train_step(alpha: float = 0.1, max_depth: int = 2, n_bins: int = 256,
                    min_samples_leaf: int = 1, mesh=None, clip=None,
                    quantizer=None, integer_thresholds: bool = False,
                    binning: str = "quantile"):
    """Build (or reuse) the jitted stage-training step.

    Memoized on its parameters: successive ``train_sharded`` calls (e.g.
    the segmented bench loop, or train/evaluate/continue workflows) share
    ONE jit instance, so only the first segment ever traces/compiles.
    """
    from ..ops.fit import hist_mode_from_env
    return _make_train_step_cached(alpha, max_depth, n_bins,
                                   min_samples_leaf, mesh, clip, quantizer,
                                   integer_thresholds, binning,
                                   hist_mode_from_env())


@functools.lru_cache(maxsize=32)
def _make_train_step_cached(alpha, max_depth, n_bins, min_samples_leaf,
                            mesh, clip, quantizer, integer_thresholds,
                            binning, hist_mode="auto"):
    """Build the jitted stage-training step.

    Signature of the returned function:
        step(x0, H0, v0, x1, H1, v1, P0, P1, theta_in, use_sprt,
             feature_mask) -> StageResult
    with ``feature_mask`` an optional (max_depth, F) bool array of allowed
    split features per depth (the FPGA bank restriction; pass None for
    unrestricted).

    With ``mesh``, sample pools (x*, H*, v*) are sharded over the data axis
    at rest; the stage gathers once and computes replicated (bitwise
    mesh-invariant), writing scores/validity back sharded.
    """
    body = functools.partial(_stage_body, alpha=alpha, max_depth=max_depth,
                             n_bins=n_bins, min_samples_leaf=min_samples_leaf,
                             mesh=mesh, clip=clip, quantizer=quantizer,
                             integer_thresholds=integer_thresholds,
                             binning=binning, hist_mode=hist_mode)
    if mesh is None:
        return jax.jit(body)
    sh1 = lambda ndim: data_sharding(mesh, ndim)
    rep = replicated(mesh)
    in_sh = (sh1(2), sh1(1), sh1(1), sh1(2), sh1(1), sh1(1), rep, rep, rep,
             rep, rep)
    out_sh = StageResult(
        tree=TreeFitResult(feature=rep, threshold=rep, left=rep, right=rep,
                           pred=rep),
        theta=rep, H0=sh1(1), H1=sh1(1), p0=rep, p1=rep, loss=rep,
        v0=sh1(1), v1=sh1(1), n0=rep, n1=rep)
    jstep = jax.jit(body, in_shardings=in_sh, out_shardings=out_sh)

    def step(*args):
        if len(args) == 10:  # feature_mask omitted -> unrestricted
            # numpy (uncommitted): replicates over multi-process meshes too
            args = args + (np.ones((max_depth, args[0].shape[1]), bool),)
        return jstep(*args)

    return step
