"""Sharded training loop with a fixed-capacity device-resident sample pool.

The device form of ``wb.train`` (SURVEY.md §7 step 6): the sample pool
lives on device as fixed-capacity ring buffers with validity masks, sharded
over the mesh's data axis.  Per stage, ONE jitted program (parallel/
train_step.py) does everything numeric — exp-loss weights, the weighted
histogram tree fit, score updates, the SPRT threshold, and pool pruning —
with XLA inserting psum/all-gather collectives for the global statistics.
The host stays the *producer*: it decodes/labels training images (the same
mining path the host pool uses, samples.get_samples_from_image) and inserts
new crops into free device slots; only two scalars (per-class survivor
counts) cross back per stage.

Reference anchor: the train-loop contract at
/root/reference/waldboost/__init__.py:133-227 and the pool bootstrap at
/root/reference/waldboost/samples.py:248-299.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..samples import SampleLabel
from ..training import DTree, Learner
from .mesh import is_multiprocess, shard_array
from .train_step import make_train_step

__all__ = ["DevicePool", "train_sharded"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _insert_gather_jit(x, H, v, src_x, src_H, idx, kn):
    """Gather rows ``idx[:kn]`` of device-resident mined crops straight
    into free pool slots — crop bytes never make a device->host->device
    round trip."""
    K = idx.shape[0]
    xn = src_x[idx].reshape(K, -1).astype(x.dtype)
    Hn = src_H[idx].astype(H.dtype)
    order = jnp.argsort(v, stable=True)          # free slots first
    slots = order[:K]
    free = jnp.logical_not(v[slots])
    take = jnp.logical_and(jnp.arange(K) < kn, free)
    x = x.at[slots].set(jnp.where(take[:, None], xn, x[slots]))
    H = H.at[slots].set(jnp.where(take, Hn, H[slots]))
    v = v.at[slots].set(jnp.logical_or(v[slots], take))
    return x, H, v


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _insert_jit(x, H, v, xn, Hn, kn):
    """Fill up to ``kn`` new samples into invalid slots of the pool.

    ``xn``/``Hn`` are fixed-capacity staging buffers (entries beyond kn are
    ignored).  Free slots are located with one argsort over the validity
    mask (False sorts first); occupied slots are never overwritten.
    """
    K = min(xn.shape[0], x.shape[0])
    xn = xn[:K]
    Hn = Hn[:K]
    order = jnp.argsort(v, stable=True)          # free slots first
    slots = order[:K]
    free = jnp.logical_not(v[slots])
    take = jnp.logical_and(jnp.arange(K) < kn, free)
    x = x.at[slots].set(jnp.where(take[:, None], xn, x[slots]))
    H = H.at[slots].set(jnp.where(take, Hn, H[slots]))
    v = v.at[slots].set(jnp.logical_or(v[slots], take))
    return x, H, v


class DevicePool:
    """One class (tp or fp) of the device-resident sample pool."""

    #: staging-buffer bucket (jit cache: one insert program per pool)
    INSERT_CHUNK = 1024

    def __init__(self, capacity: int, feat_dim: int, mesh=None):
        n_dev = int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1
        # mesh-independent rounding (256 divides by any realistic mesh), so
        # the pool contents — and therefore the trained model — are identical
        # across mesh sizes
        self.capacity = _round_up(capacity, max(256, n_dev * 8))
        self.mesh = mesh
        if mesh is not None:
            # shard_array handles single-process meshes (device_put) and
            # multi-process DCN meshes (global-array assembly from each
            # process's addressable shards) alike
            x = shard_array(np.zeros((self.capacity, feat_dim), np.float32),
                            mesh)
            H = shard_array(np.zeros(self.capacity, np.float32), mesh)
            v = shard_array(np.zeros(self.capacity, bool), mesh)
        else:
            x = jnp.zeros((self.capacity, feat_dim), jnp.float32)
            H = jnp.zeros(self.capacity, jnp.float32)
            v = jnp.zeros(self.capacity, bool)
        self.x, self.H, self.v = x, H, v
        self.count = 0  # host mirror of sum(v)

    def insert(self, X_new: np.ndarray, H_new: np.ndarray) -> int:
        """Insert host-mined crops; returns how many were accepted."""
        k = int(len(X_new))
        if k == 0:
            return 0
        accept = min(k, self.capacity - self.count)
        if accept <= 0:
            return 0
        F = self.x.shape[1]
        X_new = np.asarray(X_new, np.float32).reshape(k, F)[:accept]
        H_new = np.asarray(H_new, np.float32).ravel()[:accept]
        for i in range(0, accept, self.INSERT_CHUNK):
            xa = X_new[i:i + self.INSERT_CHUNK]
            ha = H_new[i:i + self.INSERT_CHUNK]
            kn = len(xa)
            pad = self.INSERT_CHUNK - kn
            xa = np.pad(xa, ((0, pad), (0, 0)))
            ha = np.pad(ha, (0, pad))
            # staging buffers ride in as NUMPY (not committed device
            # arrays): on a multi-process mesh every process passes the
            # same host value and jit replicates it — a committed local
            # array would conflict with the pool's global sharding
            self.x, self.H, self.v = _insert_jit(
                self.x, self.H, self.v, xa, ha, np.int32(kn))
        self.count += accept
        return accept

    def insert_from_device(self, src_x, src_H, idx) -> int:
        """Insert rows ``idx`` of an on-device mined-crop array; slot
        assignment (ascending free slots, insertion order) is identical to
        sequential :meth:`insert` calls over the same rows."""
        k = int(len(idx))
        if k == 0:
            return 0
        if is_multiprocess(self.mesh):
            # mining runs on each process's LOCAL devices; a local crop
            # array cannot feed a jit over the global mesh.  Stage through
            # the host insert path — every process mines the same stream,
            # so the (identical) numpy buffers replicate cleanly.
            idx = np.asarray(idx, np.int64)
            return self.insert(np.asarray(src_x)[idx],
                               np.asarray(src_H)[idx])
        accept = min(k, self.capacity - self.count)
        if accept <= 0:
            return 0
        idx = np.asarray(idx[:accept], np.int32)
        # pad the index vector to the SOURCE bucket size (already a power
        # of two from the mining gather), capped at capacity: the jit cache
        # then holds one program per source bucket instead of one per
        # (accept-bucket x source-bucket) pair — measured as one ~0.3 s
        # compile per novel pair in the training profile's pool_insert phase
        K = min(int(src_x.shape[0]), self.capacity)
        idxp = np.pad(idx, (0, K - accept))
        self.x, self.H, self.v = _insert_gather_jit(
            self.x, self.H, self.v, src_x, src_H, jnp.asarray(idxp),
            jnp.int32(accept))
        self.count += accept
        return accept

    def apply_stage(self, H, v, count: Optional[int] = None) -> None:
        """Adopt the post-stage scores and pruned validity mask (the crop
        buffer ``x`` itself is untouched by a stage).  ``count`` is the
        in-step sum(v) when the caller already fetched it (train_sharded
        reads the whole stage result in ONE device_get: one transfer
        latency instead of several)."""
        self.H = H
        self.v = v
        self.count = int(jnp.sum(v)) if count is None else int(count)


def train_sharded(model, training_images, mesh=None, learner: Learner = None,
                  length: int = 64, min_tp: int = 1000, min_fp: int = 1000,
                  capacity: Optional[int] = None, theta_schedule=None,
                  max_depth: int = 2, n_bins: int = 256,
                  binning: str = "quantile", seed=None,
                  callbacks=(), logger: Optional[logging.Logger] = None,
                  mine_batch: int = 8, feature_masks_fn=None,
                  clip=None, quantizer=None,
                  integer_thresholds: bool = False, pools: dict = None,
                  prewarm_length: Optional[int] = None, **label_kwargs):
    """Train ``model`` to ``length`` stages with the device-resident pool.

    Semantics mirror ``wb.train`` (pool bootstrap, exp-loss boosting, SPRT
    thresholds, rejection schedule, Learner statistics); the weak-classifier
    fit is the histogram tree (DTree hist backend) evaluated entirely on
    device, sharded over ``mesh``'s data axis when given.  Returns the
    Learner (stats/pickle-compatible with the host path).

    ``feature_masks_fn(stage) -> (max_depth, F) bool``: per-stage allowed
    split features per depth (the FPGA bank restriction);
    ``clip``/``quantizer``/``integer_thresholds`` apply the FPGA response
    and threshold transforms IN-STEP (before score accumulation) — together
    these give fpga.train its mesh path.

    ``pools``: an optional MUTABLE dict carrying the device-resident pools
    across calls ({"fp": DevicePool, "tp": DevicePool}, filled in on first
    use).  A resumed call (same dict, same model) then continues from the
    mined-and-rescored pool state instead of re-bootstrapping mining from
    scratch — the device analog of passing the same host SamplePool to
    successive ``wb.train`` calls.

    ``prewarm_length``: bucket-prewarm horizon when it exceeds ``length``
    — a segmented run (e.g. train to 8, evaluate, continue to 64) can tell
    the FIRST segment the eventual target so every length-bucket mining
    program compiles in that segment's background instead of racing a
    later segment's stage loop.
    """
    from ..training import BasicRejectionSchedule

    logger = logger or logging.getLogger("Training")
    if len(model) >= length:
        return learner
    learner = learner or Learner(alpha=0.2, max_depth=max_depth)
    if len(model) != len(learner):
        raise RuntimeError("Model length and learner length are not consistent")
    if theta_schedule is None:
        theta_schedule = BasicRejectionSchedule()

    m, n, C = model.shape
    F = m * n * C
    capacity = capacity or 2 * max(min_tp, min_fp)
    pool_fp = pool_tp = None
    if pools is not None:
        pool_fp, pool_tp = pools.get("fp"), pools.get("tp")
        # carried pool scores are only valid for the SAME model object at
        # the SAME stage count it had when the previous call returned; a
        # different model (or externally grown/truncated cascade) with a
        # matching feat-dim would otherwise be silently reused with stale H
        tag = (getattr(model, "_uid", id(model)), len(model), F, mesh)
        if pool_fp is not None and pools.get("model_tag") != tag:
            logger.info("pools carry-over rejected (model/stage/mesh "
                        "changed): re-bootstrapping the device pool")
            pool_fp = pool_tp = None
        if pool_fp is not None and pool_fp.capacity < _round_up(
                capacity, 256):
            logger.warning(
                "pools carry-over keeps the previous capacity %d; the "
                "requested capacity %d is ignored", pool_fp.capacity,
                capacity)
    if pool_fp is None or pool_tp is None:
        pool_fp = DevicePool(capacity, F, mesh=mesh)
        pool_tp = DevicePool(capacity, F, mesh=mesh)
    if pools is not None:
        pools["fp"], pools["tp"] = pool_fp, pool_tp
    rng = np.random.default_rng(seed)
    step = make_train_step(alpha=learner.alpha, max_depth=max_depth,
                           n_bins=n_bins, binning=binning, mesh=mesh,
                           clip=clip, quantizer=quantizer,
                           integer_thresholds=integer_thresholds)
    it = iter(training_images)

    def refill():
        from ..samples import batched_records, mine_labeled_windows

        need_tp = pool_tp.count < min_tp
        need_fp = pool_fp.count < min_fp
        if not (need_tp or need_fp):
            return
        mined = 0
        # same batched mining as SamplePool.update (one canvas + cascade
        # program per image batch), but crops go straight from the mining
        # gather into the device pools — no host round trip
        for group in batched_records(it, mine_batch):
            res = mine_labeled_windows(model, group, tp=need_tp,
                                       fp=need_fp, rng=rng, **label_kwargs)
            if res is not None:
                pend, samples_dev, scores_dev = res
                label = np.concatenate(
                    [b.get_field("tp_label") for _, b in pend])
                tp_idx = np.flatnonzero(label == SampleLabel.TRUE_POSITIVE)
                fp_idx = np.flatnonzero(label == SampleLabel.FALSE_POSITIVE)
                if need_tp and tp_idx.size:
                    pool_tp.insert_from_device(samples_dev, scores_dev,
                                               tp_idx)
                if need_fp and fp_idx.size:
                    pool_fp.insert_from_device(samples_dev, scores_dev,
                                               fp_idx)
            mined += len(group)
            need_tp = pool_tp.count < min_tp
            need_fp = pool_fp.count < min_fp
            if not (need_tp or need_fp) or mined >= 10000:
                return
        if need_tp or need_fp:
            logger.warning("training images exhausted during mining")

    horizon = max(length, prewarm_length or 0)
    if os.environ.get("WB_TRAIN_PREWARM", "1") == "1":
        # resumed models already know their mining geometry: start the
        # full-horizon bucket compiles before the first stage (no-op on a
        # fresh model — geometry appears with the first mining scan)
        from ..model import prewarm_mining_buckets
        prewarm_mining_buckets(model, horizon, logger=logger)

    for stage in range(len(model), length):
        refill()
        logger.log(15, f"Stage {stage}: pool tp={pool_tp.count} "
                       f"fp={pool_fp.count}")
        theta_in = theta_schedule(stage, learner.false_positive_rate)
        use_sprt = theta_in is None
        # scalar/mask operands as NUMPY: uncommitted, so they replicate
        # over single- AND multi-process meshes alike
        if feature_masks_fn is not None:
            fmask = np.asarray(feature_masks_fn(stage), bool)
        else:
            fmask = np.ones((max_depth, F), bool)
        res = step(pool_fp.x, pool_fp.H, pool_fp.v,
                   pool_tp.x, pool_tp.H, pool_tp.v,
                   np.float32(learner.false_positive_rate),
                   np.float32(learner.true_positive_rate),
                   np.float32(-np.inf if use_sprt else theta_in),
                   np.bool_(use_sprt), fmask)
        # ONE device->host fetch for everything the host consumes this
        # stage (tree tables + scalars + pool counts): one transfer latency
        # instead of several
        tree_h, theta, p0, p1, loss, c0, c1 = jax.device_get(
            (res.tree, res.theta, res.p0, res.p1, res.loss, res.n0, res.n1))
        theta = float(theta)
        weak = _dtree_from_fit(tree_h, (m, n, C))
        model.append(weak, theta)
        learner.record_stage(p0, p1, loss)
        pool_fp.apply_stage(res.H0, res.v0, count=c0)
        pool_tp.apply_stage(res.H1, res.v1, count=c1)
        if os.environ.get("WB_TRAIN_PREWARM", "1") == "1":
            # full-horizon prewarm: the target length is known, so every
            # bucket crossing this run will hit starts compiling now (the
            # one-ahead horizon lost the race to a ~1 s/stage loop); no-op
            # once every bucket is warm
            from ..model import prewarm_mining_buckets
            prewarm_mining_buckets(model, horizon, logger=logger)
        logger.log(15, f"Stage {stage}: loss {float(loss):g} "
                       f"p0 {float(p0):g} p1 {float(p1):g} "
                       f"theta {theta:g}")
        for cb in callbacks:
            cb(model, learner, stage)
    from ..model import join_prewarm_threads
    join_prewarm_threads(model)
    if pools is not None:
        # stamp what the carried pool scores are valid FOR: this model
        # object at this stage count on this mesh (checked on pickup)
        pools["model_tag"] = (getattr(model, "_uid", id(model)),
                              len(model), F, mesh)
    return learner


def _dtree_from_fit(tree, shape) -> DTree:
    """TreeFitResult (heap layout) -> host DTree (pruned flat arrays)."""
    from ..ops.fit import prune_heap_tree

    feat, thr, left, right, pred = prune_heap_tree(
        np.asarray(tree.feature), np.asarray(tree.threshold),
        np.asarray(tree.left), np.asarray(tree.right), np.asarray(tree.pred))
    feature = [np.unravel_index(f, shape) if f >= 0 else None for f in feat]
    return DTree(feature, thr, left, right, pred)
