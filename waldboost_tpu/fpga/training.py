"""FPGA-constrained training: bank-restricted features, quantized responses.

Parity with /root/reference/waldboost/fpga/training.py: the training loop
mirrors ``waldboost_tpu.train`` but restricts each tree depth's features to a
scheduled memory bank (conflict-free parallel pixel reads in hardware) and
clips + quantizes leaf responses so the final detector evaluates with integer
arithmetic.

The split finder itself *is* the framework's standard device histogram
trainer (``DTree.fit(backend="hist")``) — the reference's FPGA trainer
(weighted-histogram information gain over integer bins,
fpga/training.py:15-57) is exactly the algorithm the device path uses everywhere,
with ``integer_thresholds=True`` restoring integer bin edges.
"""

from __future__ import annotations

import logging

import numpy as np

from ..samples import SamplePool
from ..training import BasicRejectionSchedule, DTree as BaseDTree, Learner

from .banks import BankScheduler, PixelBanks

__all__ = ["DTree", "train"]

logger = logging.getLogger(__name__)


class DTree:
    """FPGA weak-classifier trainer: depth-restricted features, integer
    thresholds, clipped + quantized leaf responses.  Returns a plain
    :class:`waldboost_tpu.training.DTree` instance, interchangeable with the
    base trainer (/root/reference/waldboost/fpga/training.py:60-171)."""

    @staticmethod
    def fit(X0, W0, X1, W1, max_depth: int = 2, min_samples_leaf: int = 10,
            allowed_features=None, clip: float = 3, quantizer: int = 32,
            n_bins: int = 256) -> BaseDTree:
        return BaseDTree.fit(
            X0, W0, X1, W1, max_depth=max_depth,
            min_samples_leaf=min_samples_leaf,
            allowed_features=allowed_features, backend="hist", n_bins=n_bins,
            clip=clip, quantizer=quantizer, integer_thresholds=True)


def train(model,
          training_images,
          learner: Learner = None,
          pool: SamplePool = None,
          length: int = 64,
          max_depth: int = 2,
          theta_schedule=None,
          bank_pattern_shape=(2, 2),
          clip: float = 3,
          quantizer: int = 32,
          callbacks=(),
          logger_: logging.Logger = None,
          mesh=None):
    """Train a model with FPGA-friendly feature access patterns
    (/root/reference/waldboost/fpga/training.py:174-264).

    ``bank_pattern_shape``: window pixels are tiled into this many banks;
    each stage's tree reads one scheduled bank per depth.  ``quantizer``:
    responses become integers when multiplied by it.

    With ``mesh``, training runs the sharded device-pool path
    (parallel.trainer.train_sharded) with the bank restriction as per-stage
    feature masks and the clip/quantize/integer-threshold transforms
    applied in-step.
    """
    log = logger_ or logging.getLogger("WaldBoost/FPGA")

    if len(model) >= length:
        return learner

    if mesh is not None:
        from ..parallel.trainer import train_sharded

        m, n, C = model.shape
        F = m * n * C
        masks_fn = None
        if bank_pattern_shape is not None:
            banks = PixelBanks(model.shape, bank_pattern_shape)
            scheduler = BankScheduler(int(np.prod(bank_pattern_shape)))

            def masks_fn(stage):
                mask = np.zeros((max_depth, F), bool)
                for d, b in enumerate(scheduler.schedule(max_depth)):
                    mask[d, banks.bank_pixels(b)] = True
                return mask

        pool_kwargs = {}
        if pool is not None:
            pool_kwargs = dict(min_tp=pool.min_tp, min_fp=pool.min_fp,
                               seed=pool.seed, mine_batch=pool.mine_batch,
                               **pool.label_boxes_args)
        return train_sharded(
            model, training_images, mesh=mesh,
            learner=learner or Learner(alpha=0.2, wh=DTree, clip=clip,
                                       quantizer=quantizer,
                                       max_depth=max_depth),
            length=length, theta_schedule=theta_schedule,
            max_depth=max_depth, callbacks=callbacks, logger=log,
            feature_masks_fn=masks_fn, clip=clip, quantizer=quantizer,
            integer_thresholds=True, **pool_kwargs)

    learner = learner or Learner(wh=DTree, clip=clip, quantizer=quantizer)
    if theta_schedule is None:
        theta_schedule = BasicRejectionSchedule()

    if learner.wh is not DTree:
        log.warning("Correcting learner.wh to fpga.DTree")
        learner.wh = DTree

    if len(model) != len(learner):
        raise RuntimeError("Model length and learner length are not consistent")

    if learner.wh_args.get("max_depth") != max_depth:
        learner.wh_args["max_depth"] = max_depth

    if len(model) > 0:
        log.info(f"{len(model)} stages are already present, continuing")

    banks = scheduler = None
    if bank_pattern_shape is not None:
        banks = PixelBanks(model.shape, bank_pattern_shape)
        scheduler = BankScheduler(int(np.prod(bank_pattern_shape)))

    pool = pool or SamplePool()

    for stage in range(len(model), length):
        log.info(f"Training stage {stage}")
        pool.update(model, training_images)
        X0, H0 = pool.get_false_positives()
        X1, H1 = pool.get_true_positives()
        if banks is not None:
            stage_banks = scheduler.schedule(max_depth)
            ftrs = [banks.bank_pixels(b) for b in stage_banks]
        else:
            ftrs = None
        stage_loss, p0, p1 = learner.fit_stage(
            model, X0, H0, X1, H1, allowed_features=ftrs,
            theta=theta_schedule(stage, learner.false_positive_rate))
        log.log(15, f"Stage {stage}: loss: {stage_loss:g}, fpr: {p0:g}, tpr: {p1:g}")
        for cb in callbacks:
            cb(model, learner, stage)

    return learner
