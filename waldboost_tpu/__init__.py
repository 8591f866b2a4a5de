"""waldboost_tpu — a WaldBoost object-detection framework in JAX.

A from-scratch JAX/XLA/Pallas re-architecture with the full capabilities of
the CPU reference (RomanJuranek/waldboost): soft-cascade sliding-window
detectors over aggregated-channel-features-style image channels with SPRT
early rejection [1], FPGA-friendly quantized training, CNN post-verification,
and multi-device data-parallel detection/training via jax.sharding.
It runs compiled on an NVIDIA GPU, and on the CPU for tests.

Example
-------
    import waldboost_tpu as wb
    from waldboost_tpu.utils import fake_data_generator

    training_images = fake_data_generator()
    model = wb.Model((12, 12, 4), wb.default_channel_opts)
    wb.train(model, training_images, length=16)

    image = next(training_images)["image"]
    boxes = wb.detect(image, model)

References
----------
[1] Sochman et al.: WaldBoost — Learning for Time Constrained Sequential
    Detection, CVPR 2005 (cited at /root/reference/waldboost/__init__.py:201).
"""

import logging
import os

import numpy as np


def _enable_persistent_compilation_cache() -> None:
    """Keep compiled programs on disk so later processes skip recompiles.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and JAX reads
    it itself; otherwise the cache is ``.jax_cache`` in the checkout (a
    fixed path: the path is part of the cache key).  Every program is
    cached: the training loop's cost is many small-to-medium programs.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_persistent_compilation_cache()

from . import boxes as bbx  # noqa: F401  (public box substrate)
from . import channels, groundtruth, samples  # noqa: F401
from .boxes import Boxes  # noqa: F401
from .channels import default_channel_opts  # noqa: F401
from .model import Model
from .samples import SamplePool
from .training import BasicRejectionSchedule, DTree, Learner  # noqa: F401

__version__ = "0.1.0"

load = load_model = Model.load


def save_model(model: Model, filename: str) -> None:
    """Save model to file. See Model.save."""
    model.save(filename)


save = save_model


def detect(image: np.ndarray, *models: Model, channel_opts: dict = None,
           response_scale=None) -> Boxes:
    """Detect objects using multiple detectors sharing one channel pyramid.

    API parity with /root/reference/waldboost/__init__.py:75-130: returns
    boxes with 'scores' (scaled per model by ``response_scale``) and 'label'
    (emitting model index) fields.  NMS is left to the caller, as in the
    reference.
    """
    channel_opts = channel_opts or models[0].channel_opts
    if response_scale is None:
        response_scale = [1] * len(models)
    response_scale = np.array(response_scale, "f")
    if response_scale.size != len(models):
        raise ValueError("Wrong response_scale parameter")

    # fast path: all models share channel opts (window shapes may differ)
    # -> the packed channel canvas program EXECUTES once and each model's
    # cascade scans the same device-resident canvas with its own window
    # grid (model.detect_multi)
    from .channels import _normalize_opts
    opts_key = _normalize_opts(channel_opts)
    shared = all(_normalize_opts(m.channel_opts) == opts_key
                 for m in models)
    if shared:
        from .model import detect_multi
        return detect_multi(models, image, response_scale=response_scale)

    dt_boxes = []
    for chns, scale in channels.channel_pyramid(image, channel_opts):
        for k, model in enumerate(models):
            r, c, h = model.predict_on_image(chns)
            if r.size == 0:
                continue
            b = model.get_boxes(r, c, scale)
            b.set_field("scores", h * response_scale[k])
            b.set_field("label", np.full(r.size, k, dtype=np.int64))
            dt_boxes.append(b)
    return bbx.concatenate(dt_boxes, ["scores", "label"])


def train_softcascade(shape, channel_opts, length, training_images,
                      callbacks=(), casc_thr: float = -1.0,
                      pool: SamplePool = None):
    """Experimental constant-soft-cascade training
    (/root/reference/waldboost/__init__.py:230-269 — which warns "Do not use
    this function"; retained for API completeness, reimplemented without the
    reference's broken pieces).

    Trains ``len(length)`` sub-cascades of ``length[i]`` stages each with no
    per-stage rejection, then installs a constant rejection threshold.
    Returns the final model.
    """
    logging.warning("train_softcascade is experimental; prefer wb.train")
    pool = pool or SamplePool(min_tp=4000, min_fp=20000, min_tp_iou=0.75,
                              max_tp_candidates=5, max_fp_candidates=50)
    model = Model(shape, channel_opts)
    pool.update(model, training_images)

    for stage, stage_length in enumerate(length):
        learner = Learner(max_depth=2)
        for _ in range(stage_length):
            pool.update(model, training_images)
            X0, H0 = pool.get_false_positives()
            X1, H1 = pool.get_true_positives()
            learner.fit_stage(model, X0, H0, X1, H1, theta=float(-np.inf))
        model.theta = [casc_thr] * len(model)
        model._version += 1
        for cb in callbacks:
            cb(model, learner, stage)
        if stage == len(length) - 1:
            return model
        pool.update(model, training_images)
        if pool.samples is not None and len(pool.samples):
            scores = pool.samples.get_field("scores")
            pool.samples.set_field("scores", np.zeros_like(scores))
        model = Model(shape, channel_opts)
    return model


def train(model: Model,
          training_images,
          learner: Learner = None,
          pool: SamplePool = None,
          length: int = 64,
          theta_schedule=None,
          callbacks=(),
          logger: logging.Logger = None,
          mesh=None,
          prefetch: int = 16):
    """Train or continue training a detection model.

    Baseline pipeline with parity to /root/reference/waldboost/__init__.py:133-227:
    per stage — refill/re-score the sample pool, fit one weak classifier on
    exp-loss weights, fit the SPRT rejection threshold, run callbacks.

    ``training_images`` is an iterable/generator of dicts with keys
    ``"image"`` (H, W uint8/float ndarray) and ``"groundtruth_boxes"``
    (:class:`Boxes`, optional 'ignore' field).

    With ``mesh`` (a jax.sharding.Mesh), training runs the device path:
    a fixed-capacity device-resident sample pool sharded over the mesh's
    data axis, with the whole per-stage numeric step (weights, histogram
    tree fit, SPRT threshold, pruning) as one sharded device program —
    see waldboost_tpu.parallel.trainer.train_sharded.

    ``prefetch``: depth of the background-thread record prefetcher wrapped
    around ``training_images`` (io.Prefetcher) — the producer decodes while
    the device computes.  0 disables it.  Record order is preserved and no
    record is lost: on return the prefetcher is stopped and any queued-but-
    unconsumed records are handed back, so the next train() call on the
    same iterable resumes exactly where this one left off.  Sized iterables
    (lists, tuples — anything with ``__len__``) skip prefetching entirely.
    """
    logger = logger or logging.getLogger("Training")
    prefetcher = None
    source = training_images
    if prefetch and not hasattr(training_images, "__len__"):
        from .io import Prefetcher
        feed = training_images
        residue = _prefetch_residue.pop(id(source), (None, None))[1]
        if residue:
            import itertools
            feed = itertools.chain(residue, feed)
        prefetcher = Prefetcher(feed, depth=prefetch)
        training_images = iter(prefetcher)
    try:
        return _train_body(model, training_images, learner, pool, length,
                           theta_schedule, callbacks, logger, mesh)
    finally:
        if prefetcher is not None:
            leftover = prefetcher.stop()
            if leftover:
                # Keyed by id() with the source kept alive in the value so
                # the key can't be recycled; works for non-weakrefable
                # iterables too.
                _prefetch_residue[id(source)] = (source, leftover)


#: records pulled by train()'s prefetcher but not consumed, handed back to
#: the next train() call on the same iterable: {id(source): (source, [recs])}
_prefetch_residue: dict = {}


def _train_body(model, training_images, learner, pool, length,
                theta_schedule, callbacks, logger, mesh):
    if mesh is not None:
        from .parallel.trainer import train_sharded
        pool_kwargs = {}
        if pool is not None:
            pool_kwargs = dict(min_tp=pool.min_tp, min_fp=pool.min_fp,
                               seed=pool.seed, mine_batch=pool.mine_batch,
                               **pool.label_boxes_args)
        learner = learner or Learner(alpha=0.2, max_depth=2)
        wh_args = dict(learner.wh_args)
        return train_sharded(model, training_images, mesh=mesh,
                             learner=learner, length=length,
                             theta_schedule=theta_schedule,
                             max_depth=int(wh_args.get("max_depth", 2)),
                             callbacks=callbacks, logger=logger,
                             **pool_kwargs)

    if len(model) >= length:
        return learner

    learner = learner or Learner()
    if theta_schedule is None:
        theta_schedule = BasicRejectionSchedule()

    if len(model) != len(learner):
        raise RuntimeError("Model length and learner length are not consistent")

    if len(model) > 0:
        logger.info(f"{len(model)} stages are already present, continuing")

    pool = pool or SamplePool()

    if os.environ.get("WB_TRAIN_PREWARM", "1") == "1":
        # resumed models already know their mining geometry: start the
        # full-horizon bucket compiles before the first stage (no-op on a
        # fresh model — geometry appears with the first mining scan)
        from .model import prewarm_mining_buckets
        prewarm_mining_buckets(model, length, logger=logger)

    for stage in range(len(model), length):
        pool.update(model, training_images)
        X0, H0 = pool.get_false_positives()
        X1, H1 = pool.get_true_positives()
        stage_loss, p0, p1 = learner.fit_stage(
            model, X0, H0, X1, H1,
            theta=theta_schedule(stage, learner.false_positive_rate))
        logger.log(15, f"Stage {stage}: loss: {stage_loss:g}, fpr: {p0:g}, tpr: {p1:g}")
        if os.environ.get("WB_TRAIN_PREWARM", "1") == "1":
            # full-horizon prewarm (see parallel/trainer.py): every bucket
            # crossing up to ``length`` starts compiling in the background
            from .model import prewarm_mining_buckets
            prewarm_mining_buckets(model, length, logger=logger)
        for cb in callbacks:
            cb(model, learner, stage)

    from .model import join_prewarm_threads
    join_prewarm_threads(model)
    return learner
