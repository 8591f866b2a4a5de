"""Sample-mining device programs + background bucket prewarm.

The training loops mine hard examples by scanning image batches with the
CURRENT cascade: one canvas program + one cascade program per batch
(per-image scans would pay one dispatch each), bit-packed survivor
transfer, and on-device crop gathers.  Because the cascade GROWS during
training, the scan recompiles at every stage-bucket crossing —
prewarm_mining_buckets front-loads all of a run's crossings into one
background compile thread.  model.py re-exports every name (tests and
scripts address waldboost_tpu.model.<name>).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ops import cascade as casc_ops
from .ops.cascade import cascade_response_grid
from .polyphase import _channel_canvas_batch


def prewarm_next_mining_bucket(model: "Model", logger=None):
    """Background-compile the NEXT length-bucket's mining program (thin
    wrapper over :func:`prewarm_mining_buckets` with a one-bucket
    horizon)."""
    T = len(model) if model.classifier else 0
    if T == 0:
        return None
    return prewarm_mining_buckets(model, type(model)._stage_bucket(T) + 1,
                                  logger=logger)


def prewarm_mining_buckets(model: "Model", length: int, logger=None):
    """Compile EVERY length-bucket mining cascade program a training run to
    ``length`` stages will need, in ONE background thread, overlapped with
    training.

    The mining scan recompiles whenever the growing cascade crosses a
    length bucket (type(model)._stage_bucket), a compile of seconds.  The
    jit cache keys on SHAPES and static metadata, not values, so padding
    the CURRENT stages to a future bucket compiles exactly the program that
    bucket's crossing will need.  The training loop knows its target
    ``length`` up front, so all crossings can start compiling at the first
    opportunity instead of one bucket ahead (a fast loop can reach the next
    crossing before a one-ahead compile finishes).  Buckets compile in
    crossing order so the nearest one is ready first.  Returns the started
    thread (or None when the geometry is unknown / everything is already
    warm).
    """
    geom = getattr(model, "_mining_geom", None)
    if geom is None or not model.classifier:
        return None
    T = len(model)
    cur = type(model)._stage_bucket(T)
    # the warmed set is keyed on the mining geometry: a geometry change
    # (new image shape / dtype) means every bucket's program is cold again
    geom_key = (tuple(geom[0]), str(geom[1]), tuple(geom[2]))
    prev_key, warmed = getattr(model, "_mining_warmed", (None, set()))
    if prev_key != geom_key:
        warmed = set()
    model._mining_warmed = (geom_key, warmed)
    targets = []
    b = cur
    end = type(model)._stage_bucket(max(int(length), 1))
    while b < end:
        b = type(model)._stage_bucket(b + 1)
        if b not in warmed:
            targets.append(b)
    if not targets:
        return None
    warmed.update(targets)
    # snapshot HOST-side state on this thread (model is mutated by the
    # stage loop); everything touching the device — including the cascade
    # table uploads in cascade_from_stages — runs in the background thread
    stages = [w.to_stage_dict() for w in model.classifier]
    thetas = list(model.theta)
    canvas_shape, canvas_dtype, valid_shape = geom
    m, n, _ = model.shape

    def compile_it():
        # REAL calls on dummy operands: .lower().compile() would populate
        # only the AOT path, not the jit dispatch cache the crossing hits.
        # Each executed program is one wasted scan; the compiles it
        # front-loads cost seconds apiece.
        for nxt in targets:
            try:
                casc, meta = casc_ops.cascade_from_stages(stages, thetas,
                                                          n_stages=nxt)
                cvs = jnp.zeros(canvas_shape, canvas_dtype)
                valid = jnp.zeros(valid_shape, bool)
                jax.block_until_ready(
                    _cascade_xla_batch_jit(cvs, casc, valid, (m, n), meta))
            except Exception as e:  # a cold crossing cache-miss, not an error
                # un-mark the bucket so the next prewarm call retries it
                # instead of leaving it falsely warm (the crossing would
                # silently pay the full blocking compile)
                warmed.discard(nxt)
                if logger is not None:
                    logger.debug("mining prewarm for bucket %d failed: %s",
                                 nxt, e)

    import threading
    t = threading.Thread(target=compile_it, daemon=True,
                         name=f"wb-prewarm-{targets[0]}")
    t.start()
    # track live prewarm threads on the model so training loops can join
    # them before returning: a daemon thread still inside an XLA call at
    # interpreter teardown aborts the process ("terminate called after
    # throwing ...")
    threads = [th for th in getattr(model, "_mining_prewarm_threads", [])
               if th.is_alive()]
    threads.append(t)
    model._mining_prewarm_threads = threads
    return t


def join_prewarm_threads(model, timeout: float = 300.0) -> None:
    """Wait for outstanding background mining-bucket compiles (a compile
    finishes in seconds; the timeout is an escape hatch for a hung one)."""
    for t in getattr(model, "_mining_prewarm_threads", []):
        t.join(timeout=timeout)
    model._mining_prewarm_threads = []


@functools.partial(jax.jit, static_argnames=("window",))
def _gather_windows_jit(canvas, rs, cs, window):
    """(C, U, V) canvas + (K,) origins -> (K, m, n, C) crops (HWC samples)."""
    m, n = window

    def crop(r, c):
        sl = jax.lax.dynamic_slice(canvas, (0, r, c),
                                   (canvas.shape[0], m, n))
        return jnp.transpose(sl, (1, 2, 0))

    return jax.vmap(crop)(rs, cs)


@functools.partial(jax.jit, static_argnames=("window",))
def _gather_windows_batch_jit(canvas, bs, rs, cs, window):
    """(B, C, U, V) canvas + (K,) per-crop (image, row, col) -> (K, m, n, C)
    crops — one device gather for a whole mining batch."""
    m, n = window

    def crop(b, r, c):
        sl = jax.lax.dynamic_slice(canvas, (b, 0, r, c),
                                   (1, canvas.shape[1], m, n))
        return jnp.transpose(sl[0], (1, 2, 0))

    return jax.vmap(crop)(bs, rs, cs)


@functools.partial(jax.jit, static_argnames=("window",))
def _gather_windows_scores_batch_jit(canvas, hs, bs, rs, cs, window):
    """Crops AND their cascade scores in ONE gather dispatch (fetch only
    what labeling kept)."""
    crops = _gather_windows_batch_jit(canvas, bs, rs, cs, window)
    scores = jax.vmap(lambda b, r, c: hs[b, r, c])(bs, rs, cs)
    return crops, scores


@jax.jit
def _packbits_jit(alive):
    """(B, GU, GV) bool -> (B, GU, ceil(GV/8)) uint8 (bit k of byte j is
    column 8*j+k): an 8x smaller survivor map for the device-to-host
    copy."""
    B, GU, GV = alive.shape
    GVp = -(-GV // 8) * 8
    a = jnp.pad(alive.astype(jnp.uint8), ((0, 0), (0, 0), (0, GVp - GV)))
    a = a.reshape(B, GU, GVp // 8, 8)
    weights_ = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(a * weights_, axis=-1, dtype=jnp.uint8)


@functools.partial(
    jax.jit,
    static_argnames=("shrink", "n_per_oct", "smooth", "cf", "packed"))
def _canvas_batch_jit(images, shrink, n_per_oct, smooth, cf, packed):
    """Stage 1 for a mining batch: (B, H, W) -> (B, C, Hc, Wc) canvases as
    ONE program (eager tracing would dispatch every op separately)."""
    return _channel_canvas_batch(images, shrink, n_per_oct, smooth, cf,
                                 packed)


@functools.partial(jax.jit, static_argnames=("window", "depth"))
def _cascade_xla_batch_jit(cvs, casc, valid, window, depth):
    """Mining cascade pass over a canvas batch: ``(hs, alive,
    n_weak_total)``.  Always the XLA lockstep evaluator: the cascade grows
    every stage, and mining on the serving kernel was never measured."""
    f = lambda cv: cascade_response_grid(cv, casc, window, depth,
                                         init_alive=valid)
    hs, alive, nw = jax.vmap(f)(cvs)
    return hs, alive, nw.sum()


def _run_packed_batch(images, casc, valid_mask, shrink, n_per_oct, smooth,
                      cf, window, depth, packed):
    """(B, H, W) same-shape mining batch -> (canvas, hs, alive, n_weak),
    batched: the canvas build and the cascade run as ONE jitted program
    each instead of B dispatch round-trips."""
    canvas = _canvas_batch_jit(images, shrink, n_per_oct, smooth, cf,
                               packed)
    hs, alive, n_weak = _cascade_xla_batch_jit(canvas, casc, valid_mask,
                                               window, depth)
    return canvas, hs, alive, n_weak
