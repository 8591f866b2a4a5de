"""Detection model: cascade container + device detection pipeline.

Re-architecture of the reference's waldboost/model.py for an accelerator:

* The classifier is compiled to a structure-of-arrays :class:`~waldboost_tpu.ops.cascade.Cascade`
  (padded static shapes, cached; rebuilt lazily when stages are appended).
* ``detect`` packs *all* pyramid levels into one channel canvas (shelf
  packing with window-sized gaps) and evaluates the whole cascade in a single
  static-shaped masked pass — one XLA program per (image-shape, opts,
  cascade-shape) instead of one per pyramid level.  Windows in gaps/padding
  are pre-killed via a static mask, so the survivor set is identical to the
  reference's per-level loop (/root/reference/waldboost/model.py:149-179).
* ``predict`` / ``predict_on_image`` / ``scan_channels`` keep the reference
  API (used by training and sample mining).
* Serialization is wire-compatible proto3 (pure-Python codec, zlib level 9,
  /root/reference/waldboost/model.py:324-344) with a safe channel-function
  registry instead of ``eval`` (/root/reference/waldboost/model.py:23-29).
"""

from __future__ import annotations

import functools
import os
import zlib
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import boxes as bbx
from .boxes import Boxes
from .channels import _normalize_opts, resolve_channel_function
from .ops import cascade as casc_ops
from .ops.cascade import Cascade, cascade_predict_samples, cascade_response_grid
# packing planner / polyphase canvas pipelines: decomposed out of this
# module round 4 (re-exported here — serving code and tests address them
# as waldboost_tpu.model.<name>)
from .packing import (PackedLevel, PackedPyramidPlan,  # noqa: F401
                      _band_rows, _packed_plan_cached)
from .polyphase import (_channel_canvas_batch,  # noqa: F401
                        _channel_canvas_fast, _channel_canvas_per_level,
                        _channel_canvas_poly, _combine_block, _ext_pm_taps,
                        _poly_channels, _poly_level_blocks, _poly_planes)
from .mining import (_canvas_batch_jit,  # noqa: F401
                     _cascade_xla_batch_jit,
                     _gather_windows_batch_jit, _gather_windows_jit,
                     _gather_windows_scores_batch_jit, _packbits_jit,
                     _run_packed_batch, join_prewarm_threads,
                     prewarm_mining_buckets, prewarm_next_mining_bucket)
from .proto import codec

__all__ = ["Model", "PackedPyramidPlan"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


#: monotone Model instance ids (collision-free where id() is not)
import itertools as _itertools

_MODEL_UID = _itertools.count()


# ---------------------------------------------------------------------------
# jitted device programs (module-level for cross-model cache sharing)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("window", "depth"))
def _grid_eval_jit(chns_chw, casc: Cascade, window, depth):
    return cascade_response_grid(chns_chw, casc, window, depth)


@functools.partial(jax.jit, static_argnames=("shape", "depth"))
def _predict_jit(x, casc: Cascade, shape, depth, valid=None):
    return cascade_predict_samples(x, casc, depth, valid=valid)


def _packed_body(image, casc: Cascade, valid_mask, shrink, n_per_oct,
                 smooth, cf, window, depth, packed: PackedPyramidPlan):
    """Channels for every level -> packed canvas -> one cascade pass."""
    if cf.canvas_fn is not None:
        canvas = _channel_canvas_fast(image, shrink, smooth, cf, packed)
        canvas = canvas.astype(jnp.float32)
    else:
        canvas = _channel_canvas_per_level(image, shrink, n_per_oct, smooth,
                                           cf, packed)
    hs, alive, n_weak = cascade_response_grid(canvas, casc, window, depth,
                                              init_alive=valid_mask)
    return canvas, hs, alive, n_weak


@functools.partial(
    jax.jit,
    static_argnames=("shrink", "n_per_oct", "smooth", "cf", "packed"),
)
def _canvas_jit(image, shrink, n_per_oct, smooth, cf,
                packed: PackedPyramidPlan):
    """Stage 1: packed channel canvas (f32, CHW)."""
    if cf.canvas_fn is not None:
        canvas = _channel_canvas_fast(image, shrink, smooth, cf, packed)
        return canvas.astype(jnp.float32)
    return _channel_canvas_per_level(image, shrink, n_per_oct, smooth, cf,
                                     packed)


@functools.partial(jax.jit, static_argnames=("window", "depth"))
def _canvas_cascade_jit(canvas, casc: Cascade, valid_mask, window, depth):
    """Stage 2: masked lockstep cascade over the canvas.

    A separate XLA program from the canvas build (:func:`_canvas_jit`), so
    the two compile and cache independently."""
    return cascade_response_grid(canvas, casc, window, depth,
                                 init_alive=valid_mask)


#: frozen-cascade serving engine: "triton" (the Pallas kernel of
#: ops.cascade_kernel: runtime node tables, tile-level SPRT exit) or "xla"
#: (the lockstep masked scan).  The training path's mining scans always take
#: the XLA lockstep evaluator.
_CASCADE_BACKEND = os.environ.get("WALDBOOST_TPU_CASCADE", "triton")


def set_cascade_backend(name: str) -> None:
    """Select the serving cascade engine ("triton" | "xla")."""
    global _CASCADE_BACKEND
    if name not in ("xla", "triton"):
        raise ValueError(f"unknown cascade backend {name!r}")
    _CASCADE_BACKEND = name


def _resolve_cascade_backend() -> str:
    """The serving cascade engine, checked at its point of use."""
    if _CASCADE_BACKEND not in ("xla", "triton"):
        raise ValueError(f"unknown cascade backend {_CASCADE_BACKEND!r}")
    return _CASCADE_BACKEND


def _run_cascade_serving(canvas, model: "Model", valid_mask, window):
    """Frozen-cascade detection dispatch (single image or batch canvas)."""
    casc, meta = model._get_cascade()
    if _resolve_cascade_backend() == "triton":
        from .ops.cascade_kernel import cascade_dense
        if canvas.ndim == 3:
            hs, alive, nw = cascade_dense(canvas[None], casc, meta,
                                          valid_mask, window)
            return hs[0], alive[0], nw[0]
        return cascade_dense(canvas, casc, meta, valid_mask, window)
    if canvas.ndim == 4:
        f = lambda cv: _canvas_cascade_jit(cv, casc, valid_mask, window, meta)
        return jax.vmap(f)(canvas)
    return _canvas_cascade_jit(canvas, casc, valid_mask, window, meta)


def _run_packed(image, casc, valid_mask, shrink, n_per_oct, smooth, cf,
                window, depth, packed):
    canvas = _canvas_jit(image, shrink, n_per_oct, smooth, cf, packed)
    hs, alive, n_weak = _canvas_cascade_jit(canvas, casc, valid_mask, window,
                                            depth)
    return canvas, hs, alive, n_weak


def _run_packed_serving(image, model: "Model", valid_mask, shrink, n_per_oct,
                        smooth, cf, window, packed):
    canvas = _canvas_jit(image, shrink, n_per_oct, smooth, cf, packed)
    hs, alive, n_weak = _run_cascade_serving(canvas, model, valid_mask, window)
    return canvas, hs, alive, n_weak


def detect_multi(models, image, response_scale=None):
    """Multi-model detection over ONE shared channel canvas.

    The packed channel canvas (the expensive pyramid program) is computed
    once; each model's cascade then scans the SAME device-resident canvas.
    Scores are scaled per model by ``response_scale`` and boxes carry a
    'label' field with the emitting model index — the device analog of
    /root/reference/waldboost/__init__.py:75-130 (one pyramid, K models).
    Models must share channel options (the reference's shared-pyramid loop
    implicitly assumes compatible channels too); window shapes may DIFFER —
    the canvas is planned from the elementwise-min window so every model's
    usable levels exist, and each model scans it with its own window grid
    and validity mask.
    """
    from .channels import _normalize_opts

    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError("Image must have 2 dimensions")
    model0 = models[0]
    key0 = _normalize_opts(model0.channel_opts)
    if not all(_normalize_opts(mm.channel_opts) == key0 for mm in models):
        raise ValueError("detect_multi needs models sharing channel options")
    if response_scale is None:
        response_scale = [1.0] * len(models)
    shrink, n_per_oct, smooth, cf = key0
    m_min = min(mm.shape[0] for mm in models)
    n_min = min(mm.shape[1] for mm in models)
    packed = _packed_plan_cached(image.shape[0], image.shape[1], shrink,
                                 n_per_oct, (m_min, n_min), halo=cf.halo)
    empty = lambda: bbx.empty_boxes(scores=np.empty(0, np.float32),
                                    label=np.empty(0, np.int64))
    if not packed.levels:
        return empty()
    canvas = _canvas_jit(jnp.asarray(image), shrink, n_per_oct, smooth, cf,
                         packed)  # ONCE for all models
    geom = {}  # per-window-shape valid mask + level maps
    out = []
    for kix, mm in enumerate(models):
        m, n, _ = mm.shape
        if (m, n) not in geom:
            level_id_map, inv_scales = packed.level_maps((m, n))
            geom[(m, n)] = (jnp.asarray(packed.valid_mask((m, n))),
                            level_id_map, inv_scales,
                            int((level_id_map >= 0).sum()))
        valid, level_id_map, inv_scales, n_valid = geom[(m, n)]
        casc, depth = mm._get_cascade()
        rs = cs = scores = None
        if casc.n_stages > TWO_PHASE_PREFIX:
            # same two-phase compaction as Model.detect: only the compacted
            # survivor set crosses the (slow) device->host link; exact
            # whenever phase-1 survivors fit the capacity
            gv = packed.canvas_w - n
            idx, H, aliveK, n_weak, count1 = _two_phase_jit(
                canvas, casc, valid, (m, n), depth)
            if int(count1) <= min(TWO_PHASE_CAPACITY, valid.size):
                mm._track_cost(int(n_weak), n_valid)
                sel = np.asarray(aliveK)
                idxs = np.asarray(idx)[sel]
                scores = np.asarray(H)[sel]
                rs, cs = idxs // gv, idxs % gv
        if rs is None:
            hs, alive, n_weak = _run_cascade_serving(canvas, mm, valid,
                                                     (m, n))
            mm._track_cost(int(n_weak), n_valid)
            alive_np = np.asarray(alive)
            rs, cs = np.nonzero(alive_np)
            scores = np.asarray(hs)[rs, cs] if rs.size \
                else np.empty(0, np.float32)
        b = mm._boxes_from_canvas_origins(rs, cs,
                                          scores * float(response_scale[kix]),
                                          packed, level_id_map, inv_scales)
        b.set_field("label", np.full(len(b), kix, dtype=np.int64))
        out.append(b)
    return bbx.concatenate(out, ["scores", "label"]) if out else empty()


#: lockstep stage-prefix length and survivor capacity of two-phase evaluation
TWO_PHASE_PREFIX = 12
TWO_PHASE_CAPACITY = 4096


@functools.partial(jax.jit, static_argnames=("window", "meta", "k1",
                                             "capacity"))
def _two_phase_jit(canvas, casc: Cascade, valid_mask, window, meta,
                   k1: int = TWO_PHASE_PREFIX,
                   capacity: int = TWO_PHASE_CAPACITY):
    """Two-phase cascade: lockstep stages [0:k1) over the whole grid, then
    top-``capacity`` survivor compaction and per-window gather evaluation of
    stages [k1:T).  Exact (monotone rejection) as long as phase-1 survivors
    fit in ``capacity`` — the returned count lets callers detect overflow and
    fall back to the dense path.

    Returns (idx, scores, alive, n_weak, phase1_count): flattened window-grid
    indices of candidate survivors, their final scores, survivor mask, the
    exact weak-eval counter, and the phase-1 survivor count.
    """
    from .ops.cascade import cascade_suffix_sparse, slice_cascade

    T = casc.n_stages
    k1 = min(k1, T)
    pre = slice_cascade(casc, 0, k1)
    if _resolve_cascade_backend() == "triton":
        from .ops.cascade_kernel import cascade_dense
        hs1, alive1, nw1 = (x[0] for x in cascade_dense(
            canvas[None], pre, meta, valid_mask, window))
    else:
        hs1, alive1, nw1 = cascade_response_grid(canvas, pre, window, meta,
                                                 init_alive=valid_mask)
    flat = jnp.where(alive1, hs1, -jnp.inf).reshape(-1)
    cap = min(capacity, flat.shape[0])
    scores, idx = jax.lax.top_k(flat, cap)
    aliveK = jnp.isfinite(scores)
    count1 = jnp.sum(alive1, dtype=jnp.int32)
    H, aliveK, nw2 = cascade_suffix_sparse(canvas, casc, window, meta,
                                           idx, scores, aliveK, k1)
    return idx, H, aliveK, nw1 + nw2, count1


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    """Detection model: window shape + channel opts + soft cascade.

    API parity with /root/reference/waldboost/model.py:32 (``predict``,
    ``predict_on_image``, ``detect``, ``channels``, ``scan_channels``,
    ``get_boxes``, ``append``, ``save``/``load``, ``eval_cost``).
    """

    #: pad stage count to a multiple of this to stabilise jit cache keys
    #: while the model grows during training
    STAGE_PAD = 8

    def __init__(self, shape, channel_opts):
        self.shape = tuple(int(s) for s in shape)
        opts = dict(channel_opts)
        opts["channels"] = resolve_channel_function(opts["channels"])
        self.channel_opts = opts
        self.classifier: List = []
        self.theta: List[float] = []
        self._cascade: Optional[Cascade] = None
        self._cascade_depth = 0
        self._cascade_version = -1
        self._version = 0
        #: process-unique instance id (id() is reused after GC — a pools
        #: carry-over tag keyed on it could false-match a NEW model landing
        #: on a freed address; see parallel.trainer's model_tag)
        self._uid = next(_MODEL_UID)
        self.reset()

    # -- stats ---------------------------------------------------------
    @property
    def eval_cost(self) -> float:
        """Average number of weak-classifier evaluations per scanned window
        (/root/reference/waldboost/model.py:69-89)."""
        return self.n_weak / self.n_loc if self.n_loc > 0 else 0

    def reset(self) -> None:
        self.n_loc = 0
        self.n_weak = 0
        #: worst-case counters (the reference's unfinished roadmap item
        #: "Keep worst case eval. cost", /root/reference/NOTES.md:70):
        #: highest per-scan average weak evals and number of scans tracked
        self.n_images = 0
        self.worst_eval_cost = 0.0
        #: accumulated per-stage survivor counts (see survivor_histogram)
        self.stage_survivors = None

    def _track_cost(self, n_weak: int, n_loc: int, images: int = 1) -> None:
        """Fold one scan's counters into the running totals AND the
        worst-case stats.  ``images`` > 1 marks a batched scan whose
        per-image breakdown is unavailable (the batch average is then one
        worst-case sample — a lower bound on the true per-image max)."""
        self.n_weak += n_weak
        self.n_loc += n_loc
        if n_loc > 0:
            self.n_images += images
            self.worst_eval_cost = max(self.worst_eval_cost, n_weak / n_loc)

    def cost_stats(self) -> dict:
        """Cascade-efficiency counters: running average, worst-case scan,
        and the accumulated per-stage survivor histogram (None until
        :meth:`survivor_histogram` has run)."""
        return {
            "eval_cost": self.eval_cost,
            "worst_eval_cost": self.worst_eval_cost,
            "n_images": self.n_images,
            "n_loc": self.n_loc,
            "n_weak": self.n_weak,
            "stage_survivors": (None if self.stage_survivors is None
                                else np.asarray(self.stage_survivors)),
        }

    def survivor_histogram(self, image) -> np.ndarray:
        """Per-stage survivor counts for one image: ``out[t]`` = windows
        still alive ENTERING stage ``t`` over the full packed pyramid.
        Accumulates into ``self.stage_survivors`` (reset on cascade
        growth).  A diagnostic pass over the XLA cascade backend; the
        serving kernels are untouched."""
        from .ops.cascade import cascade_survivor_counts

        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("Image must have 2 dimensions")
        m, n, _ = self.shape
        shrink, n_per_oct, smooth, cf = _normalize_opts(self.channel_opts)
        packed = _packed_plan_cached(image.shape[0], image.shape[1], shrink,
                                     n_per_oct, (m, n), halo=cf.halo)
        T = len(self)
        if not packed.levels or T == 0:
            return np.zeros(T, np.int64)
        valid = jnp.asarray(packed.valid_mask((m, n)))
        casc, depth = self._get_cascade()
        canvas = _canvas_jit(jnp.asarray(image), shrink, n_per_oct, smooth,
                             cf, packed)
        counts, n_weak = jax.jit(
            cascade_survivor_counts, static_argnums=(2, 3))(
                canvas, casc, (m, n), depth, init_alive=valid)
        # cascade tables are padded to the jit stage bucket (inactive
        # stages); the histogram reports the real stages only
        counts = np.asarray(counts).astype(np.int64)[:T]
        level_id_map, _ = packed.level_maps((m, n))
        self._track_cost(int(n_weak), int((level_id_map >= 0).sum()))
        if (self.stage_survivors is None
                or len(self.stage_survivors) != len(counts)):
            self.stage_survivors = np.zeros(len(counts), np.int64)
        self.stage_survivors += counts
        return counts

    # -- container protocol ---------------------------------------------
    def __getitem__(self, i):
        return self.classifier[i], self.theta[i]

    def __len__(self) -> int:
        return len(self.classifier)

    def __bool__(self) -> bool:
        return bool(self.classifier)

    def __iter__(self):
        yield from zip(self.classifier, self.theta)

    def append(self, weak, theta: float) -> None:
        self.classifier.append(weak)
        self.theta.append(float(theta))
        self._version += 1

    # -- cascade compilation ---------------------------------------------
    @staticmethod
    def _stage_bucket(T: int) -> int:
        """Length-bucket of a T-stage cascade: hybrid stage buckets, linear
        (xSTAGE_PAD) while small, geometric beyond 32 — a growing training
        cascade then recompiles its consumers O(log T) times instead of
        O(T/8) (each recompile of the mining/rescore programs costs
        seconds); padded stages are dead (zero response, theta=-inf)."""
        T = max(T, 1)
        if T <= 32:
            return max(_round_up(T, Model.STAGE_PAD), Model.STAGE_PAD)
        return 1 << (T - 1).bit_length()

    def _get_cascade(self) -> Tuple[Cascade, int]:
        if self._cascade is None or self._cascade_version != self._version:
            stages = [w.to_stage_dict() for w in self.classifier]
            pad_T = self._stage_bucket(len(stages))
            casc, meta = casc_ops.cascade_from_stages(stages, self.theta, n_stages=pad_T)
            self._cascade = casc
            self._cascade_depth = meta  # CascadeMeta (hashable, jit-static)
            self._cascade_version = self._version
        return self._cascade, self._cascade_depth

    # -- channels ---------------------------------------------------------
    def channels(self, image):
        """Iterator over the channel pyramid (HWC numpy per level)."""
        from .channels import channel_pyramid
        yield from channel_pyramid(image, self.channel_opts)

    def scan_channels(self, image):
        """Yield ``(chns, scale, (r, c, h))`` per level — the mining entry
        point (/root/reference/waldboost/model.py:105-134)."""
        for chns, scale in self.channels(image):
            yield chns, scale, self.predict_on_image(chns)

    # -- boxes --------------------------------------------------------------
    def get_boxes(self, r, c, scale) -> Boxes:
        """Window origins (r, c) at pyramid scale -> XYXY boxes in image space
        (/root/reference/waldboost/model.py:136-147)."""
        r = np.asarray(r)
        c = np.asarray(c)
        if r.size == 0:
            return Boxes(np.empty((0, 4), np.float32))
        m, n = self.shape[:2]
        x1 = c.reshape(-1, 1).astype(np.float32)
        y1 = r.reshape(-1, 1).astype(np.float32)
        rects = np.concatenate([x1, y1, x1 + n, y1 + m], axis=1)
        return Boxes(rects).normalized(scale=1.0 / scale)

    # -- inference ----------------------------------------------------------
    def predict(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """Cascade scores for a batch of samples (N,)+shape.  Rejected samples
        get -inf (/root/reference/waldboost/model.py:181-214)."""
        X = np.asarray(X)
        n, *shape = X.shape
        assert tuple(shape) == tuple(self.shape), \
            f"Invalid shape of X. Expected {self.shape}, given {shape}"
        if not self.classifier:
            return np.zeros(n, np.float32), np.ones(n, bool)
        if n == 0:
            return np.zeros(0, np.float32), np.zeros(0, bool)
        casc, depth = self._get_cascade()
        # power-of-2 batch-size buckets, min 256 (pools grow/shrink every
        # stage — each padded size is a fresh XLA compile; O(log N)
        # bucketing keeps it to a handful per training run)
        pad = max(256, 1 << (n - 1).bit_length()) - n
        Xp = np.pad(X, ((0, pad),) + ((0, 0),) * (X.ndim - 1))
        valid = np.zeros(n + pad, bool)
        valid[:n] = True
        H, mask = _predict_jit(jnp.asarray(Xp), casc, tuple(self.shape),
                               depth, jnp.asarray(valid))
        return np.asarray(H)[:n], np.asarray(mask)[:n]

    def predict_on_image(self, X) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Evaluate the cascade on all window origins of an HWC channel image.
        Returns surviving ``(rs, cs, hs)`` (/root/reference/waldboost/model.py:216-259)."""
        X = np.asarray(X) if not isinstance(X, jax.Array) else X
        u, v, ch_image = X.shape
        m, n, ch_cls = self.shape
        assert ch_image == ch_cls, \
            f"Invalid number of channels. Expected {ch_cls} given {ch_image}."
        gu, gv = max(u - m, 0), max(v - n, 0)
        if gu == 0 or gv == 0:
            e = np.empty(0, np.int64)
            return e, e, np.empty(0, np.float32)
        if not self.classifier:
            self._track_cost(0, gu * gv)
            rs, cs = np.indices((gu, gv))
            return rs.flatten(), cs.flatten(), np.zeros(gu * gv, np.float32)
        casc, depth = self._get_cascade()
        chw = jnp.transpose(jnp.asarray(X), (2, 0, 1))
        hs, alive, n_weak = _grid_eval_jit(chw, casc, (m, n), depth)
        self._track_cost(int(n_weak), gu * gv)
        alive = np.asarray(alive)
        rs, cs = np.nonzero(alive)
        return rs, cs, np.asarray(hs)[rs, cs]

    def scan_packed(self, image):
        """Single-pass pyramid scan for sample mining.

        Runs the packed-canvas pipeline once and returns
        ``(canvas, packed_plan, rs, cs, hs)`` where ``rs``/``cs`` are
        *canvas* coordinates of surviving window origins and ``canvas`` is
        the (C, H, W) channel canvas as a DEVICE array holding every level's
        channels — crop windows with :meth:`gather_windows_device` (device
        gather + small transfer) instead of pulling the canvas to the host.
        Returns ``None`` when the image is too small for any level.  Updates
        eval-cost counters like ``predict_on_image`` does.
        """
        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("Image must have 2 dimensions")
        m, n, _ = self.shape
        shrink, n_per_oct, smooth, cf = _normalize_opts(self.channel_opts)
        packed = _packed_plan_cached(image.shape[0], image.shape[1], shrink,
                                     n_per_oct, (m, n), halo=cf.halo)
        if not packed.levels:
            return None
        valid = jnp.asarray(packed.valid_mask((m, n)))
        casc, depth = self._get_cascade()
        canvas, hs, alive, n_weak = _run_packed(
            jnp.asarray(image), casc, valid, shrink, n_per_oct, smooth, cf,
            (m, n), depth, packed)
        level_id_map, _ = packed.level_maps((m, n))
        self._track_cost(int(n_weak), int((level_id_map >= 0).sum()))
        alive_np = np.asarray(alive)
        rs, cs = np.nonzero(alive_np)
        scores = np.asarray(hs)[rs, cs] if rs.size else np.empty(0, np.float32)
        return canvas, packed, rs, cs, scores

    def scan_packed_batch(self, images, n_real: Optional[int] = None):
        """Batched :meth:`scan_packed`: scan B same-shape images with ONE
        canvas program and ONE cascade program (per-image scans would pay
        one dispatch each).

        ``n_real``: number of leading images that are real (the rest are
        jit-bucket padding, skipped in outputs and eval-cost counters).
        Returns ``(canvas (B,C,H,W) device, hs (B,GU,GV) device, packed,
        [(rs, cs)] * n)`` or None when the image is too small for any
        level — survivor scores stay on device (fetch the kept ones via
        _gather_windows_scores_batch_jit)."""
        images = np.asarray(images)
        if images.ndim != 3:
            raise ValueError("images must be (B, H, W)")
        n_real = images.shape[0] if n_real is None else int(n_real)
        m, n, _ = self.shape
        shrink, n_per_oct, smooth, cf = _normalize_opts(self.channel_opts)
        packed = _packed_plan_cached(images.shape[1], images.shape[2],
                                     shrink, n_per_oct, (m, n),
                                     halo=cf.halo)
        if not packed.levels:
            return None
        valid = jnp.asarray(packed.valid_mask((m, n)))
        casc, depth = self._get_cascade()
        canvas, hs, alive, n_weak = _run_packed_batch(
            jnp.asarray(images), casc, valid, shrink, n_per_oct, smooth,
            cf, (m, n), depth, packed)
        # remember the mining program geometry so the training loops can
        # prewarm the NEXT length-bucket's program in the background
        # (prewarm_next_mining_bucket) instead of stalling at the crossing
        self._mining_geom = (tuple(canvas.shape), canvas.dtype,
                             tuple(valid.shape))
        level_id_map, _ = packed.level_maps((m, n))
        # batch n_weak includes padding images; keep the counter a close
        # estimate by scaling (eval_cost is a diagnostic running average)
        self._track_cost(int(n_weak) * n_real // images.shape[0],
                         int((level_id_map >= 0).sum()) * n_real,
                         images=n_real)
        # transfer the survivor map BIT-PACKED (8x fewer bytes to the
        # host); scores stay ON DEVICE — callers fetch them only for the
        # windows labeling kept, fused with the crop gather
        packed_alive = np.asarray(_packbits_jit(alive))
        gv = alive.shape[-1]
        bits = np.unpackbits(packed_alive, axis=-1,
                             bitorder="little")[:, :, :gv]
        per_image = []
        for i in range(n_real):
            rs, cs = np.nonzero(bits[i])
            per_image.append((rs, cs))
        return canvas, hs, packed, per_image

    def gather_windows_device(self, image_or_canvas, rs, cs,
                              is_canvas: bool = False,
                              as_device: bool = False):
        """Crop (m, n, C) windows at canvas origins on device and transfer
        only the crops (vmapped dynamic_slice) — the training-mining path's
        replacement for pulling the whole channel canvas to the host.

        ``as_device=True`` returns ``(crops_dev, k)`` with the bucket-padded
        crops still device-resident (k real rows first) — consumers that
        keep computing on device (the CNN verifier program) skip the
        windows' host round-trip entirely."""
        m, n, _ = self.shape
        if is_canvas:
            canvas = image_or_canvas
        else:
            shrink, n_per_oct, smooth, cf = _normalize_opts(self.channel_opts)
            image = np.asarray(image_or_canvas)
            packed = _packed_plan_cached(image.shape[0], image.shape[1],
                                         shrink, n_per_oct, (m, n),
                                         halo=cf.halo)
            canvas = _canvas_jit(jnp.asarray(image), shrink, n_per_oct,
                                 smooth, cf, packed)
        rs = np.asarray(rs, np.int32)
        cs = np.asarray(cs, np.int32)
        k = rs.size
        if k == 0:
            empty = np.empty((0, m, n, canvas.shape[0]),
                             np.dtype(str(canvas.dtype)))
            return (jnp.asarray(empty), 0) if as_device else empty
        # bucket the crop count so jit compiles O(log K) programs, not O(K)
        pad = max(64, 1 << (k - 1).bit_length()) - k
        rs_p = jnp.asarray(np.pad(rs, (0, pad)))
        cs_p = jnp.asarray(np.pad(cs, (0, pad)))
        crops = _gather_windows_jit(canvas, rs_p, cs_p, (m, n))
        if as_device:
            return crops, k
        return np.asarray(crops[:k])

    def detect(self, image) -> Boxes:
        """Detect objects: full pyramid + cascade in one packed device pass.
        Returns surviving window boxes with a 'scores' field (pre-NMS), the
        same set the reference's per-level loop produces
        (/root/reference/waldboost/model.py:149-179)."""
        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("Image must have 2 dimensions")
        m, n, _ = self.shape
        shrink, n_per_oct, smooth, cf = _normalize_opts(self.channel_opts)
        packed = _packed_plan_cached(image.shape[0], image.shape[1], shrink,
                                     n_per_oct, (m, n), halo=cf.halo)
        if not packed.levels:
            return bbx.empty_boxes(scores=np.empty(0, np.float32))
        valid = jnp.asarray(packed.valid_mask((m, n)))
        casc, depth = self._get_cascade()
        level_id_map, inv_scales = packed.level_maps((m, n))
        n_valid = int((level_id_map >= 0).sum())
        gv = packed.canvas_w - n

        # two-phase fast path: lockstep prefix + compacted suffix (exact as
        # long as phase-1 survivors fit the capacity; the count tells us)
        if casc.n_stages > TWO_PHASE_PREFIX:
            canvas = _canvas_jit(jnp.asarray(image), shrink, n_per_oct,
                                 smooth, cf, packed)
            idx, H, aliveK, n_weak, count1 = _two_phase_jit(
                canvas, casc, valid, (m, n), depth)
            if int(count1) <= min(TWO_PHASE_CAPACITY, valid.size):
                self._track_cost(int(n_weak), n_valid)
                sel = np.asarray(aliveK)
                idx = np.asarray(idx)[sel]
                scores = np.asarray(H)[sel]
                rs, cs = idx // gv, idx % gv
                return self._boxes_from_canvas_origins(
                    rs, cs, scores, packed, level_id_map, inv_scales)
            # overflow: fall through to the dense path (n_weak discarded)

        _, hs, alive, n_weak = _run_packed_serving(
            jnp.asarray(image), self, valid, shrink, n_per_oct, smooth, cf,
            (m, n), packed)
        self._track_cost(int(n_weak), n_valid)
        alive_np = np.asarray(alive)
        rs, cs = np.nonzero(alive_np)
        scores = np.asarray(hs)[rs, cs] if rs.size else np.empty(0, np.float32)
        return self._boxes_from_canvas_origins(rs, cs, scores, packed,
                                               level_id_map, inv_scales)

    def _boxes_from_canvas_origins(self, rs, cs, scores, packed,
                                   level_id_map, inv_scales) -> Boxes:
        """Canvas window origins -> image-space boxes with scores."""
        if np.size(rs) == 0:
            return bbx.empty_boxes(scores=np.empty(0, np.float32))
        m, n, _ = self.shape
        lid = level_id_map[rs, cs]
        offs = np.array([(pl.y, pl.x) for pl in packed.levels], np.int64)
        local_r = rs - offs[lid, 0]
        local_c = cs - offs[lid, 1]
        x1 = local_c.astype(np.float32)
        y1 = local_r.astype(np.float32)
        rects = np.stack([x1, y1, x1 + n, y1 + m], axis=1)
        rects *= inv_scales[lid][:, None]
        out = Boxes(rects)
        out.set_field("scores", np.asarray(scores, np.float32))
        return out

    def detect_topk(self, image, k: int = 1024, nms_iou: Optional[float] = None) -> Boxes:
        """Detect with fully on-device extraction: the k highest-scoring
        surviving windows are mapped to image-space boxes on the device
        (single top_k + lookup, no dense host transfer), optionally followed
        by on-device NMS.  Use for throughput paths; ``detect`` returns the
        complete survivor set.
        """
        from .ops.nms import nms_device, topk_detections

        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("Image must have 2 dimensions")
        m, n, _ = self.shape
        shrink, n_per_oct, smooth, cf = _normalize_opts(self.channel_opts)
        packed = _packed_plan_cached(image.shape[0], image.shape[1], shrink,
                                     n_per_oct, (m, n), halo=cf.halo)
        if not packed.levels:
            return bbx.empty_boxes(scores=np.empty(0, np.float32))
        valid = jnp.asarray(packed.valid_mask((m, n)))
        _, hs, alive, n_weak = _run_packed_serving(
            jnp.asarray(image), self, valid, shrink, n_per_oct, smooth, cf,
            (m, n), packed)
        level_id_map, inv_scales = packed.level_maps((m, n))
        self._track_cost(int(n_weak), int((level_id_map >= 0).sum()))
        offsets = np.array([(pl.y, pl.x) for pl in packed.levels], np.int32)
        rects, scores, valid_k = topk_detections(
            hs, alive, jnp.asarray(level_id_map), jnp.asarray(offsets),
            jnp.asarray(inv_scales), jnp.asarray([m, n]), k=int(k))
        if nms_iou is not None:
            keep = nms_device(rects, scores, valid_k, iou_threshold=float(nms_iou))
            valid_k = jnp.logical_and(valid_k, keep)
        rects = np.asarray(rects)
        scores = np.asarray(scores)
        sel = np.asarray(valid_k)
        out = Boxes(rects[sel])
        out.set_field("scores", scores[sel].astype(np.float32))
        return out

    # -- serialization -----------------------------------------------------
    def as_proto(self, proto) -> None:
        proto.Clear()
        proto.shape.extend(self.shape)
        proto.channel_opts.shrink = int(self.channel_opts["shrink"])
        proto.channel_opts.n_per_oct = int(self.channel_opts["n_per_oct"])
        proto.channel_opts.smooth = int(self.channel_opts["smooth"])
        proto.channel_opts.func = self.channel_opts["channels"].name
        for weak, theta in self:
            w_pb = proto.classifier.add()
            weak.as_proto(w_pb)
            proto.theta.append(theta)

    @staticmethod
    def from_proto(proto) -> "Model":
        from .training import DTree
        shape = tuple(proto.shape)
        channel_opts = {
            "shrink": proto.channel_opts.shrink,
            "n_per_oct": proto.channel_opts.n_per_oct,
            "smooth": proto.channel_opts.smooth,
            "channels": resolve_channel_function(proto.channel_opts.func),
        }
        M = Model(shape, channel_opts)
        for weak_proto, theta_proto in zip(proto.classifier, proto.theta):
            M.append(DTree.from_proto(weak_proto), theta_proto)
        return M

    def save(self, filename: str) -> None:
        proto = codec.Model()
        self.as_proto(proto)
        data = zlib.compress(proto.SerializeToString(), 9)
        with open(filename, "wb") as f:
            f.write(data)

    @staticmethod
    def load(filename: str) -> "Model":
        with open(filename, "rb") as f:
            data = f.read()
        proto = codec.Model()
        try:
            proto.ParseFromString(zlib.decompress(data))
        except (zlib.error, ValueError):
            raise ValueError(f"Cannot read model from {filename}") from None
        return Model.from_proto(proto)
