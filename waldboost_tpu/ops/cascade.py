"""Soft-cascade (WaldBoost) evaluation as static-shaped, masked XLA programs.

Data-parallel re-expression of the reference's branchy SPRT cascade
(/root/reference/waldboost/model.py:181-259 and
/root/reference/waldboost/training.py:73-96):

* Decision trees are stored structure-of-arrays: per-stage node tables
  ``(feature_row, feature_col, feature_channel, threshold, left, right,
  prediction)`` padded to a common node count ``NN`` across stages.
* Dense sliding-window evaluation exploits that a pixel-comparison feature
  over *all* window origins is just a shifted image slice:
  ``X[r0 : r0+GU, c0 : c0+GV, ch] <= thr`` — no gathers, pure
  elementwise work.
* SPRT early rejection becomes *masked lockstep* evaluation: every window
  advances through every stage, an ``alive`` mask records rejection.  Because
  rejection is monotone, the surviving set and the survivors' accumulated
  scores are bit-identical to the reference's survivor-compaction loop.

Grid convention (reference parity): for a (C, U, V) channel tensor and an
(m, n) window, the window-origin grid is ``(max(U-m, 0), max(V-n, 0))`` —
the reference's ``np.indices((u-m, v-n))`` at
/root/reference/waldboost/model.py:243 never evaluates the final origin.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Cascade",
    "CascadeMeta",
    "cascade_from_stages",
    "stack_node_table",
    "tree_depth",
    "cascade_response_grid",
    "cascade_predict_samples",
    "NEG_INF",
]


class CascadeMeta(NamedTuple):
    """Static (hashable) evaluation metadata of a cascade."""

    depth: int       # max routing steps of any stage tree
    n_internal: int  # max count of internal (slicing) nodes per stage
    complete: bool = False  # node tables are canonical complete heap trees

NEG_INF = np.float32(-np.inf)


class Cascade(NamedTuple):
    """SoA cascade parameters.  All arrays have leading dim T (stages); node
    tables have second dim NN (max nodes per stage, padded with leaves)."""

    fr: jax.Array    # (T, NN) int32  feature row offset within window
    fc: jax.Array    # (T, NN) int32  feature col offset
    fch: jax.Array   # (T, NN) int32  feature channel
    thr: jax.Array   # (T, NN) float32 split threshold
    left: jax.Array  # (T, NN) int32  left child (-1 -> leaf)
    right: jax.Array # (T, NN) int32  right child
    pred: jax.Array  # (T, NN) float32 per-node log-odds prediction
    theta: jax.Array # (T,)   float32 SPRT rejection threshold (-inf = none)
    active: jax.Array  # (T,) bool — False for inert padding stages

    @property
    def n_stages(self) -> int:
        return self.fr.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.fr.shape[1]


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Longest root->leaf path (number of routing steps) of a flat-array tree."""
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    if left.size == 0:
        return 0

    def depth(n: int) -> int:
        if left[n] < 0:
            return 0
        return 1 + max(depth(int(left[n])), depth(int(right[n])))

    return depth(0)


def _tree_to_complete(feature, thr, left, right, pred, D):
    """Canonicalize an arbitrary flat tree of depth <= D into a complete
    heap-ordered depth-D tree with identical response semantics: shallow
    leaves become pass-through splits whose children replicate the leaf
    prediction.  Returns heap-layout arrays of size 2^(D+1)-1."""
    nn = 2 ** (D + 1) - 1
    cfeat = np.zeros((nn, 3), np.int32)
    cthr = np.zeros(nn, np.float32)
    cleft = np.full(nn, -1, np.int32)
    cright = np.full(nn, -1, np.int32)
    cpred = np.zeros(nn, np.float32)

    def rec(orig, heap, d):
        is_leaf = left[orig] < 0
        if d == D:
            cpred[heap] = pred[orig]
            return
        cleft[heap] = 2 * heap + 1
        cright[heap] = 2 * heap + 2
        cpred[heap] = pred[orig]
        if is_leaf:
            # pass-through: dummy compare, both children keep the prediction
            rec(orig, 2 * heap + 1, d + 1)
            rec(orig, 2 * heap + 2, d + 1)
        else:
            cfeat[heap] = feature[orig]
            cthr[heap] = thr[orig]
            rec(int(left[orig]), 2 * heap + 1, d + 1)
            rec(int(right[orig]), 2 * heap + 2, d + 1)

    rec(0, 0, 0)
    return cfeat, cthr, cleft, cright, cpred


#: canonicalize to complete heap trees when the cascade depth is at most this
#: (2^(D+1)-1 nodes; beyond it the general routing path is used)
MAX_COMPLETE_DEPTH = 4


def stack_node_table(stages: Sequence[dict], n_nodes: Optional[int] = None) -> Tuple[dict, "CascadeMeta"]:
    """Pad per-stage node dicts to a common node count and stack into (T, NN)
    numpy arrays.  Each stage dict has keys feature (K,3) int, threshold (K,),
    left (K,), right (K,), prediction (K,).  Padded nodes are inert leaves.

    When every stage tree has depth <= MAX_COMPLETE_DEPTH, all stages are
    canonicalized to complete heap-ordered trees of the cascade's max depth
    (identical responses; shallow leaves become pass-through splits), which
    enables the evaluators' fast select-tree routing (2^D - 1 selects instead
    of a general node-transition loop).

    Returns (arrays_dict, CascadeMeta).
    """
    T = len(stages)
    depths = [tree_depth(np.asarray(s["left"]), np.asarray(s["right"]))
              for s in stages]
    max_depth = max(depths, default=0)
    if T and 0 < max_depth <= MAX_COMPLETE_DEPTH and n_nodes is None:
        return _stack_complete(stages, max_depth)
    if n_nodes is None:
        n_nodes = max((len(s["threshold"]) for s in stages), default=1)
    n_nodes = max(int(n_nodes), 1)
    out = {
        "fr": np.zeros((T, n_nodes), np.int32),
        "fc": np.zeros((T, n_nodes), np.int32),
        "fch": np.zeros((T, n_nodes), np.int32),
        "thr": np.zeros((T, n_nodes), np.float32),
        "left": np.full((T, n_nodes), -1, np.int32),
        "right": np.full((T, n_nodes), -1, np.int32),
        "pred": np.zeros((T, n_nodes), np.float32),
    }
    max_depth = 0
    n_internal = 1
    for t, s in enumerate(stages):
        k = len(s["threshold"])
        ftr = np.asarray(s["feature"], np.int32).reshape(k, 3)
        # Reference encodes leaf features as (0,0,0) after the None->[0,0,0]
        # mapping at /root/reference/waldboost/training.py:25; the slice they
        # produce is never routed to, so any in-range value is fine.
        ftr = np.maximum(ftr, 0)
        left = np.asarray(s["left"], np.int32)
        right = np.asarray(s["right"], np.int32)
        thr = np.asarray(s["threshold"], np.float32)
        pred = np.asarray(s["prediction"], np.float32)
        # Reorder nodes internal-first (stable) so the grid evaluator only
        # computes image slices for the first ``n_internal`` nodes — leaves
        # need no comparison map (e.g. 3 slices instead of 7 for depth-2).
        is_leaf = left < 0
        perm = np.argsort(is_leaf, kind="stable")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(k)
        remap = lambda c: np.where(c >= 0, inv[np.maximum(c, 0)], -1)
        ftr, thr, pred = ftr[perm], thr[perm], pred[perm]
        left, right = remap(left[perm]), remap(right[perm])
        n_internal = max(n_internal, int((~is_leaf).sum()))
        out["fr"][t, :k] = ftr[:, 0]
        out["fc"][t, :k] = ftr[:, 1]
        out["fch"][t, :k] = ftr[:, 2]
        out["thr"][t, :k] = thr
        out["left"][t, :k] = left
        out["right"][t, :k] = right
        out["pred"][t, :k] = pred
        max_depth = max(max_depth, tree_depth(out["left"][t], out["right"][t]))
    return out, CascadeMeta(depth=max_depth, n_internal=n_internal,
                            complete=False)


def _stack_complete(stages: Sequence[dict], D: int) -> Tuple[dict, "CascadeMeta"]:
    T = len(stages)
    nn = 2 ** (D + 1) - 1
    out = {
        "fr": np.zeros((T, nn), np.int32),
        "fc": np.zeros((T, nn), np.int32),
        "fch": np.zeros((T, nn), np.int32),
        "thr": np.zeros((T, nn), np.float32),
        "left": np.full((T, nn), -1, np.int32),
        "right": np.full((T, nn), -1, np.int32),
        "pred": np.zeros((T, nn), np.float32),
    }
    for t, s in enumerate(stages):
        k = len(s["threshold"])
        ftr = np.maximum(np.asarray(s["feature"], np.int32).reshape(k, 3), 0)
        cfeat, cthr, cleft, cright, cpred = _tree_to_complete(
            ftr, np.asarray(s["threshold"], np.float32),
            np.asarray(s["left"], np.int32), np.asarray(s["right"], np.int32),
            np.asarray(s["prediction"], np.float32), D)
        out["fr"][t] = cfeat[:, 0]
        out["fc"][t] = cfeat[:, 1]
        out["fch"][t] = cfeat[:, 2]
        out["thr"][t] = cthr
        out["left"][t] = cleft
        out["right"][t] = cright
        out["pred"][t] = cpred
    return out, CascadeMeta(depth=D, n_internal=2 ** D - 1, complete=True)


def cascade_from_stages(stages: Sequence[dict], thetas: Sequence[float],
                        n_nodes: Optional[int] = None,
                        n_stages: Optional[int] = None) -> Tuple[Cascade, "CascadeMeta"]:
    """Build a device :class:`Cascade` from per-stage node dicts + thetas.

    ``n_stages``/``n_nodes`` allow padding to a larger static shape (padded
    stages predict 0 with theta=-inf, so results are unchanged) — used to
    stabilize jit cache keys while the model grows during training.
    Returns (cascade, CascadeMeta).
    """
    T = len(stages)
    pad_T = int(n_stages) if n_stages is not None else T
    arrays, meta = stack_node_table(list(stages), n_nodes=n_nodes)
    theta = np.full(pad_T, NEG_INF, np.float32)
    if T:
        theta[:T] = np.asarray(list(thetas), np.float32)
    active = np.zeros(pad_T, bool)
    active[:T] = True
    if pad_T > T:
        nn = arrays["fr"].shape[1]
        for key, fill in (("fr", 0), ("fc", 0), ("fch", 0), ("thr", 0.0),
                          ("left", -1), ("right", -1), ("pred", 0.0)):
            pad = np.full((pad_T - T, nn), fill, arrays[key].dtype)
            arrays[key] = np.concatenate([arrays[key], pad], axis=0)
    casc = Cascade(
        fr=jnp.asarray(arrays["fr"]), fc=jnp.asarray(arrays["fc"]),
        fch=jnp.asarray(arrays["fch"]), thr=jnp.asarray(arrays["thr"]),
        left=jnp.asarray(arrays["left"]), right=jnp.asarray(arrays["right"]),
        pred=jnp.asarray(arrays["pred"]), theta=jnp.asarray(theta),
        active=jnp.asarray(active),
    )
    return casc, meta


# ---------------------------------------------------------------------------
# Dense grid evaluation (detection path)
# ---------------------------------------------------------------------------

def _route_complete(bins, pred, depth):
    """Fast response for canonical complete heap trees: a balanced select
    tree (2^depth - 1 selects).  ``bins[h]`` is the comparison map of heap
    node h; leaf predictions live at pred[2^depth-1 + path]."""
    def rec(h, d):
        if d == depth:
            return pred[h]
        return jnp.where(bins[h], rec(2 * h + 1, d + 1), rec(2 * h + 2, d + 1))
    return rec(0, 0)


def _route_and_predict(bins, left, right, pred, node0, depth, nn):
    """Route windows through one tree given per-node comparison maps.

    ``bins``: list of NN bool arrays (window-shaped); ``left/right/pred``:
    traced (NN,) vectors; returns per-window response array."""
    node = node0
    for _ in range(depth):
        new_node = node
        for j in range(nn):
            tgt = jnp.where(bins[j], left[j], right[j])
            tgt = jnp.where(left[j] < 0, j, tgt)  # leaves stay put
            new_node = jnp.where(node == j, tgt, new_node)
        node = new_node
    resp = jnp.zeros(node.shape, jnp.float32)
    for j in range(nn):
        resp = jnp.where(node == j, pred[j], resp)
    return resp


def cascade_response_grid(chns: jax.Array, casc: Cascade, window: Tuple[int, int],
                          meta, init_alive: Optional[jax.Array] = None
                          ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Evaluate the full cascade on every window origin of a (C, U, V) channel
    tensor.

    Returns ``(hs, alive, n_weak)``: accumulated scores (GU, GV) float32,
    survivor mask (GU, GV) bool, and the scalar count of weak-classifier
    evaluations performed on live windows (the reference's ``n_weak`` counter,
    /root/reference/waldboost/model.py:248-252).

    ``init_alive`` optionally pre-kills windows (used by packed-pyramid
    evaluation to mask padding).  Pre-killed windows do not count toward
    ``n_weak`` but their grid positions DO count toward ``n_loc`` bookkeeping
    done by the caller.
    """
    if isinstance(meta, int):
        meta = CascadeMeta(depth=meta, n_internal=int(casc.n_nodes))
    depth = max(meta.depth, 1)
    n_slice = min(max(meta.n_internal, 1), casc.n_nodes)
    complete = getattr(meta, "complete", False)
    C, U, V = chns.shape
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    if gu == 0 or gv == 0:
        z = jnp.zeros((gu, gv), jnp.float32)
        return z, jnp.zeros((gu, gv), bool), jnp.zeros((), jnp.int32)

    T, NN = casc.n_stages, casc.n_nodes
    hs = jnp.zeros((gu, gv), jnp.float32)
    alive = jnp.ones((gu, gv), bool) if init_alive is None else init_alive
    node0 = jnp.zeros((gu, gv), jnp.int32)
    n_weak = jnp.zeros((), jnp.int32)

    def stage(carry, params):
        hs, alive, n_weak = carry
        fr, fc, fch, thr, left, right, pred, theta, active = params
        # comparison maps only for internal nodes (internal-first ordering);
        # leaves route to themselves so their bin map is never consulted
        bins = []
        for j in range(NN):
            if j < n_slice:
                patch = jax.lax.dynamic_slice(chns, (fch[j], fr[j], fc[j]),
                                              (1, gu, gv))[0]
                bins.append(patch.astype(jnp.float32) <= thr[j])
            else:
                bins.append(jnp.zeros((), bool))
        if complete:
            resp = _route_complete(bins, pred, depth)
        else:
            resp = _route_and_predict(bins, left, right, pred, node0, depth, NN)
        n_weak = n_weak + jnp.sum(alive, dtype=jnp.int32) * active.astype(jnp.int32)
        hs = hs + jnp.where(alive, resp, 0.0)
        alive = jnp.logical_and(alive, hs >= theta)
        return (hs, alive, n_weak), None

    # scan over stages: compiles one stage body instead of T unrolled copies
    (hs, alive, n_weak), _ = jax.lax.scan(
        stage, (hs, alive, n_weak),
        (casc.fr, casc.fc, casc.fch, casc.thr, casc.left, casc.right,
         casc.pred, casc.theta, casc.active))
    return hs, alive, n_weak


def cascade_survivor_counts(chns: jax.Array, casc: Cascade,
                            window: Tuple[int, int], meta,
                            init_alive: Optional[jax.Array] = None
                            ) -> Tuple[jax.Array, jax.Array]:
    """Per-stage survivor counts: the cascade-depth observability the
    reference left as a roadmap TODO ("Keep worst case eval. cost",
    /root/reference/NOTES.md:70).

    Returns ``(counts, n_weak)`` where ``counts[t]`` is the number of
    windows still ALIVE entering stage ``t`` (i.e. evaluated by stage
    ``t``'s weak classifier when that stage is active) and ``n_weak`` is
    the scalar total of weak evaluations (== ``(counts * active).sum()``).
    A diagnostic pass over the XLA cascade — the serving kernel stays
    untouched."""
    if isinstance(meta, int):
        meta = CascadeMeta(depth=meta, n_internal=int(casc.n_nodes))
    C, U, V = chns.shape
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    T = casc.n_stages
    if gu == 0 or gv == 0:
        return jnp.zeros((T,), jnp.int32), jnp.zeros((), jnp.int32)
    hs = jnp.zeros((gu, gv), jnp.float32)
    alive = jnp.ones((gu, gv), bool) if init_alive is None else init_alive
    n_weak = jnp.zeros((), jnp.int32)
    depth = max(meta.depth, 1)
    n_slice = min(max(meta.n_internal, 1), casc.n_nodes)
    complete = getattr(meta, "complete", False)
    NN = casc.n_nodes
    node0 = jnp.zeros((gu, gv), jnp.int32)

    def stage(carry, params):
        hs, alive, n_weak = carry
        fr, fc, fch, thr, left, right, pred, theta, active = params
        entering = jnp.sum(alive, dtype=jnp.int32)
        bins = []
        for j in range(NN):
            if j < n_slice:
                patch = jax.lax.dynamic_slice(chns, (fch[j], fr[j], fc[j]),
                                              (1, gu, gv))[0]
                bins.append(patch.astype(jnp.float32) <= thr[j])
            else:
                bins.append(jnp.zeros((), bool))
        if complete:
            resp = _route_complete(bins, pred, depth)
        else:
            resp = _route_and_predict(bins, left, right, pred, node0, depth,
                                      NN)
        n_weak = n_weak + entering * active.astype(jnp.int32)
        hs = hs + jnp.where(alive, resp, 0.0)
        alive = jnp.logical_and(alive, hs >= theta)
        return (hs, alive, n_weak), entering

    (hs, alive, n_weak), counts = jax.lax.scan(
        stage, (hs, alive, n_weak),
        (casc.fr, casc.fc, casc.fch, casc.thr, casc.left, casc.right,
         casc.pred, casc.theta, casc.active))
    return counts, n_weak


def cascade_stage_responses(chns: jax.Array, casc: Cascade,
                            window: Tuple[int, int], meta) -> jax.Array:
    """Per-stage weak responses of every window origin: (T, GU, GV) float32.

    Stage responses are independent of SPRT rejection (a window's stage-t
    response depends only on the channels), so this single pass supports
    offline threshold calibration: callers can replay any rejection schedule
    over the returned tensor (e.g. __graft_entry__._flagship_model's
    quantile-recursion thetas, mirroring what the reference's per-stage
    ``fit_rejection_threshold`` loop sees at
    /root/reference/waldboost/training.py:355-428).
    """
    if isinstance(meta, int):
        meta = CascadeMeta(depth=meta, n_internal=int(casc.n_nodes))
    depth = max(meta.depth, 1)
    n_slice = min(max(meta.n_internal, 1), casc.n_nodes)
    complete = getattr(meta, "complete", False)
    C, U, V = chns.shape
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    T, NN = casc.n_stages, casc.n_nodes
    node0 = jnp.zeros((gu, gv), jnp.int32)

    def stage(_, params):
        fr, fc, fch, thr, left, right, pred = params
        bins = []
        for j in range(NN):
            if j < n_slice:
                patch = jax.lax.dynamic_slice(chns, (fch[j], fr[j], fc[j]),
                                              (1, gu, gv))[0]
                bins.append(patch.astype(jnp.float32) <= thr[j])
            else:
                bins.append(jnp.zeros((), bool))
        if complete:
            resp = _route_complete(bins, pred, depth)
        else:
            resp = _route_and_predict(bins, left, right, pred, node0, depth,
                                      NN)
        return None, resp

    _, resp = jax.lax.scan(
        stage, None,
        (casc.fr, casc.fc, casc.fch, casc.thr, casc.left, casc.right,
         casc.pred))
    return resp


# ---------------------------------------------------------------------------
# Two-phase evaluation: lockstep prefix + compacted per-window suffix
# ---------------------------------------------------------------------------

def slice_cascade(casc: Cascade, start: int, stop: int) -> Cascade:
    """Static stage-range slice of a cascade (arrays share storage)."""
    return Cascade(*(a[start:stop] for a in casc))


def cascade_suffix_sparse(chns: jax.Array, casc: Cascade, window, meta,
                          idx: jax.Array, scores: jax.Array,
                          alive: jax.Array, start: int
                          ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Evaluate stages [start:T) on a compacted set of window origins.

    ``idx``: (S,) flattened window-origin indices into the (GU, GV) grid;
    ``scores``: their accumulated responses after stage ``start``;
    ``alive``: (S,) bool.  Per-stage node tests are 3 gathers of S elements —
    the static-shape revival of the reference's survivor compaction
    (/root/reference/waldboost/model.py:249-258).

    Returns (scores, alive, n_weak_suffix).
    """
    if isinstance(meta, int):
        meta = CascadeMeta(depth=meta, n_internal=int(casc.n_nodes))
    depth = max(meta.depth, 1)
    complete = getattr(meta, "complete", False)
    C, U, V = chns.shape
    m, n = window
    gv = max(V - n, 0)
    flat = chns.reshape(-1)
    r = idx // gv
    c = idx % gv
    NN = casc.n_nodes
    sub = slice_cascade(casc, start, casc.n_stages)

    def stage(carry, params):
        H, alive, n_weak = carry
        fr, fc, fch, thr, left, right, pred, theta, active = params
        bins = []
        for j in range(NN):
            if j < meta.n_internal or not complete:
                fi = fch[j] * (U * V) + (r + fr[j]) * V + (c + fc[j])
                bins.append(jnp.take(flat, fi) <= thr[j])
            else:
                bins.append(None)
        if complete:
            def rec(h, d):
                if d == depth:
                    return pred[h]
                return jnp.where(bins[h], rec(2 * h + 1, d + 1),
                                 rec(2 * h + 2, d + 1))
            resp = rec(0, 0)
        else:
            node = jnp.zeros(r.shape, jnp.int32)
            for _ in range(depth):
                new_node = node
                for j in range(NN):
                    tgt = jnp.where(bins[j], left[j], right[j])
                    tgt = jnp.where(left[j] < 0, j, tgt)
                    new_node = jnp.where(node == j, tgt, new_node)
                node = new_node
            resp = jnp.zeros(r.shape, jnp.float32)
            for j in range(NN):
                resp = jnp.where(node == j, pred[j], resp)
        n_weak = n_weak + jnp.sum(alive, dtype=jnp.int32) * active.astype(jnp.int32)
        H = H + jnp.where(alive, resp, 0.0)
        alive = jnp.logical_and(alive, H >= theta)
        return (H, alive, n_weak), None

    (H, alive, n_weak), _ = jax.lax.scan(
        stage, (scores, alive, jnp.zeros((), jnp.int32)),
        (sub.fr, sub.fc, sub.fch, sub.thr, sub.left, sub.right, sub.pred,
         sub.theta, sub.active))
    return H, alive, n_weak


# ---------------------------------------------------------------------------
# Batched sample evaluation (training path)
# ---------------------------------------------------------------------------

def cascade_predict_samples(x: jax.Array, casc: Cascade, meta,
                            valid: Optional[jax.Array] = None
                            ) -> Tuple[jax.Array, jax.Array]:
    """Evaluate the cascade on a batch of cropped windows.

    ``x``: (N, m, n, C) samples (HWC per sample — the training-side layout,
    matching the reference's ``Model.predict`` contract at
    /root/reference/waldboost/model.py:181-214).

    Returns ``(H, mask)``: scores with rejected samples set to -inf, and the
    survivor mask.
    """
    if isinstance(meta, int):
        meta = CascadeMeta(depth=meta, n_internal=int(casc.n_nodes))
    depth = max(meta.depth, 1)
    N = x.shape[0]
    m, n, C = x.shape[1], x.shape[2], x.shape[3]
    xf = x.reshape(N, m * n * C).astype(jnp.float32)
    T, NN = casc.n_stages, casc.n_nodes
    # flat feature index per node: (row * n + col) * C + ch
    fidx = (casc.fr * n + casc.fc) * C + casc.fch  # (T, NN) int32

    H = jnp.zeros(N, jnp.float32)
    mask = jnp.ones(N, bool) if valid is None else valid

    def stage(carry, params):
        H, mask = carry
        fidx_t, thr_t, left_t, right_t, pred_t, theta_t = params
        node = jnp.zeros(N, jnp.int32)
        for _ in range(depth):
            f = jnp.take(fidx_t, node)             # (N,)
            v = jnp.take_along_axis(xf, f[:, None], axis=1)[:, 0]
            b = v <= jnp.take(thr_t, node)
            lft = jnp.take(left_t, node)
            rgt = jnp.take(right_t, node)
            nxt = jnp.where(b, lft, rgt)
            node = jnp.where(lft < 0, node, nxt)
        resp = jnp.take(pred_t, node)
        H = H + jnp.where(mask, resp, 0.0)
        mask = jnp.logical_and(mask, H >= theta_t)
        return (H, mask), None

    (H, mask), _ = jax.lax.scan(
        stage, (H, mask),
        (fidx, casc.thr, casc.left, casc.right, casc.pred, casc.theta))
    H = jnp.where(mask, H, NEG_INF)
    return H, mask
