"""WaldBoost training: weak classifiers, boosting learner, SPRT thresholds.

Parity map to /root/reference/waldboost/training.py:

* :class:`DTree` — flat-array decision tree (same serialized form, same
  prediction semantics).  ``DTree.fit`` trains on device via the weighted-
  histogram splitter in :mod:`waldboost_tpu.ops.fit` (backend="hist",
  the default) or via sklearn CART with ``class_weight="balanced"``
  for exact reference-compatible training (backend="sklearn",
  /root/reference/waldboost/training.py:34-50).
* :class:`Learner` — one boosting stage per ``fit_stage`` call: exp-loss
  weights, weak fit, score update, SPRT threshold, p0/p1/loss tracking,
  pickle checkpointing (/root/reference/waldboost/training.py:105-188).
* :func:`fit_rejection_threshold` — Wald sequential-test threshold scan
  (/root/reference/waldboost/training.py:191-220), plus a jittable
  device version used by sharded training.
* :class:`BasicRejectionSchedule` (/root/reference/waldboost/training.py:223-253).
"""

from __future__ import annotations

import logging
import pickle
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .ops.fit import fit_tree_complete, prune_heap_tree

logger = logging.getLogger(__name__)

__all__ = [
    "weights",
    "as_features",
    "DTree",
    "Learner",
    "loss",
    "fit_rejection_threshold",
    "BasicRejectionSchedule",
]


def weights(H: np.ndarray) -> np.ndarray:
    """Exponential-loss sample weights (/root/reference/waldboost/training.py:14-15)."""
    H = np.asarray(H)
    return np.exp(H) / H.size / 2


def as_features(X: np.ndarray) -> np.ndarray:
    X = np.asarray(X)
    n = X.shape[0]
    # explicit feature count: reshape(n, -1) cannot infer -1 when n == 0
    f = int(np.prod(X.shape[1:])) if X.ndim > 1 else 0
    return X.reshape(n, f)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DTree:
    """Flat-array decision tree weak classifier.

    Node ``k`` tests ``X[r, c, ch] <= threshold[k]`` with feature triple
    ``feature[k]``; ``left/right`` are child indices (-1 = leaf); ``prediction``
    holds per-node log-odds.  Semantics identical to
    /root/reference/waldboost/training.py:23-96 (flat storage, ``(0,0,0)``
    placeholder features at leaves, proto round-trip).
    """

    def __init__(self, feature, threshold, left, right, prediction):
        self.feature = np.array(
            [f if f is not None else (0, 0, 0) for f in feature], np.int32
        ).reshape(-1, 3)
        self.threshold = np.asarray(threshold, np.float32).reshape(-1)
        self.left = np.asarray(left, np.int32).reshape(-1)
        self.right = np.asarray(right, np.int32).reshape(-1)
        self.prediction = np.asarray(prediction, np.float32).reshape(-1)
        self.node = self.left >= 0
        self.node_idx = np.flatnonzero(self.node)

    # -- training -----------------------------------------------------------
    @staticmethod
    def fit(X0, W0, X1, W1, max_depth: int = 2, min_samples_leaf: int = 1,
            allowed_features=None, backend: str = "hist", n_bins: int = 256,
            binning: str = "quantile",
            clip: Optional[float] = None, quantizer: Optional[int] = None,
            integer_thresholds: bool = False, **sklearn_args) -> "DTree":
        """Fit a weak tree on weighted negative (X0, W0) / positive (X1, W1)
        sample sets.

        backend="hist": on-device weighted-histogram splits (the default).
        backend="sklearn": exact reference semantics via sklearn CART.

        ``allowed_features``: optional per-depth list of flat feature index
        arrays (the FPGA bank restriction,
        /root/reference/waldboost/fpga/training.py:124-130).
        ``clip``/``quantizer``: optional leaf-response clipping and
        quantization (round(q*p)/q), matching
        /root/reference/waldboost/fpga/training.py:164-168.
        ``integer_thresholds``: floor thresholds to integers (exact for
        integer-valued channels; FPGA mode).
        """
        if backend == "sklearn":
            tree = DTree._fit_sklearn(X0, W0, X1, W1, max_depth=max_depth,
                                      min_samples_leaf=min_samples_leaf,
                                      **sklearn_args)
        else:
            tree = DTree._fit_hist(X0, W0, X1, W1, max_depth=max_depth,
                                   min_samples_leaf=min_samples_leaf,
                                   allowed_features=allowed_features,
                                   n_bins=n_bins, binning=binning)
        if integer_thresholds:
            # For integer-valued features, flooring a threshold in (k, k+1)
            # keeps the split identical while making it HW-evaluable with
            # integer compares (FPGA mode,
            # /root/reference/waldboost/fpga/training.py:20-35 trains on
            # integer bin edges directly).
            tree.threshold = np.floor(tree.threshold)
        if clip is not None:
            tree.prediction = np.clip(tree.prediction, -clip, clip)
        if quantizer is not None:
            tree.prediction = np.round(quantizer * tree.prediction) / quantizer
        return tree

    @staticmethod
    def _fit_hist(X0, W0, X1, W1, max_depth, min_samples_leaf,
                  allowed_features, n_bins, binning="quantile") -> "DTree":
        X0 = np.asarray(X0)
        X1 = np.asarray(X1)
        shape = X0.shape[1:]
        F = int(np.prod(shape))
        X = np.concatenate([as_features(X0), as_features(X1)]).astype(np.float32)
        Y = np.concatenate([np.zeros(len(X0), np.int32), np.ones(len(X1), np.int32)])
        W = np.concatenate([np.asarray(W0, np.float32), np.asarray(W1, np.float32)])
        # class-balanced split weights: each class sums to 0.5
        Wb = W.copy()
        s0 = Wb[Y == 0].sum()
        s1 = Wb[Y == 1].sum()
        if s0 > 0:
            Wb[Y == 0] /= s0 * 2
        if s1 > 0:
            Wb[Y == 1] /= s1 * 2
        N = X.shape[0]
        # power-of-2 size buckets (min 256): the pool's size drifts every
        # stage, and each new padded size is a fresh XLA compile.
        # O(log N) buckets amortize to a handful of compiles per run.
        Np = max(256, 1 << (max(N, 1) - 1).bit_length())
        pad = Np - N
        Xp = np.pad(X, ((0, pad), (0, 0)))
        Yp = np.pad(Y, (0, pad))
        Wbp = np.pad(Wb, (0, pad))
        Wp = np.pad(W, (0, pad))
        valid = np.zeros(Np, bool)
        valid[:N] = True

        fmask = None
        if allowed_features is not None:
            fmask = np.zeros((max_depth, F), bool)
            for d in range(max_depth):
                fmask[d, np.asarray(allowed_features[d], int)] = True
            fmask = jnp.asarray(fmask)

        from .ops.fit import hist_mode_from_env
        res = fit_tree_complete(
            jnp.asarray(Xp), jnp.asarray(Yp), jnp.asarray(Wbp), jnp.asarray(Wp),
            jnp.asarray(valid), max_depth=int(max_depth), n_bins=int(n_bins),
            min_samples_leaf=int(min_samples_leaf), feature_mask=fmask,
            binning=binning, hist_mode=hist_mode_from_env())
        feat, thr, left, right, pred = prune_heap_tree(
            np.asarray(res.feature), np.asarray(res.threshold),
            np.asarray(res.left), np.asarray(res.right), np.asarray(res.pred))
        feature = [np.unravel_index(f, shape) if f >= 0 else None for f in feat]
        return DTree(feature, thr, left, right, pred)

    @staticmethod
    def _fit_sklearn(X0, W0, X1, W1, max_depth=2, min_samples_leaf=1,
                     **kwargs) -> "DTree":
        from sklearn.tree import DecisionTreeClassifier
        X = np.concatenate([as_features(X0), as_features(X1)])
        Y = np.array([0] * len(X0) + [1] * len(X1))
        W = np.concatenate([np.asarray(W0), np.asarray(W1)])
        T = DecisionTreeClassifier(class_weight="balanced", max_depth=max_depth,
                                   min_samples_leaf=min_samples_leaf, **kwargs)
        T.fit(X, Y, sample_weight=W)
        shape = X0.shape[1:]
        tree = T.tree_
        feature = [np.unravel_index(f, shape) if f >= 0 else None
                   for f in tree.feature]
        leaf = T.apply(X)
        pred = np.empty(tree.node_count)
        for k in range(tree.node_count):
            mask = leaf == k
            w0 = (W * mask * (Y == 0)).sum() + 1e-3
            w1 = (W * mask * (Y == 1)).sum() + 1e-3
            pred[k] = np.log(w1 / w0) / 2
        return DTree(feature, tree.threshold, tree.children_left,
                     tree.children_right, pred)

    # -- inference (host; device paths live in ops.cascade) -----------------
    def apply(self, X) -> np.ndarray:
        X = np.asarray(X)
        node = np.zeros(X.shape[0], np.int64)
        for k in self.node_idx:
            r, c, ch = self.feature[k]
            idx = np.flatnonzero(node == k)
            if idx.size == 0:
                continue
            go_left = X[idx, r, c, ch] <= self.threshold[k]
            node[idx] = np.where(go_left, self.left[k], self.right[k])
        return node

    def predict(self, X) -> np.ndarray:
        return self.prediction[self.apply(X)]

    def predict_on_image(self, X, rs, cs) -> np.ndarray:
        X = np.asarray(X)
        node = np.zeros(rs.size, np.int64)
        for k in self.node_idx:
            r, c, ch = self.feature[k]
            idx = np.flatnonzero(node == k)
            if idx.size == 0:
                continue
            go_left = X[rs[idx] + r, cs[idx] + c, ch] <= self.threshold[k]
            node[idx] = np.where(go_left, self.left[k], self.right[k])
        return self.prediction[node]

    # -- conversion ----------------------------------------------------------
    def to_stage_dict(self) -> dict:
        """Node-table dict consumed by ops.cascade.cascade_from_stages."""
        feature = self.feature.copy()
        feature[self.left < 0] = 0
        return dict(feature=feature, threshold=self.threshold,
                    left=self.left, right=self.right, prediction=self.prediction)

    @staticmethod
    def from_proto(proto) -> "DTree":
        ftr = np.array(proto.feature).reshape(-1, 3)
        feature = [tuple(x) if x[0] >= 0 else None for x in ftr]
        return DTree(feature, np.array(proto.threshold), np.array(proto.left),
                     np.array(proto.right), np.array(proto.prediction))

    def as_proto(self, proto) -> None:
        proto.Clear()
        flat = []
        for k in range(len(self.threshold)):
            if self.left[k] >= 0:
                flat.extend(int(v) for v in self.feature[k])
            else:
                flat.extend((-1, -1, -1))
        proto.feature.extend(flat)
        proto.threshold.extend(float(t) for t in self.threshold)
        proto.left.extend(int(v) for v in self.left)
        proto.right.extend(int(v) for v in self.right)
        proto.prediction.extend(float(p) for p in self.prediction)


def loss(H0, H1) -> float:
    """Exp-loss of current scores (/root/reference/waldboost/training.py:99-102).
    An empty class contributes 0 (degenerate pools are legal here)."""
    W0 = weights(H0)
    W1 = weights(-np.asarray(H1))
    m0 = float(W0.mean()) if W0.size else 0.0
    m1 = float(W1.mean()) if W1.size else 0.0
    return m0 + m1


class _InteropUnpickler(pickle.Unpickler):
    """Unpickler that resolves reference-package globals here.

    Reference learner checkpoints reference classes by module path
    (``waldboost.training.DTree`` et al.); this package is the drop-in
    replacement, so ``waldboost[.sub]`` remaps to ``waldboost_tpu[.sub]``
    when the target exists there.  Anything else resolves normally."""

    def find_class(self, module, name):
        if module == "waldboost" or module.startswith("waldboost."):
            remapped = "waldboost_tpu" + module[len("waldboost"):]
            try:
                return super().find_class(remapped, name)
            except (AttributeError, ModuleNotFoundError, ImportError):
                pass
        return super().find_class(module, name)


class StageRecord(NamedTuple):
    """Per-stage training statistics: survivor rates under the new theta
    (p0 negatives / p1 positives) and the post-stage exp-loss."""

    p0: float
    p1: float
    loss: float


class Learner:
    """Boosting learner: appends one stage per ``fit_stage`` call.

    Stage statistics live in one ``history`` list of :class:`StageRecord`;
    the ``p0``/``p1``/``losses`` views and the pickle checkpoint keep the
    reference's three-parallel-list surface
    (/root/reference/waldboost/training.py:105-157) so old checkpoints load
    and external code reads the same names.
    """

    _CHECKPOINT_FIELDS = ("alpha", "wh", "wh_args")

    def __init__(self, alpha: float = 0.1, wh=DTree, **wh_args):
        self.alpha = alpha
        self.wh = wh
        self.wh_args = wh_args
        self.history: list[StageRecord] = []

    # -- stage history ----------------------------------------------------
    def record_stage(self, p0: float, p1: float, loss_: float) -> None:
        """Append one stage's statistics (used by both the host
        ``fit_stage`` and the sharded trainer's device stage)."""
        self.history.append(StageRecord(float(p0), float(p1), float(loss_)))

    @property
    def p0(self) -> list:
        return [s.p0 for s in self.history]

    @property
    def p1(self) -> list:
        return [s.p1 for s in self.history]

    @property
    def losses(self) -> list:
        return [s.loss for s in self.history]

    @property
    def false_positive_rate(self) -> float:
        out = 1.0
        for s in self.history:
            out *= s.p0
        return out

    @property
    def true_positive_rate(self) -> float:
        out = 1.0
        for s in self.history:
            out *= s.p1
        return out

    @property
    def loss(self):
        return self.history[-1].loss if self.history else None

    def __len__(self) -> int:
        return len(self.history)

    def __bool__(self) -> bool:
        return True

    def get_stats(self) -> dict:
        """Cumulative rate curves + loss trajectory, one entry per stage."""
        rec = np.array(self.history, "f8").reshape(len(self.history), 3)
        return {
            "false_positive_rate": np.cumprod(rec[:, 0]),
            "true_positive_rate": np.cumprod(rec[:, 1]),
            "loss": rec[:, 2].copy(),
        }

    # -- checkpointing ----------------------------------------------------
    def to_dict(self) -> dict:
        """Checkpoint payload; the stage history is flattened to the
        reference's three-list layout for cross-compatibility."""
        d = {k: getattr(self, k) for k in self._CHECKPOINT_FIELDS}
        d.update(p0=self.p0, p1=self.p1, losses=self.losses)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Learner":
        L = Learner(alpha=d["alpha"], wh=d["wh"], **d["wh_args"])
        stats = [d[k] for k in ("p0", "p1", "losses")]
        if len({len(s) for s in stats}) != 1:
            raise ValueError("Wrong values for p0, p1 or loss")
        L.history = [StageRecord(*t) for t in zip(*stats)]
        return L

    def save(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self.to_dict(), f)

    @staticmethod
    def load(filename: str) -> "Learner":
        """Load a learner checkpoint — ours, or one written by the reference
        package.

        The reference pickles ``Learner.__dict__`` INCLUDING the ``wh`` class
        object itself (/root/reference/waldboost/training.py:125-132), so a
        reference-written file carries a global reference to
        ``waldboost.training.DTree``.  :class:`_InteropUnpickler` remaps any
        ``waldboost.*`` global to this package's equivalent, making both
        checkpoint dialects load through the same path."""
        with open(filename, "rb") as f:
            return Learner.from_dict(_InteropUnpickler(f).load())

    def fit_stage(self, model, X0, H0, X1, H1, theta: Optional[float] = None,
                  **wh_args) -> Tuple[float, float, float]:
        """Fit one boosting stage and append it to ``model``.

        ``theta=None`` -> estimate via SPRT; an explicit float (including
        -inf) is used as-is.  NOTE: unlike the reference's falsy check
        (/root/reference/waldboost/training.py:176, where theta=0.0 would be
        silently re-fit), only ``None`` triggers estimation.
        """
        W0 = weights(H0)
        W1 = weights(-np.asarray(H1))

        weak = self.wh.fit(X0, W0, X1, W1, **{**self.wh_args, **wh_args})

        H0 = np.asarray(H0) + weak.predict(X0)
        H1 = np.asarray(H1) + weak.predict(X1)

        if theta is None:
            theta = fit_rejection_threshold(
                H0, self.false_positive_rate, H1, self.true_positive_rate,
                self.alpha)

        self.record_stage((H0 >= theta).sum() / max(H0.size, 1),
                          (H1 >= theta).sum() / max(H1.size, 1),
                          loss(H0, H1))

        model.append(weak, theta)
        return self.loss, self.false_positive_rate, self.true_positive_rate


def fit_rejection_threshold(H0, P0, H1, P1, alpha) -> float:
    """Wald SPRT rejection threshold
    (/root/reference/waldboost/training.py:191-220): scan unique response
    values, compute the likelihood ratio
    ``R = (P0*p0 + (1-P0) + 1e-6) / (P1*p1 + (1-P1) + 1e-6)`` with
    ``p = P(H < t)``, and return the largest t with ``R > 1/alpha``."""
    H0 = np.asarray(H0, np.float64)
    H1 = np.asarray(H1, np.float64)
    if H0.size == 0 or H1.size == 0:
        # degenerate pool (a class is empty): no basis for a threshold
        logger.log(15, "Empty sample class, theta forced to -inf")
        return float(-np.inf)
    max0 = np.max(H0)
    min1 = np.min(H1)
    if max0 < min1:
        logger.log(15, f"H0 and H1 are non-overlapping H0 < {max0}, H1 > {min1}")
        return float(min1)
    ts = np.sort(np.unique(np.concatenate([H0.ravel(), H1.ravel()])))
    if ts.size < 3:
        logger.log(15, "Not enough unique responses to estimate theta")
        return float(-np.inf)
    ts = ts[1:]
    p0 = np.searchsorted(np.sort(H0.ravel()), ts, side="left") / H0.size
    p1 = np.searchsorted(np.sort(H1.ravel()), ts, side="left") / H1.size
    R = (P0 * p0 + (1 - P0) + 1e-6) / (P1 * p1 + (1 - P1) + 1e-6)
    A = 1 / alpha
    idx = np.nonzero(R > A)[0]
    if idx.size == 0:
        theta = -np.inf
    else:
        theta = ts[np.max(idx)]
    logger.log(15, f"theta = {theta:.4f}")
    return float(theta)


def fit_rejection_threshold_device(H0, H1, P0, P1, alpha, v0=None, v1=None):
    """Jittable (and shardable) SPRT threshold fit with the exact semantics of
    :func:`fit_rejection_threshold`.

    Works on fixed-shape score vectors, optionally with validity masks
    ``v0``/``v1`` for padded pools (padded entries are pushed to +inf where
    they can never count as "< t" and are excluded as candidates).
    Duplicates are harmless because equal thresholds produce equal likelihood
    ratios, and "drop the smallest unique value" becomes "exclude every
    candidate equal to the global min".  Special cases (non-overlapping
    classes -> min(H1); fewer than 3 unique responses -> -inf) are arithmetic
    selects, so no data-dependent control flow reaches XLA.
    """
    H0 = jnp.asarray(H0, jnp.float32).ravel()
    H1 = jnp.asarray(H1, jnp.float32).ravel()
    if v0 is None:
        v0 = jnp.ones(H0.shape, bool)
    if v1 is None:
        v1 = jnp.ones(H1.shape, bool)
    v0 = v0.ravel()
    v1 = v1.ravel()
    n0 = jnp.maximum(jnp.sum(v0), 1)
    n1 = jnp.maximum(jnp.sum(v1), 1)
    h0 = jnp.where(v0, H0, jnp.inf)
    h1 = jnp.where(v1, H1, jnp.inf)
    ts = jnp.sort(jnp.concatenate([h0, h1]))  # padding sorts to the end
    finite = jnp.isfinite(ts)
    n_unique = 1 + jnp.sum(jnp.logical_and(jnp.diff(ts) > 0, finite[1:]))
    p0 = jnp.searchsorted(jnp.sort(h0), ts, side="left") / n0
    p1 = jnp.searchsorted(jnp.sort(h1), ts, side="left") / n1
    R = (P0 * p0 + (1 - P0) + 1e-6) / (P1 * p1 + (1 - P1) + 1e-6)
    A = 1.0 / alpha
    cand = jnp.logical_and(jnp.logical_and(R > A, ts != ts[0]), finite)
    theta_sprt = jnp.max(jnp.where(cand, ts, -jnp.inf))
    max0 = jnp.max(jnp.where(v0, H0, -jnp.inf))
    min1 = jnp.min(jnp.where(v1, H1, jnp.inf))
    theta = jnp.where(max0 < min1, min1,
                      jnp.where(n_unique < 3, -jnp.inf, theta_sprt))
    # empty class: no basis for a threshold (host scan returns -inf)
    empty = jnp.logical_or(jnp.sum(v0) == 0, jnp.sum(v1) == 0)
    return jnp.where(empty, -jnp.inf, theta)


class BasicRejectionSchedule:
    """Force theta=-inf outside a stage interval or once cumulative p0 drops
    below target (/root/reference/waldboost/training.py:223-253).  Returns
    ``None`` when theta should be estimated from data."""

    def __init__(self, rejection_interval=(0, None), target_p0: float = 1e-5):
        if rejection_interval is None:
            rejection_interval = (None, None)
        self.s0 = rejection_interval[0] or 0
        self.s1 = rejection_interval[1] if rejection_interval[1] is not None else np.inf
        self.target_p0 = target_p0

    def __call__(self, stage: int, p0: float):
        if stage < self.s0 or stage > self.s1 or p0 < self.target_p0:
            return float(-np.inf)
        return None
