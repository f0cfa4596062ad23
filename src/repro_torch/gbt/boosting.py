"""Gradient boosting over :class:`repro_torch.gbt.tree.RegressionTree`.

Squared-loss boosting with shrinkage and optional row subsampling — the role
XGBoost plays in the paper's cost model (predicting eta_comp / eta_comm).
Bin edges are computed once on the full training set and shared across trees
(same trick as XGBoost ``hist``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.gbt.tree import RegressionTree, quantile_bin_edges, validate_node_table

#: samples per traversal chunk — keeps the (chunk, n_trees) lane matrices
#: L2-resident (512 x 300 trees of int32/float64 is a few hundred KB, the
#: sweet spot measured for gather traversal); chunking never changes results
#: (each sample's accumulation order is per-tree regardless of boundaries)
_PREDICT_CHUNK = 512

#: trees deeper than this fall back to the explicit child-pointer traversal:
#: the perfect layout pads every tree to a complete binary tree, so its
#: tables grow as 2^depth per tree
_MAX_PERFECT_DEPTH = 12


def _tree_depths(trees: "list[RegressionTree]") -> list[int]:
    # child ids strictly exceed their parent's (builder invariant, enforced
    # on deserialization), so one forward pass assigns every node's depth
    out = []
    for t in trees:
        nodes = t._nodes
        depth = [0] * len(nodes)
        for i, nd in enumerate(nodes):
            if nd.feature >= 0:
                depth[nd.left] = depth[i] + 1
                depth[nd.right] = depth[i] + 1
        out.append(max(depth) if depth else 0)
    return out


class _FlatForest:
    """All trees padded to one complete binary tree per tree, stored as
    per-level SoA tables, so traversal needs no child pointers at all.

    Level ``l`` holds ``(n_trees, 2**l)`` feature/threshold tables (flattened
    tree-major); a sample at level-local position ``pos`` moves to
    ``2*pos + (x[feat] <= thr ? 0 : 1)`` — pure integer arithmetic, no gather
    for the child id. Subtrees below a real leaf are padded with
    ``threshold=+inf`` and every descendant leaf slot filled with the leaf's
    value, so any comparison outcome (including NaN features, which the
    reference sends right) lands on the same value and the traversal is
    bit-exact vs the pointer-chasing reference.
    """

    __slots__ = ("n_trees", "depth", "level_feature", "level_threshold",
                 "leaf_value", "tree_shift")

    def __init__(self, trees: "list[RegressionTree]"):
        self.n_trees = len(trees)
        depth = max(_tree_depths(trees), default=0)
        self.depth = depth
        T = self.n_trees
        feat = [np.zeros((T, 1 << l), np.int32) for l in range(depth)]
        thr = [np.full((T, 1 << l), np.inf) for l in range(depth)]
        val = np.zeros((T, 1 << depth))
        for ti, t in enumerate(trees):
            nodes = t._nodes
            stack = [(0, 0, 0)]  # node id, level, level-local position
            while stack:
                nid, lvl, pos = stack.pop()
                nd = nodes[nid]
                if nd.feature < 0:
                    span = 1 << (depth - lvl)
                    val[ti, pos * span:(pos + 1) * span] = nd.value
                else:
                    feat[lvl][ti, pos] = nd.feature
                    thr[lvl][ti, pos] = nd.threshold
                    stack.append((nd.left, lvl + 1, 2 * pos))
                    stack.append((nd.right, lvl + 1, 2 * pos + 1))
        # int64 index columns throughout: ndarray.take's fast inner loop
        # only engages for intp indices (int32 lanes measured ~7x slower)
        self.level_feature = [a.ravel().astype(np.int64) for a in feat]
        self.level_threshold = [a.ravel() for a in thr]
        self.leaf_value = val.ravel()
        # tree_shift[l][0, ti] == ti << l: tree ti's offset into level l's
        # flattened table (and into the leaf table at l == depth)
        self.tree_shift = [
            (np.arange(T, dtype=np.int64) << l)[None, :] for l in range(depth + 1)
        ]

    def leaf_values(self, X: np.ndarray) -> np.ndarray:
        """``(n_trees, n_samples)`` leaf values: every sample descends every
        tree in lock-step levels over the per-level tables."""
        X = np.ascontiguousarray(X)
        m, n_feat = X.shape
        T = self.n_trees
        xflat = X.ravel()
        rows = (np.arange(m, dtype=np.int64) * n_feat)[:, None]
        pos = np.zeros((m, T), np.int64)
        for l in range(self.depth):
            idx = pos + self.tree_shift[l]
            gi = self.level_feature[l].take(idx)
            gi += rows
            b = xflat.take(gi) <= self.level_threshold[l].take(idx)
            np.logical_not(b, out=b)  # b == 1 -> right, NaN -> right (as ref)
            pos += pos
            np.add(pos, b, out=pos, casting="unsafe")
        idx = pos + self.tree_shift[self.depth]
        return np.ascontiguousarray(self.leaf_value.take(idx).T)


class _GatherForest:
    """Child-pointer traversal fallback for forests too deep to pad (the
    perfect layout's tables grow as 2^depth per tree). Same contract and
    bit-exactness as :class:`_FlatForest`, one gather per child step."""

    __slots__ = ("feature", "threshold", "left", "right", "value", "roots",
                 "max_nodes")

    def __init__(self, trees: "list[RegressionTree]"):
        feats, thrs, lefts, rights, vals, roots = [], [], [], [], [], []
        offset = 0
        self.max_nodes = 1
        for t in trees:
            f, th, l, r, v = t.flat_arrays()
            feats.append(f)
            thrs.append(th)
            lefts.append(np.where(l >= 0, l + offset, np.int64(-1)))
            rights.append(np.where(r >= 0, r + offset, np.int64(-1)))
            vals.append(v)
            roots.append(offset)
            offset += f.size
            self.max_nodes = max(self.max_nodes, f.size)
        self.feature = np.concatenate(feats) if feats else np.zeros(0, np.int64)
        self.threshold = np.concatenate(thrs) if thrs else np.zeros(0)
        self.left = np.concatenate(lefts) if lefts else np.zeros(0, np.int64)
        self.right = np.concatenate(rights) if rights else np.zeros(0, np.int64)
        self.value = np.concatenate(vals) if vals else np.zeros(0)
        self.roots = np.asarray(roots, dtype=np.int64)

    def leaf_values(self, X: np.ndarray) -> np.ndarray:
        m = X.shape[0]
        rows = np.arange(m)
        node = np.repeat(self.roots[:, None], m, axis=1)
        feat = self.feature[node]
        internal = feat >= 0
        # global child ids strictly advance within each tree (validated on
        # load), so max_nodes passes always terminate
        for _ in range(self.max_nodes):
            if not internal.any():
                break
            go_left = X[rows[None, :], np.maximum(feat, 0)] <= self.threshold[node]
            node = np.where(
                internal,
                np.where(go_left, self.left[node], self.right[node]),
                node,
            )
            feat = self.feature[node]
            internal = feat >= 0
        return self.value[node]


class GradientBoostedTrees:
    def __init__(
        self,
        n_estimators: int = 200,
        learning_rate: float = 0.1,
        max_depth: int = 6,
        min_samples_leaf: int = 8,
        reg_lambda: float = 1.0,
        subsample: float = 1.0,
        max_bins: int = 64,
        seed: int = 0,
    ):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.reg_lambda = reg_lambda
        self.subsample = subsample
        self.max_bins = max_bins
        self.seed = seed
        self.base_: float = 0.0
        self.trees_: list[RegressionTree] = []

    def fit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        *,
        eval_set: Optional[tuple[np.ndarray, np.ndarray]] = None,
        early_stopping_rounds: Optional[int] = None,
        init_model: Optional["GradientBoostedTrees"] = None,
    ) -> "GradientBoostedTrees":
        """Fit ``n_estimators`` additional trees on the squared-loss residual.

        ``init_model`` warm-starts boosting: its trees are copied in and the
        new trees correct *its* predictions on (X, y) — the online-refit
        path of the calibration loop, where a drifted cluster supplies new
        measured samples and the existing model is the starting margin.
        The shrinkage applied at predict time is uniform, so the init
        model's learning rate must match this one's.
        """
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        if init_model is not None:
            if init_model.learning_rate != self.learning_rate:
                raise ValueError(
                    "warm start requires matching learning rates "
                    f"({init_model.learning_rate} != {self.learning_rate})"
                )
            self.base_ = init_model.base_
            self.trees_ = list(init_model.trees_)
            pred = init_model.predict(X)
        else:
            self.base_ = float(y.mean())
            self.trees_ = []
            pred = np.full(y.shape, self.base_)
        n_warm = len(self.trees_)
        bin_edges = [quantile_bin_edges(X[:, j], self.max_bins) for j in range(X.shape[1])]

        best_eval = np.inf
        rounds_since_best = 0
        eval_pred = None
        if eval_set is not None:
            eval_pred = (
                init_model.predict(np.asarray(eval_set[0], dtype=np.float64))
                if init_model is not None
                else np.full(eval_set[1].shape, self.base_)
            )

        for _ in range(self.n_estimators):
            grad = pred - y  # d/dpred 0.5*(pred-y)^2
            if self.subsample < 1.0:
                m = rng.random(y.size) < self.subsample
                Xs, gs = X[m], grad[m]
            else:
                Xs, gs = X, grad
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                reg_lambda=self.reg_lambda,
                max_bins=self.max_bins,
            )
            tree.fit(Xs, gs, bin_edges=bin_edges)
            self.trees_.append(tree)
            pred += self.learning_rate * tree.predict(X)

            if eval_set is not None and early_stopping_rounds is not None:
                eval_pred += self.learning_rate * tree.predict(eval_set[0])
                rmse = float(np.sqrt(np.mean((eval_pred - eval_set[1]) ** 2)))
                if rmse < best_eval - 1e-9:
                    best_eval, rounds_since_best = rmse, 0
                else:
                    rounds_since_best += 1
                    if rounds_since_best >= early_stopping_rounds:
                        break
        return self

    def forest(self):
        """The flat-forest view of the fitted trees, built once and cached
        (trees never mutate after ``fit``; a refit appends, which changes
        the cache key and rebuilds). Perfect-level layout for typical
        depths, child-pointer gather for pathologically deep trees."""
        key = (len(self.trees_), sum(t.n_nodes for t in self.trees_))
        cached = getattr(self, "_forest", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        if max(_tree_depths(self.trees_), default=0) <= _MAX_PERFECT_DEPTH:
            forest = _FlatForest(self.trees_)
        else:
            forest = _GatherForest(self.trees_)
        self._forest = (key, forest)
        return forest

    def predict(self, X: np.ndarray) -> np.ndarray:
        """One flat-forest traversal for all trees, then per-tree shrinkage
        accumulation in tree order — the exact IEEE operation sequence of
        :meth:`predict_reference`, so the two agree bit-for-bit."""
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        out = np.full(n, self.base_)
        if not self.trees_ or n == 0:
            return out
        forest = self.forest()
        lr = self.learning_rate
        for lo in range(0, n, _PREDICT_CHUNK):
            chunk = slice(lo, min(lo + _PREDICT_CHUNK, n))
            leaves = forest.leaf_values(X[chunk])  # C-contiguous (T, m)
            # add.reduce over the leading axis of a C-contiguous array is a
            # strictly sequential row accumulation (pairwise summation only
            # applies along the contiguous inner axis), so this reproduces
            # base + sum_i lr*leaf_i in tree order bit-for-bit
            out[chunk] = np.add.reduce(lr * leaves, axis=0, initial=self.base_)
        return out

    def predict_reference(self, X: np.ndarray) -> np.ndarray:
        """Reference oracle: per-tree recursive-table prediction (the
        pre-flattening implementation); :meth:`predict` must match it
        bit-for-bit."""
        X = np.asarray(X, dtype=np.float64)
        out = np.full(X.shape[0], self.base_)
        for tree in self.trees_:
            out += self.learning_rate * tree.predict_reference(X)
        return out

    # -- tiny serialization (checkpointable alongside model ckpts) -------
    def to_dict(self) -> dict:
        return {
            "base": self.base_,
            "learning_rate": self.learning_rate,
            "trees": [
                {
                    "feature": [n.feature for n in t._nodes],
                    "threshold": [n.threshold for n in t._nodes],
                    "left": [n.left for n in t._nodes],
                    "right": [n.right for n in t._nodes],
                    "value": [n.value for n in t._nodes],
                }
                for t in self.trees_
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GradientBoostedTrees":
        from repro_torch.gbt.tree import _Node

        model = cls(learning_rate=d["learning_rate"])
        model.base_ = d["base"]
        model.trees_ = []
        for ti, td in enumerate(d["trees"]):
            t = RegressionTree()
            t._nodes = [
                _Node(feature=f, threshold=th, left=l, right=r, value=v)
                for f, th, l, r, v in zip(
                    td["feature"], td["threshold"], td["left"], td["right"], td["value"]
                )
            ]
            try:
                validate_node_table(t._nodes)
            except ValueError as e:
                raise ValueError(f"tree {ti}: {e}") from None
            model.trees_.append(t)
        return model
