"""A single histogram-split regression tree.

Implements the XGBoost split objective for squared loss with L2 leaf
regularization: for a node with gradient sum G and hessian sum H (hessian is
the sample count for squared loss), the split gain of (G_L, H_L | G_R, H_R) is

    gain = 1/2 * [ G_L^2/(H_L+lam) + G_R^2/(H_R+lam) - G^2/(H+lam) ] - gamma

and the leaf weight is -G/(H+lam). Features are pre-binned into at most
``max_bins`` quantile bins so split search is O(bins) per feature per node.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1  # -1 => leaf
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


def validate_node_table(nodes: "list[_Node]") -> None:
    """Structural integrity of a node table (used on deserialization).

    The builder's invariant — every child id strictly exceeds its parent's —
    is what guarantees traversal terminates (ids only move forward), so a
    table violating it (a corrupt registry row, a truncated file) must be
    rejected *here* rather than spin ``predict`` forever. Raises
    ``ValueError`` on: empty table, child index out of range, non-increasing
    child id (a cycle), or a leaf carrying children.
    """
    n = len(nodes)
    if n == 0:
        raise ValueError("GBT node table is empty")
    for i, node in enumerate(nodes):
        if node.feature < 0:
            if node.left != -1 or node.right != -1:
                raise ValueError(f"GBT leaf node {i} has children")
            continue
        for child in (node.left, node.right):
            if not (0 <= child < n):
                raise ValueError(
                    f"GBT node {i} child {child} outside table [0, {n})"
                )
            if child <= i:
                raise ValueError(
                    f"GBT node {i} child {child} does not advance (cycle)"
                )


def quantile_bin_edges(x: np.ndarray, max_bins: int) -> np.ndarray:
    """Candidate thresholds for one feature column (unique quantiles)."""
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    edges = np.unique(np.quantile(x, qs))
    return edges


class RegressionTree:
    def __init__(
        self,
        max_depth: int = 6,
        min_samples_leaf: int = 8,
        reg_lambda: float = 1.0,
        min_gain: float = 0.0,
        max_bins: int = 64,
    ):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.reg_lambda = reg_lambda
        self.min_gain = min_gain
        self.max_bins = max_bins
        self._nodes: list[_Node] = []

    # -- fitting --------------------------------------------------------
    def fit(
        self,
        X: np.ndarray,
        grad: np.ndarray,
        hess: Optional[np.ndarray] = None,
        bin_edges: Optional[list[np.ndarray]] = None,
    ) -> "RegressionTree":
        """Fit to (negative) gradients; for squared loss pass grad = y_pred - y."""
        X = np.asarray(X, dtype=np.float64)
        grad = np.asarray(grad, dtype=np.float64)
        if hess is None:
            hess = np.ones_like(grad)
        if bin_edges is None:
            bin_edges = [quantile_bin_edges(X[:, j], self.max_bins) for j in range(X.shape[1])]
        self._nodes = []
        self._build(X, grad, hess, np.arange(X.shape[0]), depth=0, bin_edges=bin_edges)
        return self

    def _leaf_value(self, g: float, h: float) -> float:
        return -g / (h + self.reg_lambda)

    def _build(self, X, grad, hess, idx, depth, bin_edges) -> int:
        node_id = len(self._nodes)
        self._nodes.append(_Node())
        g_tot = float(grad[idx].sum())
        h_tot = float(hess[idx].sum())
        node = self._nodes[node_id]
        node.value = self._leaf_value(g_tot, h_tot)
        if depth >= self.max_depth or idx.size < 2 * self.min_samples_leaf:
            return node_id

        best = self._best_split(X, grad, hess, idx, g_tot, h_tot, bin_edges)
        if best is None:
            return node_id
        feature, threshold = best
        mask = X[idx, feature] <= threshold
        li, ri = idx[mask], idx[~mask]
        node.feature = feature
        node.threshold = threshold
        node.left = self._build(X, grad, hess, li, depth + 1, bin_edges)
        node.right = self._build(X, grad, hess, ri, depth + 1, bin_edges)
        return node_id

    def _best_split(self, X, grad, hess, idx, g_tot, h_tot, bin_edges):
        lam = self.reg_lambda
        parent_score = g_tot * g_tot / (h_tot + lam)
        best_gain, best = self.min_gain, None
        for j, edges in enumerate(bin_edges):
            if edges.size == 0:
                continue
            col = X[idx, j]
            # histogram of (count, grad, hess) per bin
            bins = np.searchsorted(edges, col, side="left")
            nb = edges.size + 1
            cnt = np.bincount(bins, minlength=nb).astype(np.float64)
            gs = np.bincount(bins, weights=grad[idx], minlength=nb)
            hs = np.bincount(bins, weights=hess[idx], minlength=nb)
            c_cnt = np.cumsum(cnt)[:-1]
            c_g = np.cumsum(gs)[:-1]
            c_h = np.cumsum(hs)[:-1]
            valid = (c_cnt >= self.min_samples_leaf) & (
                (idx.size - c_cnt) >= self.min_samples_leaf
            )
            if not valid.any():
                continue
            gl, hl = c_g, c_h
            gr, hr = g_tot - c_g, h_tot - c_h
            gains = 0.5 * (
                gl * gl / (hl + lam) + gr * gr / (hr + lam) - parent_score
            )
            gains = np.where(valid, gains, -np.inf)
            k = int(np.argmax(gains))
            if gains[k] > best_gain:
                best_gain = float(gains[k])
                best = (j, float(edges[k]))
        return best

    # -- prediction -----------------------------------------------------
    def flat_arrays(self) -> tuple[np.ndarray, ...]:
        """The node table as contiguous SoA arrays
        ``(feature, threshold, left, right, value)``. Built once per fitted
        table and cached (nodes never mutate after ``fit``/``from_dict``)."""
        cached = getattr(self, "_flat", None)
        if cached is not None and cached[0] == len(self._nodes):
            return cached[1]
        n = len(self._nodes)
        arrays = (
            np.fromiter((x.feature for x in self._nodes), np.int64, n),
            np.fromiter((x.threshold for x in self._nodes), np.float64, n),
            np.fromiter((x.left for x in self._nodes), np.int64, n),
            np.fromiter((x.right for x in self._nodes), np.int64, n),
            np.fromiter((x.value for x in self._nodes), np.float64, n),
        )
        self._flat = (n, arrays)
        return arrays

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Level-synchronous gather traversal over the flat node arrays: all
        samples advance one level per pass, no per-node Python loop. Leaf
        values are read straight from the table, so the result is bit-exact
        vs :meth:`predict_reference`."""
        X = np.asarray(X, dtype=np.float64)
        m = X.shape[0]
        feature, threshold, left, right, _value = self.flat_arrays()
        node = np.zeros(m, dtype=np.int64)
        rows = np.arange(m)
        feat = feature[node]
        internal = feat >= 0
        # child ids strictly exceed their parent's (builder invariant,
        # enforced on deserialization), so n_nodes passes always suffice
        for _ in range(len(self._nodes)):
            if not internal.any():
                break
            go_left = X[rows, np.maximum(feat, 0)] <= threshold[node]
            node = np.where(
                internal, np.where(go_left, left[node], right[node]), node
            )
            feat = feature[node]
            internal = feat >= 0
        return _value[node]

    def predict_reference(self, X: np.ndarray) -> np.ndarray:
        """Reference oracle: the original per-unique-node traversal. Kept
        for the parity tests — :meth:`predict` must match it bit-for-bit."""
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(X.shape[0], dtype=np.float64)
        # iterative traversal, vectorized over samples per level
        active = np.zeros(X.shape[0], dtype=np.int64)  # node id per sample
        done = np.zeros(X.shape[0], dtype=bool)
        while not done.all():
            for nid in np.unique(active[~done]):
                node = self._nodes[nid]
                sel = (active == nid) & ~done
                if node.feature < 0:
                    out[sel] = node.value
                    done |= sel
                else:
                    go_left = X[:, node.feature] <= node.threshold
                    active = np.where(sel & go_left, node.left, active)
                    active = np.where(sel & ~go_left, node.right, active)
        return out

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)
