"""Gradient-boosted regression trees in pure numpy.

``xgboost`` is not installable in this offline environment, so the paper's
XGBoost efficiency model (eta_comp / eta_comm, §3.5) is backed by this
from-scratch implementation: histogram-binned greedy regression trees with
second-order (Newton) leaf weights and shrinkage — the same algorithm family
as XGBoost's ``hist`` tree method restricted to squared loss.

The port's copy of the JAX package's ``gbt`` (NumPy and stdlib only):
the port imports nothing of the JAX package.
"""
from repro_torch.gbt.tree import RegressionTree, validate_node_table
from repro_torch.gbt.boosting import GradientBoostedTrees

__all__ = ["RegressionTree", "GradientBoostedTrees", "validate_node_table"]
