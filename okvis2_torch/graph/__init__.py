from okvis2_torch.graph.estimator import Estimator, EstimatorConfig
from okvis2_torch.graph.mst import max_spanning_tree

__all__ = ["max_spanning_tree", "Estimator", "EstimatorConfig"]
