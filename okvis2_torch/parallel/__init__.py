"""Multi-device solves over ``torch.distributed``: the landmark-sharded
bundle adjustment and its spawned SPMD runs."""

from okvis2_torch.parallel.sharded_ba import (
    Mesh,
    make_mesh,
    shard_problem_by_landmark,
    solve_full_graph_sharded,
)

__all__ = ["Mesh", "make_mesh", "shard_problem_by_landmark", "solve_full_graph_sharded"]
