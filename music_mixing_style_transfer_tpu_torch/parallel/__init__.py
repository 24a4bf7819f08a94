from .collectives import all_reduce_mean_, average_bn_stats_, gather_with_grad
from .mesh import Mesh, Ranks, create_mesh, init_process_group_from_env, rank_device

__all__ = [
    "Mesh",
    "Ranks",
    "create_mesh",
    "init_process_group_from_env",
    "rank_device",
    "gather_with_grad",
    "all_reduce_mean_",
    "average_bn_stats_",
]
