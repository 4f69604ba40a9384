from .mesh import Mesh, gather_rays, make_mesh, replicate, shard_rays, sum_over_ranks

__all__ = ["Mesh", "gather_rays", "make_mesh", "replicate", "shard_rays",
           "sum_over_ranks"]
