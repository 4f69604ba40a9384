from .mesh import (Mesh, RanksDisagree, check_replicated, gather_rays,
                   make_mesh, replicate, replicate_all, shard_rays,
                   sum_over_ranks)

__all__ = ["Mesh", "RanksDisagree", "check_replicated", "gather_rays",
           "make_mesh", "replicate", "replicate_all", "shard_rays",
           "sum_over_ranks"]
