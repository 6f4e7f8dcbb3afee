"""View and ray sharding of the port over a torch.distributed process
group."""
from .sharded import (ShardedViews, ViewShard, all_gather_cat,
                      all_reduce_mean_grads_, dryrun, dryrun_pipeline,
                      make_mesh, make_sharded_denoise_step,
                      make_sharded_nerf_step, reduce_sum, replicate_, shard)

__all__ = ["make_mesh", "make_sharded_denoise_step",
           "make_sharded_nerf_step", "dryrun", "dryrun_pipeline",
           "ViewShard", "ShardedViews", "shard", "all_gather_cat",
           "reduce_sum", "all_reduce_mean_grads_", "replicate_"]
