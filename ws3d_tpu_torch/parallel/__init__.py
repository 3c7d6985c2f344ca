"""Data parallelism on torch.distributed: one process a device (mesh.py),
the global-batch context of data_parallel_jit (global_batch.py) and the
multi-rank parity dryrun (dryrun.py)."""
from ws3d_tpu_torch.parallel.mesh import (  # noqa: F401
    Group, LocalShard, all_gather, all_reduce_mean, data_parallel_infer,
    data_parallel_jit, data_parallel_step, destroy_group, init_group, launch, make_mesh,
    rank_seed, replicate, shard_batch, shard_batch_multihost)
