"""Data parallelism of the port over torch.distributed (the counterpart of
`lct_gan_tpu/parallel`): `mesh` holds the process group and its
collectives; `dryrun` runs one GAN step over n ranks against the 1-rank
step (`python -m lct_gan_tpu_torch.parallel.dryrun`)."""

from lct_gan_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean_,
                                             all_reduce_sum_, barrier,
                                             broadcast_object,
                                             broadcast_state_, close_mesh,
                                             default_world, make_mesh,
                                             replicas_equal, shard_batch,
                                             spawn, state_tensors)

__all__ = ["Mesh", "all_reduce_mean_", "all_reduce_sum_", "barrier",
           "broadcast_object", "broadcast_state_", "close_mesh",
           "default_world", "make_mesh", "replicas_equal", "shard_batch",
           "spawn", "state_tensors"]
