"""Rank functions for tests/test_torch_port_parallel.py. `parallel.spawn`
pickles a rank function by its module, and each rank imports that module:
this one imports torch and the port only, so a rank does not import JAX."""

import torch

from lct_gan_tpu_torch.data import ScpDataset
from lct_gan_tpu_torch.parallel import broadcast_state_
from lct_gan_tpu_torch.train import (TrainConfig, create_state,
                                     make_eval_step, validate)

CFG = TrainConfig(segment_seconds=0.25, batch_size=4)
# (name, adaptive_target_seconds, batch_size): 1 and 3 rows a bucketed
# batch (rounded up to 2 and 4 over 2 ranks), and fixed batches of 4.
VAL_CASES = (("adaptive 2 s", 2.0, 8), ("adaptive 4 s", 4.0, 8),
             ("fixed B=4", None, 4))


def val_ds(tree):
    return ScpDataset(tree, "test.scp", "test", sample_rate=16000,
                      segment_length=None, random_segment=False)


def validate_cases(mesh, tree):
    """`validate` of a seeded state (rank 0's on every rank) in every
    VAL_CASES case, with STOI, sharded over `mesh`."""
    state = create_state(CFG, torch.Generator().manual_seed(0),
                         device=mesh.device, precise=True)
    broadcast_state_(state, mesh)
    step = make_eval_step(CFG)
    return [validate(step, state.enhancer, val_ds(tree), CFG, bs,
                     compute_pesq=False, compute_stoi=True, num_workers=2,
                     adaptive_target_seconds=target,
                     batch_multiple=mesh.world, mesh=mesh)
            for _, target, bs in VAL_CASES]


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one refuses")
    return mesh.rank
