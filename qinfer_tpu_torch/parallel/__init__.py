"""The particle bank spread over the ranks of a ``torch.distributed``
process group.

Counterpart of ``qinfer_tpu/parallel/`` (the JAX package's stand-in for
the reference's ipyparallel fan-out, ``src/qinfer/parallel.py``): a mesh
of ranks (``mesh``), the sharded SMC step, distributed systematic
resampling, sharded design and the adaptive episode
(``sharded_smc``), and ``DirectViewParallelizedModel``. The caller starts
the process group (``torchrun``, ``init_process_group``, or a rank a
process through ``launch``); NCCL on CUDA, gloo on the CPU.
"""

from .direct_view import DirectViewParallelizedModel
from .mesh import (
    PARTICLE_AXIS,
    TRIAL_AXIS,
    host_local_mesh,
    make_particle_mesh,
    replicate,
    shard_episode_keys,
    shard_state,
)
from .sharded_smc import (
    distributed_systematic_pick,
    distributed_systematic_pick_ring,
    global_logsumexp,
    make_sharded_adaptive_episode,
    make_sharded_expdesign,
    make_sharded_greedy_propose,
    make_sharded_pgh_propose,
    make_sharded_update_step,
    sharded_ess,
    sharded_moments,
    sharded_sample,
)

__all__ = [
    "DirectViewParallelizedModel",
    "PARTICLE_AXIS",
    "TRIAL_AXIS",
    "make_particle_mesh",
    "host_local_mesh",
    "shard_state",
    "shard_episode_keys",
    "replicate",
    "global_logsumexp",
    "sharded_ess",
    "sharded_moments",
    "distributed_systematic_pick",
    "distributed_systematic_pick_ring",
    "make_sharded_update_step",
    "make_sharded_expdesign",
    "make_sharded_greedy_propose",
    "make_sharded_pgh_propose",
    "make_sharded_adaptive_episode",
    "sharded_sample",
]
