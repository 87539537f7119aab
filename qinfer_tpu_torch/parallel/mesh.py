"""Meshes over a process group, and a rank's block of a state.

Counterpart of ``qinfer_tpu/parallel/mesh.py``. The JAX package shards
arrays over the devices of a ``jax.sharding.Mesh``; here every rank of a
``torch.distributed`` process group is one device of the mesh and holds
its own block of the particle bank, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions carry the
JAX package's axis names:

- ``particles``: the bank's rows, split into one contiguous block a rank;
  weight normalization, ESS and moments are all-reduces over this axis.
- ``trials``: independent episodes, one block of trials a rank.

Nothing here creates a process group: the caller initialises it
(``torchrun`` or ``torch.distributed.init_process_group``), and
``make_particle_mesh`` raises without one. Meshes over CUDA devices
(``device_type="cuda"``, the default) run their collectives with NCCL;
the CPU tests pass ``"cpu"`` over gloo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = ["PARTICLE_AXIS", "TRIAL_AXIS", "make_particle_mesh",
           "host_local_mesh", "shard_state", "shard_episode_keys",
           "replicate"]

PARTICLE_AXIS = "particles"
TRIAL_AXIS = "trials"


def _world_size():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "qinfer_tpu_torch.parallel needs a process group: start the "
            "program under torchrun or call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_particle_mesh(n_devices=None, device_type="cuda"):
    """1-D mesh over the ``particles`` axis spanning every rank of the
    default process group (``n_devices``, when given, must be its size)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a particle mesh spans every rank: n_devices="
                         f"{n_devices} but the process group has {world}")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(PARTICLE_AXIS,))


def host_local_mesh(n_trials_axis, n_particle_axis=None, device_type="cuda"):
    """2-D mesh (trials × particles) over every rank of the default
    process group, for sharded ensembles."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size()
    if n_particle_axis is None:
        n_particle_axis = world // n_trials_axis
    if n_trials_axis * n_particle_axis != world:
        raise ValueError(f"a {n_trials_axis} × {n_particle_axis} mesh does "
                         f"not cover the {world} ranks of the process group")
    return init_device_mesh(device_type, (n_trials_axis, n_particle_axis),
                            mesh_dim_names=(TRIAL_AXIS, PARTICLE_AXIS))


def _block(n, mesh, axis):
    """This rank's slice of ``n`` rows split over ``axis`` of ``mesh``."""
    k = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} ranks of the "
                         f"{axis!r} axis")
    size = n // k
    start = mesh.get_local_rank(axis) * size
    return slice(start, start + size)


def shard_state(state, mesh):
    """This rank's block of an ``SMCState``: the contiguous row block of
    ``particle_locations`` and ``particle_log_weights`` along the
    ``particles`` axis; the scalars and the generator are kept as they are
    (replicated: every rank must hold the same values and a generator
    seeded alike). The bank's size must divide by the axis's size."""
    rows = _block(state.particle_log_weights.shape[0], mesh, PARTICLE_AXIS)
    return dataclasses.replace(
        state,
        particle_locations=state.particle_locations[rows].contiguous(),
        particle_log_weights=state.particle_log_weights[rows].contiguous())


def shard_episode_keys(seeds, mesh):
    """This rank's block of a (n_trials, …) array of per-trial seeds,
    along the ``trials`` axis."""
    return seeds[_block(len(seeds), mesh, TRIAL_AXIS)]


def replicate(tree, mesh):
    """Every tensor of ``tree`` (a tensor, or a dict, list or tuple of
    them) as the value on the mesh's first rank, broadcast to all of its
    ranks (a mesh here spans the whole process group); other leaves are
    returned as they are. Returns new tensors."""
    src = int(mesh.mesh.flatten()[0])

    def put(leaf):
        if isinstance(leaf, torch.Tensor):
            out = leaf.clone(memory_format=torch.contiguous_format)
            dist.broadcast(out, src=src)
            return out
        if isinstance(leaf, dict):
            return {k: put(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(put(v) for v in leaf)
        return leaf

    return put(tree)
