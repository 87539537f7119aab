"""Checkpoint and resume of an ``SMCUpdater``. Counterpart of
``qinfer_tpu/checkpointing.py``.

- ``save_npz``/``load_npz``: one ``.npz`` in the JAX package's layout
  (``state__<field>`` for each array of the state, ``normalization_record``,
  ``call_count`` and ``data_record``, a pickled object array), plus
  ``state__generator``, the byte state of the updater's
  ``torch.Generator``, so that a port updater resumes bit for bit. A
  JAX-written file loads too: particles, weights, scalars and records.
  Its ``state__key`` (a JAX PRNG key) has no torch meaning, so the
  generator is then seeded from the key's bytes (the same file gives the
  same generator every time, but not the JAX package's draws).
- ``save_torch``/``load_torch``: ``torch.save`` of the same, in place of
  the JAX package's orbax checkpoint. With a process group each rank
  writes and reads its own file (its block of a sharded bank, as orbax's
  hosts write theirs), ``shard-<rank>-of-<size>.pt`` in the directory.

``load_*`` unpickle, so load only files that this package (or the JAX
package) wrote. The updater to load into must be built with the same
model; its device is kept.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .smc import SMCState, SMCUpdater

__all__ = ["save_npz", "load_npz", "save_torch", "load_torch"]

_ARRAYS = {
    "particle_locations": torch.float32,
    "particle_log_weights": torch.float32,
    "n_resamples": torch.int32,
    "min_n_ess": torch.float32,
    "log_total_likelihood": torch.float32,
    "just_resampled": torch.bool,
    "n_zero_weight_events": torch.int32,
}


def _records(updater: SMCUpdater):
    # data_record entries are (outcome, expparams dict) tuples of arrays:
    # heterogeneous, so they ride as a pickled object array.
    data_record = np.empty(len(updater.data_record), dtype=object)
    for i, entry in enumerate(updater.data_record):
        data_record[i] = entry
    return {"normalization_record": np.asarray(updater.normalization_record,
                                               dtype=np.float64),
            "call_count": np.int64(updater._call_count),
            "data_record": data_record}


def _restore(updater: SMCUpdater, arrays, generator_state, records):
    """Put the state's arrays (numpy, by field), the generator's byte state
    (or None) and the records into ``updater``."""
    device = updater.device
    generator = updater.state.generator
    if generator_state is not None:
        generator.set_state(torch.as_tensor(np.asarray(generator_state),
                                            dtype=torch.uint8))
    elif "key" in arrays:
        seed = int.from_bytes(np.asarray(arrays["key"]).tobytes()[-8:],
                              "little") % (1 << 63)
        generator.manual_seed(seed)
    updater.state = SMCState(generator=generator, **{
        name: torch.as_tensor(np.asarray(arrays[name]), dtype=dtype,
                              device=device)
        for name, dtype in _ARRAYS.items()})
    # Loading into an updater of another size is allowed.
    updater._n_particles = int(updater.state.particle_locations.shape[0])
    updater.normalization_record = [
        float(x) for x in np.asarray(records["normalization_record"])]
    updater._call_count = int(records["call_count"])
    if "data_record" in records:
        updater.data_record = list(records["data_record"])
    return updater


def save_npz(path, updater: SMCUpdater):
    """Write the updater's state, generator and records to one .npz."""
    state = updater.state
    payload = {f"state__{name}": getattr(state, name).detach().cpu().numpy()
               for name in _ARRAYS}
    payload["state__generator"] = state.generator.get_state().numpy()
    payload.update(_records(updater))
    np.savez(path, **payload)


def load_npz(path, updater: SMCUpdater) -> SMCUpdater:
    """Restore a ``save_npz`` file (or the JAX package's) into
    ``updater``. Returns the updater."""
    data = np.load(path, allow_pickle=True)
    arrays = {k[len("state__"):]: data[k] for k in data.files
              if k.startswith("state__")}
    return _restore(updater, arrays, arrays.pop("generator", None),
                    {k: data[k] for k in data.files
                     if not k.startswith("state__")})


def _torch_file(path, group):
    path = Path(path)
    if group is None:
        return path / "state.pt"
    import torch.distributed as dist

    return path / (f"shard-{dist.get_rank(group)}-of-"
                   f"{dist.get_world_size(group)}.pt")


def save_torch(path, updater: SMCUpdater, group=None):
    """``torch.save`` of the state, generator and records into the
    directory ``path`` (created): ``state.pt``, or with ``group`` this
    rank's ``shard-<rank>-of-<size>.pt`` (``updater.state`` then holds the
    rank's block)."""
    file = _torch_file(path, group)
    file.parent.mkdir(parents=True, exist_ok=True)
    state = updater.state
    torch.save({"state": {name: getattr(state, name).detach().cpu()
                          for name in _ARRAYS},
                "generator": state.generator.get_state(),
                "records": _records(updater)}, file)


def load_torch(path, updater: SMCUpdater, group=None) -> SMCUpdater:
    """Restore ``save_torch``'s file (this rank's with ``group``) into
    ``updater``. Returns the updater."""
    saved = torch.load(_torch_file(path, group), weights_only=False)
    return _restore(updater, {k: v.numpy() for k, v in saved["state"].items()},
                    saved["generator"], saved["records"])
