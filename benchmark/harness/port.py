"""The system under test, built from a configuration file: the model, the
prior, the resampler and the step's settings of ``qinfer_tpu_torch``.

A configuration names each object by its import path in the port, with
the arguments to call it with, and an argument may name an object in
turn::

    "model": {"call": "qinfer_tpu_torch.tomography.TomographyModel",
              "kwargs": {"basis": {"call":
                  "qinfer_tpu_torch.tomography.pauli_basis",
                  "kwargs": {"nq": 1}}}}

so a configuration with a model, prior or resampler that no other one
uses is a new file, and nothing here changes. The port is imported inside
``build``, never when this module is imported.
"""

from __future__ import annotations

import dataclasses
import importlib

PACKAGE = "qinfer_tpu_torch"


@dataclasses.dataclass
class System:
    model: object
    prior: object
    resampler: object
    smc_config: object
    n_particles: int


def resolve(path):
    """The object at ``path`` (``<module>.<name>``), a module of the port."""
    if path.split(".")[0] != PACKAGE:
        raise ValueError(f"{path!r} is not in {PACKAGE}")
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


def make(spec):
    """``spec`` with every ``{"call": path, "kwargs": {...}}`` in it
    called, innermost first."""
    if not isinstance(spec, dict):
        return spec
    kwargs = {k: make(v) for k, v in spec.get("kwargs", {}).items()}
    return resolve(spec["call"])(**kwargs)


def build(config, n_particles=None):
    """The port's objects for ``config`` (a configuration file's dict)."""
    from qinfer_tpu_torch.smc import SMCConfig

    return System(
        model=make(config["model"]),
        prior=make(config["prior"]),
        resampler=make(config["resampler"]),
        smc_config=SMCConfig(**config["smc"]),
        n_particles=int(n_particles or config["n_particles"]),
    )
