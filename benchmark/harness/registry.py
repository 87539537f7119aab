"""Where the benchmark finds what a cell is made of, by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own under the benchmark's folder:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), whose
  ``reference`` names ``reference/<name>.py``;
- ``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<kind>.py``;
- ``metrics/<metric>.py`` for each per-layer metric, with a ``read``;
- ``held/<cell>.json``: a cell held back from ``BENCHMARK.json`` (PERF.md
  says why), as the entries that bring it back: each entry that names a
  metric or configuration already there adds its ``workloads`` to that
  one's, the others are new. ``Registry(held=True)`` reads them in, so
  that the tests still run a held cell.

A later change adds a cell, a configuration or a metric by adding such
files and entries in ``BENCHMARK.json``, and edits nothing here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FOLDER = "benchmark"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files read."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports
    registry: "Registry"

    def module(self, kind, name):
        return self.registry.module(kind, name)


def merge(spec, entries):
    """``entries`` (a held cell's file) added to ``spec`` in place."""
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"]: e for e in spec[key]}
        for e in entries.get(key, ()):
            if e["name"] in have:
                have[e["name"]]["workloads"] += e["workloads"]
            else:
                spec[key].append(e)


class Registry:
    """``BENCHMARK.json`` and the benchmark's folder under ``root``."""

    def __init__(self, root=ROOT, held=False):
        self.root = Path(root)
        self.folder = self.root / FOLDER
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        if held:
            for path in sorted((self.folder / "held").glob("*.json")):
                merge(self.spec, json.loads(path.read_text()))
        self._modules = {}

    def path(self, kind, name, suffix):
        if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name):
            raise ValueError(f"not a name: {name!r}")
        return self.folder / kind / f"{name}{suffix}"

    def module(self, kind, name):
        """``<folder>/<kind>/<name>.py``, loaded once by its path."""
        key = (kind, name)
        if key not in self._modules:
            path = self.path(kind, name, ".py")
            mod_name = f"_bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None:
                raise FileNotFoundError(path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def cell(self, name):
        """The cell ``name`` of ``workloads``, its files read."""
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(by_name)})")
        w = by_name[name]
        cfg_entry = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        with open(self.root / cfg_entry["file"]) as f:
            config = json.load(f)
        with open(self.path("traffic", w["traffic"], ".json")) as f:
            traffic = json.load(f)

        def applies(metric, reported=None):
            if "workloads" in metric:
                return name in metric["workloads"]
            return reported is None or metric["moves"] in reported

        e2e = [m for m in self.spec["end_to_end"] if applies(m)]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"] if applies(m, moved)]
        return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                    traffic, e2e, per_layer, self)
