#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds S [S ...] --seconds <s>

For each seed, in one process: the cell's driver runs its set-up and a
window of ``--seconds`` at the cell's own load, then prints one JSON line
with the numbers the run compares, read twice: for the program
(``program``), and for the control (``control``): the plain reference
itself put in the program's place and computed in bfloat16, the
precision below the configuration's float32, whose numbers must come out
over the limits. The benchmark's own runs do not run the control.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for cache, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[cache] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]

from harness import registry, window  # noqa: E402


def readings(cell, seed, seconds, device):
    """The program's and the control's numbers for one seed."""
    mod = cell.module("drivers", cell.traffic["driver"])
    drv = mod.Driver(cell, seed, device)
    drv.setup()
    win = window.run(drv, seconds, device=device)
    drv.release()
    out = {"seed": seed, "units": win.units}
    for name, control in (("program", False), ("control", True)):
        out[name] = {c.name: c.value for c in drv.check(control)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.Registry().cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = readings(cell, seed, args.seconds, "cuda:0")
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
