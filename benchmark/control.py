"""The control of the comparison: the plain reference, computed in
bfloat16 (the precision below the float32 that the binary states), put in
the program's place and held to the float64 reference exactly as a run's
outputs are, over the input a run of the cell consumes.

    python -m benchmark.control --workload <name> --samples <n_in> --seeds 1,2,3

One JSON line a seed: the numbers compared and the limits.  The control
needs no window: what a run's check compares depends on the seed and on
how many input samples the run consumed, which ``--samples`` gives.  It
runs where the check runs, on the card (``--device cpu`` for a small cell
in the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from benchmark.capture import make_capture
from benchmark.cell import HERE, load_cell
from benchmark.check import check_outputs

__all__ = ["control_numbers", "main"]


def control_numbers(config: dict, seed: int, n_in: int, device) -> dict:
    """The numbers a run would compare, with the bfloat16 reference as the
    program."""
    capture = make_capture(config, seed, device).cpu().numpy()
    return check_outputs(config, capture, n_in, None, seed, device,
                         dtype=torch.bfloat16)["numbers"]


def main(argv=None, root: Path | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--samples", type=int, required=True,
                    help="input samples a run of the cell consumes")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, root=Path(root) if root else HERE)
    limits = cell.config["check"]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(cell.config, seed, args.samples, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "samples": args.samples, "control": nums,
                          "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
