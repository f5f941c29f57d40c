"""Run one cell of the port's benchmark once and print one result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its configuration, traffic and
metric readers are found by name (:mod:`benchmark.cell`).  The run makes the
capture from the seed, warms ``doppler_tpu_torch.cli.main`` on a short
input, measures one window of ``--seconds`` through it (:mod:`.drive`),
reads the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
from a device trace of the window (``--trace 1``), and then holds what the
window wrote to the plain reference (:mod:`.check`).  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``breakdown``) and, last,
``checks``: each number compared with its limit, which also end standard
error.

Exits with 2 and prints no result without a CUDA card (or with fewer cards
than the cell asks for), and with 3 if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``doppler_tpu`` is loaded in this process once the window has
closed.  Scratch files go to a directory under ``TMPDIR``, removed at exit.
"""

from __future__ import annotations

import time

_T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

__all__ = ["main", "forbidden_modules"]

FORBIDDEN = ("jax", "jaxlib", "flax", "doppler_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that a run may not load, each
    compared whole (``doppler_tpu_torch`` is not ``doppler_tpu``)."""
    names = {m.split(".")[0] for m in list(modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def main(argv=None, *, device: str = "cuda", root: Path | None = None,
         t_process: float | None = None) -> int:
    """``device='cpu'`` (tests only) skips the look for a card and runs the
    kernels' plain versions; ``root`` is the benchmark folder to find the
    cell's files in (``BENCHMARK.json`` beside it)."""
    args = _parse(argv)
    from benchmark.cell import HERE, load_cell, load_metric_reader

    root = Path(root) if root is not None else HERE
    cell = load_cell(args.workload, root=root)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"no result: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.check import check_outputs
    from benchmark.drive import drive
    from benchmark.readings import busy_s
    from benchmark.trace import breakdown

    workdir = tempfile.mkdtemp(prefix="benchmark-")
    try:
        run = drive(cell, args.seed, args.seconds, bool(args.trace), device,
                    _T_PROCESS if t_process is None else t_process, workdir)
        metrics = {}
        for m in cell.per_layer if args.trace else cell.end_to_end:
            value = load_metric_reader(m["name"], root)(run)
            if _finite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else device),
               "count": cell.chips,
               "memory_peak_bytes": run.memory_peak_bytes}
        extra = {}
        if args.trace and run.stretch is not None:
            dev["busy_s"] = busy_s(run.stretch)
            dev["window_s"] = run.stretch.seconds
            extra["breakdown"] = breakdown(run.stretch,
                                           run.source.spans.spans,
                                           run.sink.spans.spans)
        if args.trace:
            print(f"traced stretch: {run.stretch.seconds if run.stretch else 0:.6f} s, "
                  f"complete={bool(run.stretch and run.stretch.complete)}, "
                  f"launches={run.stretch.launches if run.stretch else {}}",
                  file=sys.stderr)
        late = getattr(run.source, "late", None)
        if late is not None and len(late):
            print(f"live source woke late: p95 {1e3 * float(sorted(late)[int(0.95 * (len(late) - 1))]):.6f} ms, "
                  f"max {1e3 * float(max(late)):.6f} ms over {len(late)} pieces",
                  file=sys.stderr)
        print(f"window: {run.n_in} samples in {run.wall_s:.6f} s; "
              f"host plan+stage {run.host_s:.6f} s; setup {run.setup_s:.6f} s "
              f"({', '.join(f'{k} {v:.3f}' for k, v in run.setup_parts)})",
              file=sys.stderr)

        # the check: after the peak was read, with the program's state freed
        capture, n_in, outputs, seed = run.capture, run.n_in, run.outputs, run.seed
        del run
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        res = check_outputs(cell.config, capture, n_in, outputs, seed, device)
        t_check = time.perf_counter() - t_check
        limits = cell.config["check"]["limits"]
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in res["numbers"].items()}
        correct = all(_finite(c["value"]) and c["value"] <= c["limit"]
                      for c in checks.values())
        bad = forbidden_modules()
        if bad:
            print(f"no result: loaded in this process: {', '.join(bad)}",
                  file=sys.stderr)
            return 3
        print(f"compared {res['compared']} outputs of {res['attempted']} due "
              f"in {t_check:.3f} s", file=sys.stderr)
        for k, c in checks.items():
            print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        line = {"correct": bool(correct), "attempted": res["attempted"],
                "failed": res["failed"], "metrics": metrics, "device": dev,
                **extra, "checks": checks}
        print(json.dumps(line))
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
