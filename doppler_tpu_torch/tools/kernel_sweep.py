"""Times the chain and cascade kernels over their launch geometries.

The kernels' bytes do not depend on the tile, the threads of a CTA or the
register tile ``R`` of a stage (``csrc/fir.cuh``); their time does.  This
tool runs each of the four cases — the chain at 3/64/370, the cascade at
the config-3 stages, the 100 Msps split front, and the channel-batched
variants with ``--channels`` — over a grid of ``(tile, threads, R per
stage)`` and prints one line a geometry, fastest first, with the geometry
that ``ops/cuda/geometry.py`` picks on its own marked ``*``.  The kernel of
``--precision fast`` at 3/64/370 (``fast``: split3, ``fast-default``: one
pass) sweeps ``(windows, threads)`` the same way (``--kernels
fast,fast-default``), up to 256 windows where the pick stops at 128, and
so does the cascade of the bf16 dots at the config-3 stages (``--kernels
cascade-fast,cascade-fast-default``: one stream, windows in multiples of
16·D of the last stage, and the stage-0 slab, printed as ``slab=``).  K
dispatches between two CUDA events
(``runtime/timing.py``), best of ``--iters``.  It measures a card and fails
without one.

    python -m doppler_tpu_torch.tools.kernel_sweep --blocks 16384
    python -m doppler_tpu_torch.tools.kernel_sweep --blocks 256 --channels 16
    python -m doppler_tpu_torch.tools.kernel_sweep --kernels fast,fast-default
    python -m doppler_tpu_torch.tools.kernel_sweep --kernels cascade-fast,cascade-fast-default
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

from doppler_tpu_torch.ops.cuda import cascade, chain, geometry
from doppler_tpu_torch.runtime.timing import card_label, timed_dispatches
from doppler_tpu_torch.tools import kernel_digests

TILES = {"chain": (128, 192, 256, 384, 512, 768),
         "cascade": (128, 192, 256, 384, 512),
         "front": (16, 32, 48, 64)}
THREADS = (128, 256, 384, 512)
FAST_THREADS = (64, 128, 192, 256)
FAST_WINDOWS = (256, 192) + geometry.FAST_WINDOWS
FAST = {"fast": 3, "fast-default": 1}       # sweep name -> bf16 passes
CASCADE_FAST = {"cascade-fast": 3, "cascade-fast-default": 1}
CASCADE_FAST_SLABS = (2, 4, 8)                # M-tiles of stage 0 a slab


def _grid(kernel, stages, limit):
    """Every geometry of the sweep that fits ``limit`` bytes a CTA."""
    if kernel in CASCADE_FAST:
        m0 = 16 * geometry.cascade_fast_columns(stages, kernel_digests.L)[0]
        for windows, threads, k in itertools.product(
                geometry.CASCADE_FAST_WINDOWS, FAST_THREADS, CASCADE_FAST_SLABS):
            try:
                lay = geometry.cascade_fast_layout(stages, kernel_digests.L, windows,
                                                   threads, CASCADE_FAST[kernel],
                                                   k * m0)
            except ValueError:
                continue
            if lay.smem_bytes <= limit:
                yield windows, threads, (k * m0,)
        return
    if kernel in FAST:
        (P, Q, T), = stages
        for windows, threads in itertools.product(FAST_WINDOWS, FAST_THREADS):
            try:
                lay = geometry.fast_layout(P, Q, T, kernel_digests.L, windows,
                                           threads, FAST[kernel])
            except ValueError:
                continue
            if lay.smem_bytes <= limit:
                yield windows, threads, ()
        return
    choices = [geometry.r_choices(P) for P, _, _ in stages]
    for tile, threads in itertools.product(TILES[kernel], THREADS):
        for regs in itertools.product(*choices):
            try:
                lay = geometry.layout(stages, tile, threads, regs)
            except ValueError:
                continue
            if lay.smem_bytes <= limit:
                yield tile, threads, regs


def sweep(kernel: str, B: int, C: int, iters: int, K: int, device) -> list:
    """``[(ms, tile, threads, regs, picked)]`` for one kernel, fastest first."""
    stages, banks = kernel_digests.geometry(
        "chain" if kernel in FAST else "cascade" if kernel in CASCADE_FAST else kernel)
    data, plans = kernel_digests.seeded_inputs(B, "i16", C)
    data = torch.from_numpy(data).to(device)
    plans = torch.from_numpy(plans).to(device)
    banks = [torch.from_numpy(b).to(device) for b in banks]
    carries = [torch.from_numpy(c).to(device)
               for c in kernel_digests.seeded_carries(stages, C)]
    L = kernel_digests.L
    n_out = B * L
    for P, Q, _ in stages:
        n_out = n_out // Q * P
    outtype = "f32" if kernel == "front" else "i16"
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin

    def step(geom):
        if kernel in CASCADE_FAST:
            g = None if geom is None else (*geom[:2], *geom[2])
            p0, c0 = plans[:, 0].contiguous(), [c[0].contiguous() for c in carries]
            return lambda: cascade._launch_fast(data, p0, banks, c0, B, L, stages,
                                                n_out, "i16", outtype,
                                                CASCADE_FAST[kernel], geom=g)
        if kernel in FAST:
            (P, Q, T), = stages
            g = None if geom is None else geom[:2]
            return lambda: chain._launch_fast(data, plans, banks[0], carries[0], C,
                                              B, L, P, Q, T, "i16", outtype, geom=g,
                                              passes=FAST[kernel])
        if kernel == "chain":
            (P, Q, T), = stages
            g = None if geom is None else (geom[0], geom[1], geom[2][0])
            return lambda: chain._launch(data, plans, banks[0], carries[0], C,
                                         B, L, P, Q, T, "i16", outtype, geom=g)
        return lambda: cascade._launch(data, plans, banks, carries, C, B, L,
                                       stages, n_out, "i16", outtype, geom=geom)

    if kernel in CASCADE_FAST:
        picked = cascade.plan_launch_fast(device, stages, L, CASCADE_FAST[kernel],
                                          windows=n_out // stages[-1][0])
        picked = (picked.windows, picked.threads, (picked.slab,))
    elif kernel in FAST:
        picked = geometry.pick_chain_fast(*stages[0], kernel_digests.L, limit,
                                          FAST[kernel])
        picked = (picked.windows, picked.threads, ())
    else:
        picked = geometry.pick_cascade(stages, limit)
        picked = (picked.tile, picked.threads, picked.regs)
    geoms = list(dict.fromkeys([picked, *_grid(kernel, stages, limit)]))
    best = {g: float("inf") for g in geoms}
    for g in geoms:
        step(g)()
    torch.cuda.synchronize(device)
    for _ in range(iters):
        for g in geoms:
            best[g] = min(best[g], timed_dispatches(step(g), K, device))
    rows = sorted((best[g] / K * 1e3, *g, g == picked) for g in geoms)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=16384)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--kernels", default=",".join(kernel_digests.KERNELS))
    ap.add_argument("--top", type=int, default=12, help="lines a kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures a card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    label = card_label(device)
    result = {}
    for kernel in args.kernels.split(","):
        # what the wrapper itself costs: the same call on 8 blocks, where the
        # kernel is over long before the next launch is enqueued
        host = sweep(kernel, 8, args.channels, args.iters, args.dispatches,
                     device)
        print(f"{kernel:8s} wrapper alone (8 blocks): {host[0][0]:.4f} to "
              f"{host[-1][0]:.4f} ms/dispatch: a time below it measures the "
              f"host [{label}]", file=sys.stderr)
        rows = sweep(kernel, args.blocks, args.channels, args.iters,
                     args.dispatches, device)
        shown = rows[:args.top] + [r for r in rows[args.top:] if r[-1]]
        for ms, tile, threads, regs, picked in shown:
            knob = "slab" if kernel in CASCADE_FAST else "R"
            print(f"{kernel:8s} B={args.blocks} C={args.channels} tile={tile:4d} "
                  f"threads={threads:4d} {knob}={regs} {ms:9.4f} ms/dispatch"
                  f"{' *' if picked else ''} [{label}]", file=sys.stderr)
        print(f"{kernel:8s} slowest of {len(rows)}: {rows[-1][0]:.4f} ms "
              f"{rows[-1][1:4]} [{label}]", file=sys.stderr)
        result[kernel] = [{"ms": r[0], "tile": r[1], "threads": r[2],
                           "regs": list(r[3]), "picked": r[4]} for r in rows]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
