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
16·D of the last stage, and the stage-0 slab, printed as ``slab=``).  The
chain-shaped mix probe (``--kernels chain-shape``: ``csrc/probes.cu``, the
fold tone, at the chain's tile on the tools' data) sweeps warps a CTA ×
warps a tile (split) × groups loaded ahead (depth), printed as ``warps=
split= depth=``; each of its dispatches is a CUDA graph
of ``SHAPE_GRAPH`` launches and its time is a launch's, since at the CLI's
B = 256 the wrapper's host time is ten times the kernel's, printed beside
each launch's device time from ``torch.profiler``.  K dispatches
between two CUDA events
(``runtime/timing.py``), best of ``--iters``.  It measures a card and fails
without one.

    python -m doppler_tpu_torch.tools.kernel_sweep --blocks 16384
    python -m doppler_tpu_torch.tools.kernel_sweep --blocks 256 --channels 16
    python -m doppler_tpu_torch.tools.kernel_sweep --kernels fast,fast-default
    python -m doppler_tpu_torch.tools.kernel_sweep --kernels cascade-fast,cascade-fast-default
    python -m doppler_tpu_torch.tools.kernel_sweep --kernels chain-shape --blocks 256
    python -m doppler_tpu_torch.tools.kernel_sweep --kernels window,conv --cases c3-2p24/C1,tail/C1

The resampler's kernels (``--kernels window,conv``, ``csrc/window.cu`` and
``csrc/conv.cu``) sweep both paths of ``ops/cuda/geometry.py`` (the fir /
tile path's threads and R / RC, the rows path's threads and outputs a
thread) at the digest cases of ``tools/kernel_digests.py`` named by
``--cases``, each layout's profiler device µs a launch, fastest first.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

import torch

from doppler_tpu_torch.ops.cuda import build, cascade, chain, geometry, probes
from doppler_tpu_torch.runtime.timing import card_label, timed_dispatches
from doppler_tpu_torch.tools import common, kernel_digests

TILES = {"chain": (128, 192, 256, 384, 512, 768),
         "cascade": (128, 192, 256, 384, 512),
         "front": (16, 32, 48, 64)}
THREADS = (128, 256, 384, 512)
FAST_THREADS = (64, 128, 192, 256)
FAST_WINDOWS = (256, 192) + geometry.FAST_WINDOWS
FAST = {"fast": 3, "fast-default": 1}       # sweep name -> bf16 passes
CASCADE_FAST = {"cascade-fast": 3, "cascade-fast-default": 1}
CASCADE_FAST_SLABS = (2, 4, 8)                # M-tiles of stage 0 a slab
SHAPE = "chain-shape"
SHAPE_P, SHAPE_Q = 3, 64                      # the chain's ratio (its tile)
SHAPE_GRAPH = 16                              # launches a graph (a dispatch)


def _shape_grid():
    """Every launch of the chain-shaped mix: (warps, split, depth)."""
    for warps, split, depth in itertools.product((1, 2, 4, 8), (1, 2, 4), (1, 2)):
        if warps % split == 0:
            yield probes.ShapeGeometry(warps, split, depth)


def _device_us(step, launches: int) -> float | None:
    """Mean device µs of the chain-shaped kernel over ``step()``'s
    ``launches`` launches, from ``torch.profiler``; None where the session
    recorded none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if "chain_shape_kernel" in ev.key:
            total += getattr(ev, "device_time_total", None) or ev.cuda_time_total
            count += ev.count
    return total / count if count == launches and total > 0 else None


def sweep_shape(B: int, iters: int, K: int, device) -> list:
    """``[(ms, geometry, picked, device µs or None)]`` for the chain-shaped
    mix, fastest first; the device µs from one profiled graph a geometry."""
    words, plans, _ = common.bench_inputs(B * common.L, device)
    n = words.numel()
    tile = probes.chain_tile(n, SHAPE_P, SHAPE_Q)
    picked = probes.shape_geometry(n // tile, tile, build.sm_count(device.index))
    geoms = list(dict.fromkeys([picked, *_shape_grid()]))

    def graph(g):
        def launch():
            probes._shape_launch(words, plans, SHAPE_P, SHAPE_Q, tile, "fold", g)

        launch()
        torch.cuda.synchronize(device)
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            for _ in range(SHAPE_GRAPH):
                launch()
        return cuda_graph.replay

    steps = {g: graph(g) for g in geoms}
    best = {g: float("inf") for g in geoms}
    for _ in range(iters):
        for g in geoms:
            best[g] = min(best[g], timed_dispatches(steps[g], K, device))
    dev = {g: _device_us(steps[g], SHAPE_GRAPH) for g in geoms}
    return sorted(((best[g] / (K * SHAPE_GRAPH) * 1e3, g, g == picked, dev[g])
                   for g in geoms), key=lambda r: r[0])


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


RESAMPLE_CASES = ("c3-chunk/C1", "c3-2p24/C1", "tail/C1", "tail/C256")


def resample_layouts(kernel: str, name: str, limit: int) -> list:
    """Every layout of both paths of a resampler kernel at a digest case that
    fits ``limit``; the picked one first."""
    case = kernel_digests.RESAMPLE_CASES[name]
    P, Q, T, _ = kernel_digests.resample_stage(case)
    a = kernel_digests.resample_args(case, P, Q, T)
    C, M, R = case.C, a["M"], -(-(Q - 1 + T) // Q)
    if kernel == "window":
        lays = [geometry.pick_window(P, Q, T, C, M, limit)]
        lays += [geometry.window_layout(P, Q, T, C, M, rows=True, threads=t)
                 for t in geometry.ROWS_THREADS if t >= min(C, 32)]
        if P <= geometry.WINDOW_FIR_MAX_P:
            lays += [geometry.window_layout(P, Q, T, C, M, rows=False, threads=t,
                                            R=r)
                     for t in geometry.RESAMPLE_THREADS for r in (1, 2) if t >= P]
    else:
        lays = [geometry.pick_conv(P, Q, R, C, M, a["p0"], limit)]
        lays += [geometry.conv_layout(P, Q, R, C, M, a["p0"], rows=True, threads=t)
                 for t in geometry.ROWS_THREADS]
        if P <= geometry.CONV_TILE_MAX_P:
            lays += [geometry.conv_layout(P, Q, R, C, M, a["p0"], rows=False,
                                          threads=t)
                     for t in geometry.RESAMPLE_THREADS]
    return [lay for lay in dict.fromkeys(lays) if lay.smem_bytes <= limit]


def sweep_resample(kernel: str, name: str, device) -> list:
    """``[(device µs a launch, layout, picked)]`` of a resampler kernel at a
    digest case, fastest first (None where the profiler recorded nothing)."""
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    lays = resample_layouts(kernel, name, limit)
    rows = [(common.device_us(kernel_digests.resample_step(kernel, name, device,
                                                           layout=lay),
                              kernel + "_"), lay, i == 0)
            for i, lay in enumerate(lays)]
    return sorted(rows, key=lambda r: float("inf") if r[0] is None else r[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=16384)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--kernels", default=",".join(kernel_digests.KERNELS))
    ap.add_argument("--top", type=int, default=12, help="lines a kernel")
    ap.add_argument("--cases", default=",".join(RESAMPLE_CASES),
                    help="the resampler kernels' digest cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures a card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    label = card_label(device)
    result = {}
    for kernel in args.kernels.split(","):
        if kernel in kernel_digests.RESAMPLE_KERNELS:
            for name in args.cases.split(","):
                rows = sweep_resample(kernel, name, device)
                for us, lay, picked in rows[:args.top] + [r for r in rows[args.top:]
                                                          if r[2]]:
                    path = "rows" if lay.rows else ("fir" if kernel == "window"
                                                    else "tile")
                    knobs = (f"cg={lay.cg}" if kernel == "window" and lay.rows
                             else f"R={lay.R}" if kernel == "window"
                             else f"cg={lay.cg} qc={lay.qc}" if lay.rows else "")
                    print(f"{kernel:6s} {name:12s} {path:4s} tile={lay.tile:4d} "
                          f"threads={lay.threads:3d} {knobs} grid={lay.grid} "
                          f"device {us!r} us{' *' if picked else ''} [{label}]",
                          file=sys.stderr)
                result[f"{kernel}/{name}"] = [
                    dict(device_us=us, picked=picked, **dataclasses.asdict(lay))
                    for us, lay, picked in rows]
            continue
        if kernel == SHAPE:
            rows = sweep_shape(args.blocks, args.iters, args.dispatches, device)
            for ms, g, picked, us in rows[:args.top] + [r for r in rows[args.top:]
                                                        if r[2]]:
                dev = "" if us is None else f", device {us:8.3f} us"
                print(f"{kernel} B={args.blocks} warps={g.warps} split={g.split} "
                      f"depth={g.depth} {ms:9.5f} ms a launch{dev}"
                      f"{' *' if picked else ''} [{label}]", file=sys.stderr)
            print(f"{kernel} slowest of {len(rows)}: {rows[-1][0]:.4f} ms "
                  f"{rows[-1][1]} [{label}]", file=sys.stderr)
            result[kernel] = [dict(ms=ms, picked=picked, device_us=us,
                                   **dataclasses.asdict(g))
                              for ms, g, picked, us in rows]
            continue
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
