"""The resampler's two forms timed against each other: the banded-matmul
``conv`` block (``csrc/conv.cu`` on the card) and the window form (its
kernel ``csrc/window.cu``, and its plain version, the gather + fixed-tree
``window_dot`` in torch), at config 3's single stage (1.024 Msps → 48 ksps:
P = 3, Q = 64, T = 370) over N = 2^24 input samples a call.

Counterpart of ``tools/resample_probe.py`` (which times the conv block
against ``window_dot``).  Every variant computes the N·P/Q outputs of one
block at window alignment 0 from the same seeded float32 planes
(``ops.resample.resample_conv_block``, ``window_resample``,
``window_dot``).  Each variant is
timed by ``runtime/timing.py::timed_dispatches`` (K calls between two CUDA
events), interleaved, best of N rounds.  One stderr line a round and
variant, with the card's name and power limit; then one JSON line
``{"<variant>_ms", "<variant>_gsps", ...}`` on stdout (``*_ms`` a call):

    python -m doppler_tpu_torch.tools.resample_probe

``--cases`` times the two kernels instead at every digest case of
``tools/kernel_digests.py`` (:func:`case_times`): the device µs a launch
from ``torch.profiler``, the wrapper's time a call by ``timed_dispatches``
(16 calls, best of ``--iters``, the cases in turns), the bound, and the
library's strided ``conv1d`` (the same product) at config 3's chunk and
at 2^24 inputs.  One JSON line a (kernel, case) on stdout:

    python -m doppler_tpu_torch.tools.resample_probe --cases
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from doppler_tpu_torch.ops.multistage import make_resampler
from doppler_tpu_torch.ops.resample import (
    make_taps_matrix,
    resample_conv_block,
    window_dot,
    window_resample,
)
from doppler_tpu_torch.ops.cuda.conv import conv_bands
from doppler_tpu_torch.tools import common, kernel_digests

VARIANTS = ("conv_block", "window", "window_dot")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_FLOP_PER_S = 67e12              # float32 FMA outside the tensor cores
LIBRARY_CASES = ("c3-chunk/C1", "c3-2p24/C1")


def case_bound(kernel: str, name: str) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time of a case on the
    card — each input sample read and each output written once (8 B a
    channel-sample, both planes), or its FMAs (T an output-plane for the
    window form, R·Q for the conv form) at the float32 rate, the larger."""
    case = kernel_digests.RESAMPLE_CASES[name]
    P, Q, T, _ = kernel_digests.resample_stage(case)
    M = kernel_digests.resample_args(case, P, Q, T)["M"]
    fma = T if kernel == "window" else conv_bands(Q, T)[1] * Q
    t_b = 8 * case.C * (T - 1 + case.N + M) / HBM_BYTES_PER_S
    t_f = 2 * 2 * fma * case.C * M / F32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def library_step(name: str, device):
    """One ``conv1d`` call computing case ``name``'s conv-form product (its
    input laid out once, outside the call)."""
    case = kernel_digests.RESAMPLE_CASES[name]
    P, Q, T, bank = kernel_digests.resample_stage(case)
    a = kernel_digests.resample_args(case, P, Q, T)
    xi, xq = kernel_digests.resample_inputs(name, device)
    w_len, R = conv_bands(Q, T)
    x2 = torch.nn.functional.pad(torch.stack([xi, xq]).reshape(-1, xi.shape[-1]),
                                 (a["PADZ"], a["TAIL"]))
    lo = a["start0"] + a["PADZ"]
    xs = x2[:, lo:lo + (a["K"] + R) * Q].unsqueeze(1).contiguous()
    taps = torch.from_numpy(make_taps_matrix(bank, P, Q)).to(device)
    weight = torch.nn.functional.pad(taps, (0, 0, 0, R * Q - w_len)).t()
    weight = weight.unsqueeze(1).contiguous()              # (P, 1, R·Q)
    return lambda: torch.nn.functional.conv1d(xs, weight, stride=Q)


def case_times(device, iters: int = 5, cases=None, on_line=None) -> list:
    """One dict a (kernel, case): ``device_us`` (a launch, the profiler's),
    ``ms`` (a call of the wrapper, ``timed_dispatches``), ``bound_ms``,
    ``bound_by``, the card's label; ``kernel`` ``conv1d`` for the library.
    Every step is timed in turns with the others."""
    label = common.card_label(device)
    steps = {}
    for name in cases or kernel_digests.RESAMPLE_CASES:
        for kernel in kernel_digests.RESAMPLE_KERNELS:
            steps[kernel, name] = kernel_digests.resample_step(kernel, name,
                                                               device)
        if name in LIBRARY_CASES:
            steps["conv1d", name] = library_step(name, device)
    K = 16
    best = common.best_of(steps, iters, K, device)
    rows = []
    for (kernel, name), step in steps.items():
        match = None if kernel == "conv1d" else kernel + "_"
        bound_ms, by = case_bound("conv" if kernel == "conv1d" else kernel, name)
        row = dict(kernel=kernel, case=name,
                   device_us=common.device_us(step, match), ms=best[kernel, name]
                   / K * 1e3, bound_ms=bound_ms, bound_by=by, card=label)
        rows.append(row)
        if on_line is not None:
            on_line(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=1 << 24)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) fails without a card; cpu runs the "
                         "plain versions, which measures no card")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, exact names")
    ap.add_argument("--cases", action="store_true",
                    help="time the two kernels at the digest cases instead")
    args = ap.parse_args(argv)
    device, label = common.open_device(args.device)
    if args.cases:
        if device.type != "cuda":
            ap.error("--cases measures the kernels: it needs --device cuda")
        case_times(device, args.iters, on_line=lambda row: print(json.dumps(row),
                                                                 flush=True))
        return 0
    rs = make_resampler(common.FS, float(common.OUT_RATE), stages="single")
    P, Q, T = rs.P, rs.Q, rs.T
    N = max(Q, args.samples // Q * Q)
    M = N * P // Q
    rng = np.random.default_rng(0)
    xi, xq = (torch.from_numpy(rng.standard_normal(T - 1 + N).astype(np.float32))
              .to(device) for _ in range(2))
    bank_rev = torch.from_numpy(rs.bank[:, ::-1].copy()).to(device)
    taps_mat = torch.from_numpy(make_taps_matrix(rs.bank, P, Q)).to(device)
    print(f"resample_probe: P/Q = {P}/{Q}, T = {T}, N = {N} inputs, "
          f"{M} outputs a call", file=sys.stderr)
    steps = {
        "conv_block": lambda: resample_conv_block(xi, xq, taps_mat, P=P, Q=Q, T=T),
        "window": lambda: window_resample(xi, xq, bank_rev, 0, 0, P=P, Q=Q, T=T,
                                          M=M),
        "window_dot": lambda: window_dot(xi, xq, bank_rev, 0, 0, P=P, Q=Q, T=T,
                                         M=M),
    }
    names = args.variants.split(",")
    unknown = [n for n in names if n not in steps]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    steps = {name: steps[name] for name in names}
    K = max(1, args.dispatches)

    def on_time(it, name, dt):
        print(f"iter {it} {name}: {dt / K * 1e3:.4f} ms a call "
              f"({N * K / dt / 1e9:.3f} GS/s) [{label}]", file=sys.stderr)

    best = common.best_of(steps, args.iters, K, device, on_time)
    res = {}
    for name, dt in best.items():
        res[f"{name}_ms"] = dt / K * 1e3
        res[f"{name}_gsps"] = N * K / dt / 1e9
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
