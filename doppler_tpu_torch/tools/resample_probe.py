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
from doppler_tpu_torch.tools import common

VARIANTS = ("conv_block", "window", "window_dot")


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
    args = ap.parse_args(argv)
    device, label = common.open_device(args.device)
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
