"""Interleaved A/B of the fused chain kernel and the two tone formulations at
the config-3 bench shape (one process, best of N rounds).

Counterpart of ``tools/probe_chain_precision.py``.  Variants:

  hi          the fused chain kernel: float32 FMA dots, the exact path
  split3      the kernel of ``--precision fast`` (``csrc/chain_fast.cu``):
              the same function as three exact bf16 products a tap on the
              tensor cores (the JAX tool's ``split3-*``)
  def         the same kernel with one bf16 pass, ``x_h·t_h``
              (``dot_precision='default'``; the JAX tool's ``def-*``)
  mix-select  the chain-shaped mix + encode probe with the select-chain
              quadrant fold (``ops.sincos.sincos_q24_neg_select``)
  mix-fold    the same with the product tone's XOR sign fold; the two write
              the same words

The JAX tool's ``phase_impl`` axis (``flat`` / ``outer``) has no
counterpart: the port's phase is one 64-bit multiply-add a sample and needs
no strength reduction.

Data, plan and timing as ``tools/roofline.py``.  One stderr line a round and
variant, then one JSON line ``{variant: {gsps, ms}}`` on stdout (``ms`` for
all K dispatches, as in the JAX tool):

    python -m doppler_tpu_torch.tools.probe_chain_precision --samples 33554432
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from doppler_tpu_torch.ops.cuda import chain, probes
from doppler_tpu_torch.ops.resample import RationalResampler
from doppler_tpu_torch.tools import common

VARIANTS = ("hi", "split3", "def", "mix-select", "mix-fold")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_common_args(ap)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, exact names")
    args = ap.parse_args(argv)
    variants = set(args.variants.split(","))
    device, label = common.open_device(args.device)
    words, plans, B = common.bench_inputs(args.samples, device)
    N = B * common.L
    K = max(1, args.dispatches)
    rs = RationalResampler(common.FS, common.OUT_RATE)
    P, Q, T = rs.P, rs.Q, rs.T
    if N % Q:
        raise SystemExit(f"--samples must give a multiple of Q={Q} samples")
    bank = torch.from_numpy(rs.bank).to(device)
    carry = torch.zeros(2, T - 1, device=device)
    makers = {
        "hi": lambda: chain.mix_resample_chain_stream(
            words, plans, bank, carry, P=P, Q=Q, T=T),
        "split3": lambda: chain.mix_resample_chain_stream(
            words, plans, bank, carry, P=P, Q=Q, T=T, dot_precision="split3"),
        "def": lambda: chain.mix_resample_chain_stream(
            words, plans, bank, carry, P=P, Q=Q, T=T, dot_precision="default"),
        "mix-select": lambda: probes.mix_shape_run(words, plans, P=P, Q=Q,
                                                   tone="select"),
        "mix-fold": lambda: probes.mix_shape_run(words, plans, P=P, Q=Q,
                                                 tone="fold"),
    }
    steps = {k: v for k, v in makers.items() if k in variants}

    def on_time(it, name, dt):
        print(f"iter {it} {name}: {dt * 1e3:8.2f} ms/{K} disp "
              f"({N * K / dt / 1e9:6.2f} GS/s) [{label}]", file=sys.stderr)

    best = common.best_of(steps, args.iters, K, device, on_time)
    print(json.dumps({k: {"gsps": N * K / v / 1e9, "ms": v * 1e3}
                      for k, v in best.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
