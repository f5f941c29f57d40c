"""Interleaved A/B of the fused cascade kernel at its three dot precisions,
at the config-3 bench shape (one process, best of N rounds).

Counterpart of ``tools/probe_cascade_precision.py``.  The 1.024 Msps →
48 ksps cascade (÷8 T = 65, then 3/8 T = 51) over the tools' bench inputs
(``tools/common.py``: ``(B, 2048)`` words).  Variants:

  exact  ``csrc/cascade.cu``: float32 FMA dots (``dot_precision='highest'``)
  fast   ``csrc/cascade_fast.cu``: three exact bf16 products a tap on the
         tensor cores (``'split3'``)
  def    the same kernel with one bf16 pass, ``x_h·t_h`` (``'default'``;
         the JAX tool has no such variant, ``probe_chain_precision``'s
         ``def`` has)

One stderr line a round and variant, then one JSON line
``{variant: {gsps, ms}}`` on stdout (``ms`` for all K dispatches, as in the
JAX tool):

    python -m doppler_tpu_torch.tools.probe_cascade_precision --samples 33554432
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from doppler_tpu_torch.ops.cuda import cascade
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.tools import common

VARIANTS = ("exact", "fast", "def")
DOTS = {"exact": "highest", "fast": "split3", "def": "default"}


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
    ms = MultiStageResampler(common.FS, common.OUT_RATE)
    stages = tuple((st.P, st.Q, st.T) for st in ms.stages)
    print("stages: " + " -> ".join(f"{P}/{Q}(T={T})" for P, Q, T in stages),
          file=sys.stderr)
    banks = tuple(torch.from_numpy(st.bank).to(device) for st in ms.stages)
    carries = tuple(torch.zeros(2, T - 1, device=device) for _, _, T in stages)

    def step(dot):
        return lambda: cascade.mix_cascade_stream(words, plans, banks, carries,
                                                  stages=stages, dot_precision=dot)

    steps = {k: step(DOTS[k]) for k in VARIANTS if k in variants}

    def on_time(it, name, dt):
        print(f"iter {it} {name}: {dt * 1e3:8.2f} ms/{K} disp "
              f"({N * K / dt / 1e9:6.2f} GS/s) [{label}]", file=sys.stderr)

    best = common.best_of(steps, args.iters, K, device, on_time)
    print(json.dumps({k: {"gsps": N * K / v / 1e9, "ms": v * 1e3}
                      for k, v in best.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
