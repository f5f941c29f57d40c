"""What the card reaches on the mixer's and the chain's traffic, beside the
product kernels: is the mixer bound by HBM bytes, by its i16↔f32 casts or by
its stores, and how does the chain's time split into its launch shape, its
mixing and its FIR?

Counterpart of ``tools/roofline.py``.  Variants, mixer-shaped (8 B/sample,
int32 words in, int32 words out):

  torch-xor   ``torch.bitwise_xor(x, 1)`` — the library's elementwise floor
  torch-copy  ``out.copy_(x)`` — the library's copy
  copy        hand-written copy kernel, 4-byte accesses
  copy-v4     the same with 16-byte accesses
  codec       + decode and encode (the i16↔f32 casts and scalings)
  mixer       the product mixer kernel
  mixer-q15   the integer-domain mixer (no casts; not byte-exact)

Chain-shaped (the chain's 4 + 4·P/Q ≈ 4.19 B/sample at P/Q = 3/64):

  chain-copy  read every word, write the first P/Q of each tile, no work
  chain-mix   + decode, phase, tone, rotate, encode on every sample
              (chain-mix − chain-copy = the mixing)
  chain       the fused chain kernel (chain − chain-mix = the FIR)
  cascade     the fused cascade kernel at the config-3 stages, the CLI's
              default route

The JAX tool's ``copy-w*``, ``copyflat-w*``, ``mixer-w*`` and ``chain-pp4``
sweep TPU DMA tile sizes and matrix-unit lane packing; their counterpart on
this card is the access width (``copy`` against ``copy-v4``).

Data and plan are the JAX tool's (seed ``0xBE``, shifts ``9000 − 0.01·k``)
at the port's block length L = 2048.  Each variant runs K dispatches between
two CUDA events and one synchronize (``runtime/timing.py``), best of
``--iters``, the variants interleaved.  One stderr line a variant, then one
JSON line ``{variant: {gsps, gbps, ms_per_dispatch}}`` on stdout:

    python -m doppler_tpu_torch.tools.roofline --samples 33554432
    python -m doppler_tpu_torch.tools.roofline --device cpu --samples 16384 \\
        --dispatches 1 --iters 1      # plain versions: control flow only
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from doppler_tpu_torch.ops.cuda import cascade, chain, mixer, probes
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.resample import RationalResampler
from doppler_tpu_torch.tools import common

MIXER_SHAPED = ("torch-xor", "torch-copy", "copy", "copy-v4", "codec", "mixer",
                "mixer-q15")
CHAIN_SHAPED = ("chain-copy", "chain-mix", "chain", "cascade")


def build_steps(variants: set, words, plans, device) -> dict:
    """``{name: (step, bytes per input sample)}`` for the asked variants, in
    the order of the module docstring.  Names match exactly."""
    rs = RationalResampler(common.FS, common.OUT_RATE)
    P, Q, T = rs.P, rs.Q, rs.T
    bank = torch.from_numpy(rs.bank).to(device)
    carry = torch.zeros(2, T - 1, device=device)
    ms = MultiStageResampler(common.FS, common.OUT_RATE)
    fused = ms.stages[:cascade.split_point(ms.stages)]
    stages = tuple((st.P, st.Q, st.T) for st in fused)
    banks = tuple(torch.from_numpy(st.bank).to(device) for st in fused)
    zero = tuple(torch.zeros(2, Ts - 1, device=device) for _, _, Ts in stages)
    out = torch.empty_like(words)
    bps_chain = 4.0 + 4.0 * P / Q
    steps = {
        "torch-xor": (lambda: torch.bitwise_xor(words, 1), 8.0),
        "torch-copy": (lambda: out.copy_(words), 8.0),
        "copy": (lambda: probes.probe_elementwise(words), 8.0),
        "copy-v4": (lambda: probes.probe_elementwise(words, vec=4), 8.0),
        "codec": (lambda: probes.probe_elementwise(words, body="codec"), 8.0),
        "mixer": (lambda: mixer.mix_blocks_fmt(words, plans), 8.0),
        "mixer-q15": (lambda: mixer.mix_blocks_q15(words, plans), 8.0),
        "chain-copy": (lambda: probes.chain_shape_run(
            words, plans, P=P, Q=Q, do_mix=False), bps_chain),
        "chain-mix": (lambda: probes.chain_shape_run(
            words, plans, P=P, Q=Q, do_mix=True), bps_chain),
        "chain": (lambda: chain.mix_resample_chain_stream(
            words, plans, bank, carry, P=P, Q=Q, T=T), bps_chain),
        "cascade": (lambda: cascade.mix_cascade_stream(
            words, plans, banks, zero, stages=stages), bps_chain),
    }
    return {name: step for name, step in steps.items() if name in variants}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_common_args(ap)
    ap.add_argument("--variants", default=",".join(MIXER_SHAPED),
                    help="comma-separated, exact names; also: "
                         + ", ".join(CHAIN_SHAPED))
    args = ap.parse_args(argv)
    variants = set(args.variants.split(","))     # exact-name matching
    device, label = common.open_device(args.device)
    words, plans, B = common.bench_inputs(args.samples, device)
    N = B * common.L
    K = max(1, args.dispatches)
    steps = build_steps(variants, words, plans, device)
    best = common.best_of({k: v[0] for k, v in steps.items()}, args.iters, K,
                          device)
    results = {}
    for name, (_, bytes_per_sample) in steps.items():
        rate = N * K / best[name]
        bw = rate * bytes_per_sample
        results[name] = {"gsps": rate / 1e9, "gbps": bw / 1e9,
                         "ms_per_dispatch": best[name] / K * 1e3}
        print(f"{name:10s} {best[name] * 1e3:8.2f} ms/{K} disp  "
              f"{best[name] / K * 1e3:6.3f} ms/disp  {rate / 1e9:7.2f} GS/s  "
              f"{bw / 1e9:7.1f} GB/s  ({N} samples) [{label}]", file=sys.stderr)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
