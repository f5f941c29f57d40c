"""Single-card benchmark: fused decode → NCO mix → polyphase resample →
encode, in eleven modes.

Counterpart of ``bench.py``: the same arguments, the same inputs, the same
function a mode and the same one JSON line on stdout,

    {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N/fs}

with ``bench.py``'s metric names.  ``vs_baseline`` is the realtime margin at
the mode's own input rate (1.024 Msps; 100 Msps for ``split-*`` and
``channels-split``).  The workload is BASELINE config 3's: i16 IQ, a
Doppler shift a block of L = 8192 samples, 3/64 polyphase decimation to
48 ksps (the split modes: 100 Msps → ÷16 → ÷16 → 384/3125), i16 out.

Each mode's step launches the port's hand-written kernels on the card (on
the CPU, ``--device cpu``, their plain versions: a check of the control
flow, no measurement):

  mix, mix-pallas   ``csrc/mixer.cu`` i16 → i16 (``bench.py``'s XLA mix and
                    its Pallas mixer are one kernel here)
  chain-pallas      ``csrc/chain.cu`` (``--precision fast``: ``chain_fast.cu``)
  cascade-pallas    ``csrc/cascade.cu`` over all the config-3 stages
  split-pallas      ``cascade.cu``'s ÷16·÷16 front to float32 planes, then
                    ``csrc/conv.cu`` for the 384/3125 tail, then the encode
  split-xla         ``mixer.cu`` to float32 planes, ``conv.cu`` for each stage
  channels-split    the channel axis of ``cascade.cu``, ``conv.cu`` on C rows
  chain-mesh        ``parallel/sharded.py``'s chain step over a
                    ``(channel=1, time=n)`` mesh of the local cards
  channels-pallas   the channel axis of ``chain.cu`` (or ``chain_fast.cu``)
  channels          ``mixer.cu``'s channel axis to planes, ``conv.cu`` on C rows
  chain             ``mixer.cu`` to planes, then ``conv.cu``

``bench.py``'s unfused modes and its split tail use the banded-matmul
(``conv``) form, so the port's do too: each stage is one
``resample_conv_stream`` at the stream's start (``bench.py``'s ``chain``
and ``channels`` call ``resample_conv_block``, the same outputs).  The JAX
steps put T−1 zeros of history in front of each conv stage's input;
``conv.cu`` reads zeros outside its buffer, so the port passes the window's
start T−1 samples earlier instead and copies nothing (on the CPU the plain
version pads them).  The encode of the conv stages' float32 planes is torch
glue.

Timing: one warm-up call, then ``--iters`` rounds of
``runtime/timing.py::timed_dispatches`` (K = ``--dispatches`` launches
between two CUDA events, one synchronize), the best round taken; the rate
is ``total_samples · K / best``.  That is the stream's event time on the
card, not ``bench.py``'s wall time with a scalar readback, and it includes
the wrappers' Python wherever that is longer than the kernels (small
``--samples``).  One stderr line names the card and its power limit.

    python -m doppler_tpu_torch.tools.bench                    # chain-pallas
    python -m doppler_tpu_torch.tools.bench --mode channels-split --channels 256
    python -m doppler_tpu_torch.tools.bench --device cpu --samples 65536 \\
        --iters 1 --dispatches 1                      # plain versions
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import cascade, chain, conv, mixer
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.resample import (
    RationalResampler,
    conv_stream_geometry,
    make_taps_matrix,
)
from doppler_tpu_torch.parallel import sharded
from doppler_tpu_torch.parallel.mesh import make_mesh
from doppler_tpu_torch.runtime.pipeline import resolve_device
from doppler_tpu_torch.runtime.timing import card_label, timed_dispatches
from doppler_tpu_torch.tools import common

MODES = ("chain", "chain-pallas", "chain-mesh", "cascade-pallas",
         "split-pallas", "split-xla", "channels-split",
         "mix", "mix-pallas", "channels", "channels-pallas")
FS = common.FS
FS_SPLIT = 100_000_000      # BASELINE config 5's literal rate
L = 8192                    # samples a block (bench.py:110)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=["default", "cpu"], default="default",
                    help="bench.py's platform override: 'cpu' is --device cpu")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="cuda (the default) fails without a card; cpu runs "
                         "the kernels' plain versions, which measures no card")
    ap.add_argument("--mode", choices=MODES, default="chain-pallas",
                    help="default chain-pallas: the BASELINE primary metric "
                         "(NCO mix + polyphase resample, config-3 shape) on "
                         "the fused chain kernel")
    ap.add_argument("--channels", type=int, default=16,
                    help="channel count for the channels modes (config 4)")
    ap.add_argument("--mesh-time", type=int, default=0,
                    help="time-shard width for --mode chain-mesh "
                         "(0 = all visible devices)")
    ap.add_argument("--mesh-scan", action="store_true",
                    help="chain-mesh: measure every power-of-two width up "
                         "to --mesh-time and report per-card efficiency "
                         "vs time=1")
    ap.add_argument("--samples", type=int, default=1 << 25)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--precision", choices=["exact", "fast"], default="exact",
                    help="chain-pallas / channels-pallas: 'fast' = the "
                         "3-pass bf16-split tensor-core dot")
    ap.add_argument("--dispatches", type=int, default=64,
                    help="launches per timed iteration (one synchronize "
                         "each iteration)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the timed loop "
                         "into DIR")
    args = ap.parse_args(argv)
    if args.platform == "cpu":
        if args.device == "cuda":
            ap.error("--platform cpu contradicts --device cuda")
        args.device = "cpu"
    args.device = args.device or "cuda"
    return args


def _visible_devices(device) -> int:
    """What ``--mesh-time 0`` takes: the local cards, or one CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _bank(st, device):
    return torch.from_numpy(st.bank).to(device)


def _taps(st, device):
    return torch.from_numpy(make_taps_matrix(st.bank, st.P, st.Q)).to(device)


def _zero_carries(stages, device, C=None):
    lead = () if C is None else (C,)
    return tuple(torch.zeros(lead + (2, st.T - 1), device=device) for st in stages)


def _resample(xi, xq, taps, st):
    """``bench.py``'s conv stage at the stream's start: T−1 zeros of history,
    then the N = ``xi.shape[-1]`` inputs of planes ``(N,)`` or ``(C, N)``,
    N·P/Q outputs (``ops.resample.conv_stream_geometry``).  The zeros are
    not concatenated: the window starts T−1 samples earlier, where the
    kernel reads zeros (the plain version pads them), so nothing is copied."""
    N, H = xi.shape[-1], st.T - 1
    M = N * st.P // st.Q
    start0, p0, K, PADZ, TAIL = conv_stream_geometry(0, 0, M, N, P=st.P,
                                                     Q=st.Q, T=st.T)
    return conv.resample_conv_stream(xi, xq, taps, start0 - H, p0, P=st.P,
                                     Q=st.Q, T=st.T, K=K, M=M, PADZ=PADZ + H,
                                     TAIL=TAIL)


def build(mode: str, args, device: torch.device):
    """One mode's ``(step, total_samples, metric, fs)``: ``step()`` enqueues
    one dispatch over the bench inputs on ``device`` and returns its output
    (``chain-mesh``: each time shard's words, in stream order).  ``args``
    needs ``samples``, ``channels``, ``precision`` and ``mesh_time``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    split = mode.startswith("split") or mode == "channels-split"
    fs = FS_SPLIT if split else FS
    channels = mode.startswith("channels")
    C = args.channels
    per_stream = max(L, args.samples // C) if channels else args.samples
    words, plans, B = common.bench_inputs(per_stream, device, fs=fs, L=L)
    N = B * L
    total = N * (C if channels else 1)
    # the split modes never touch the single-stage design at 100 Msps
    rs = None if split else RationalResampler(fs, common.OUT_RATE)
    if rs is not None and N % rs.Q:
        raise SystemExit(f"{N} samples are not a multiple of Q={rs.Q}")
    fast = args.precision == "fast"
    dot = "split3" if fast else "highest"
    log = lambda line: print(line, file=sys.stderr)  # noqa: E731

    if mode in ("mix", "mix-pallas"):
        def step():
            return mixer.mix_blocks_fmt(words, plans)

        metric = ("nco_mix_i16_samples_per_s_chip" if mode == "mix"
                  else "nco_mix_pallas_i16_samples_per_s_chip")
    elif mode in ("chain-pallas", "channels-pallas"):
        bank = _bank(rs, device)
        if mode == "chain-pallas":
            (carry,) = _zero_carries([rs], device)

            def step():
                return chain.mix_resample_chain_stream(
                    words, plans, bank, carry, P=rs.P, Q=rs.Q, T=rs.T,
                    dot_precision=dot)[0]

            metric = ("mix_resample_chain_fast_i16_samples_per_s_chip" if fast
                      else "mix_resample_chain_pallas_i16_samples_per_s_chip")
        else:
            plans_c = common.channel_plans(
                lambda c, k: 9000.0 + 120.0 * c - 0.01 * k, C, B, fs, device, L)
            (carries,) = _zero_carries([rs], device, C)

            def step():
                return chain.mix_resample_chain_channels(
                    words, plans_c, bank, carries, P=rs.P, Q=rs.Q, T=rs.T,
                    dot_precision=dot)[0]

            metric = (f"channels{C}_pallas_chain_fast_i16_samples_per_s_chip"
                      if fast else f"channels{C}_pallas_chain_i16_samples_per_s_chip")
    elif mode == "cascade-pallas":
        ms = MultiStageResampler(fs, common.OUT_RATE)
        stages = tuple((st.P, st.Q, st.T) for st in ms.stages)
        banks = tuple(_bank(st, device) for st in ms.stages)
        carries = _zero_carries(ms.stages, device)
        log("cascade stages: " + " -> ".join(
            f"{st.P}/{st.Q}(T={st.T})" for st in ms.stages))

        def step():
            return cascade.mix_cascade_stream(words, plans, banks, carries,
                                              stages=stages)[0]

        metric = "mix_cascade_pallas_i16_samples_per_s_chip"
    elif mode in ("split-pallas", "split-xla", "channels-split"):
        # the fused ÷16·÷16 front, then the odd-Q rational tail
        ms = MultiStageResampler(fs, common.OUT_RATE)
        front, fin = ms.stages[:-1], ms.stages[-1]
        if fin.Q % 2 != 1:
            raise SystemExit("split bench wants an odd-Q final stage")
        stages = tuple((st.P, st.Q, st.T) for st in front)
        banks = tuple(_bank(st, device) for st in front)
        fin_taps = _taps(fin, device)
        kw = dict(stages=stages, outtype="f32", final_dense=True)

        def tail(yi, yq):
            return codec.iq_to_i16_words(*_resample(yi, yq, fin_taps, fin))

        if mode == "channels-split":
            plans_c = common.channel_plans(
                lambda c, k: 1e6 * (c - C / 2) - 0.01 * k, C, B, fs, device, L)
            carries = _zero_carries(front, device, C)
            log(f"channels-split: C={C} × "
                + " -> ".join(f"{st.P}/{st.Q}" for st in ms.stages))

            def step():
                planes = cascade.mix_cascade_channels(words, plans_c, banks,
                                                      carries, **kw)[0]
                flat = planes.reshape(2, C, -1)
                return tail(flat[0], flat[1])

            metric = f"channels{C}_split_cascade_i16_ch_samples_per_s_chip"
        else:
            log("split stages: " + " -> ".join(
                f"{st.P}/{st.Q}(T={st.T})" for st in ms.stages)
                + f"  (front {len(front)} fused, tail conv)")
            if mode == "split-pallas":
                carries = _zero_carries(front, device)

                def step():
                    planes = cascade.mix_cascade_stream(words, plans, banks,
                                                        carries, **kw)[0]
                    flat = planes.reshape(2, -1)
                    return tail(flat[0], flat[1])

                metric = "mix_split_cascade_pallas_i16_samples_per_s_chip"
            else:
                front_taps = [_taps(st, device) for st in front]

                def step():
                    planes = mixer.mix_blocks_fmt(words, plans, outtype="f32")
                    yi, yq = planes[0].reshape(-1), planes[1].reshape(-1)
                    for st, taps in zip(front, front_taps):
                        yi, yq = _resample(yi, yq, taps, st)
                    return tail(yi, yq)

                metric = "mix_split_cascade_xla_i16_samples_per_s_chip"
    elif mode == "chain-mesh":
        n_time = args.mesh_time or _visible_devices(device)
        if B % n_time:
            raise SystemExit(f"blocks {B} not divisible by time={n_time}")
        mesh = make_mesh(time=n_time, channel=1, device=device.type)
        mesh_step = sharded.make_chain_stream_step(mesh, resampler=rs)
        (carry,) = _zero_carries([rs], device)

        def step():
            return mesh_step(words, plans, carry)[0]

        metric = "chain_mesh_i16_samples_per_s_aggregate"
    else:                                   # chain, channels: mix, then conv
        taps = _taps(rs, device)
        if mode == "chain":
            def step():
                planes = mixer.mix_blocks_fmt(words, plans, outtype="f32")
                return codec.iq_to_i16_words(*_resample(
                    planes[0].reshape(-1), planes[1].reshape(-1), taps, rs))

            metric = "mix_resample_chain_i16_samples_per_s_chip"
        else:
            plans_c = common.channel_plans(
                lambda c, k: 9000.0 + 120.0 * c - 0.01 * k, C, B, fs, device, L)

            def step():
                planes = mixer.mix_blocks_fmt_channels(words, plans_c,
                                                       outtype="f32")
                return codec.iq_to_i16_words(*_resample(
                    planes[0].reshape(C, N), planes[1].reshape(C, N), taps, rs))

            metric = f"channels{C}_mix_resample_i16_samples_per_s_chip"
    return step, total, metric, fs


def _best(step, K: int, iters: int, device) -> tuple[float, list[float]]:
    """Warm up once, then ``iters`` rounds of K dispatches: (best, all)."""
    step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = [timed_dispatches(step, K, device) for _ in range(iters)]
    return min(times), times


@contextlib.contextmanager
def _profiled(directory, device, name):
    """A ``torch.profiler`` trace of the block into ``directory`` (the
    counterpart of ``jax.profiler.trace``), or nothing without one."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    print(f"profile: {path}", file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    label = card_label(device)
    print(f"bench device: {label}", file=sys.stderr)
    K = max(1, args.dispatches)
    mode = args.mode

    extra = {}
    if mode == "chain-mesh":
        n_time = args.mesh_time or _visible_devices(device)
        widths = [n_time]
        if args.mesh_scan:
            # only widths that divide the block count are measurable
            B = max(1, args.samples // L)
            widths = [w for w in (1, 2, 4, 8, 16, 32, 64)
                      if w <= n_time and B % w == 0]
            if widths[-1] != n_time:
                widths.append(n_time)
        rates = {}
        with _profiled(args.profile, device, mode):
            for w in widths:
                step, N, metric, fs = build(
                    mode, argparse.Namespace(**{**vars(args), "mesh_time": w}),
                    device)
                best, _ = _best(step, K, args.iters, device)
                rates[w] = N * K / best
                print(f"bench chain-mesh time={w}: {K} x {N} samples in "
                      f"{best * 1e3:.2f} ms best ({rates[w] / 1e9:.3f} GS/s "
                      f"aggregate, {rates[w] / w / 1e9:.3f} GS/s/card) "
                      f"[{label}]", file=sys.stderr)
        base = rates[widths[0]] / widths[0]
        for w in widths[1:]:
            print(f"  scaling efficiency time={w} vs time={widths[0]}: "
                  f"{100 * (rates[w] / w) / base:.1f}%", file=sys.stderr)
        rate = rates[n_time]
        extra["mesh_time"] = n_time
        if len(rates) > 1:
            extra["efficiency_vs_time1"] = (rate / n_time) / base
    else:
        step, total, metric, fs = build(mode, args, device)
        with _profiled(args.profile, device, mode):
            best, times = _best(step, K, args.iters, device)
        rate = total * K / best
        print(f"bench {metric}: {K} x {total} samples in {best * 1e3:.2f} ms "
              f"best/iter ({best * 1e3 / K:.2f} ms/dispatch; median "
              f"{np.median(times) * 1e3:.2f} ms) over {args.iters} iters (one "
              f"host-sync round trip per iter) [{label}]", file=sys.stderr)
    print(json.dumps({"metric": metric, "value": rate, "unit": "samples/s",
                      "vs_baseline": rate / fs, **extra}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
