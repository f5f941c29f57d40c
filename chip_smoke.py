#!/usr/bin/env python3
"""Smoke test of doppler_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (each prints one line or a few; any failure exits non-zero):

1. device  — ``nvidia-smi`` name and power limit, torch's CUDA version.
2. build   — compiles ``doppler_tpu_torch/csrc`` with nvcc (sm_90a).
3. mixer   — the mixer kernel against its plain torch version on the card,
             all four wire formats, at the pipeline's chunk (B = 256).
4. chain   — the fused chain kernel against its plain version at config-3
             geometry (P/Q = 3/64, T = 370, B = 256) from a nonzero carry;
             its carry against the mixer's output; its bytes across chunk
             splits.
4b. cascade — the fused cascade kernel against its plain version at the
             config-3 stages (÷8 T = 65, 3/8 T = 51; B = 256) from nonzero
             carries in all four formats; stage-0 carry bitwise, later
             carries within 2^-20; its bytes across chunk splits; the split
             front (float32 planes) at the 100 Msps → 48 ksps stages.
5. slices  — synthetic captures through the CLI entry point
             ``doppler_tpu_torch.cli.main`` on the card, each with the launch
             counts set to 0 just before it and read just after:
             (i) the default config-3 route: 60 s at 1.024 Msps i16, track
             mode with a TLE, ``--resample-to 48000`` and no
             ``--resample-stages`` (the cascade); (ii) the split route:
             0.5 s at 100 Msps i16, const, → 48 ksps; (iii) the single-stage
             chain: the first 20 s of (i) with ``--resample-stages single``.
             Exact output lengths, launch counts, and SNR against the golden
             model.
6. timing  — each kernel and its plain version at B = 256 and B = 16384
             (median of 20 runs, CUDA events; the split front at B = 256),
             and each slice's host/device split.

The kernels' JSON record takes the mixer's and the cascade's launch counts
from slice (i) and the chain's from slice (iii).  The line before the last
is that record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

FS = 1024000
FS_SPLIT = 100_000_000             # BASELINE config 5's input rate
OUT_RATE = 48000
B_MAIN = 256                       # the pipeline's default chunk_blocks
B_BIG = 16384                      # 33.5 M samples a dispatch
N_SLICE = 61_440_000 + 1000        # 60 s at 1.024 Msps, plus a partial block
N_CHAIN = 20_480_000 + 1000        # its first 20 s
N_SPLIT = 50_000_000 + 1000        # 0.5 s at 100 Msps
GOLDEN_BLOCKS = 512
TOL_F32 = 2.0 ** -20
TLE_LINES = (
    "1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8",
    "2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105",
)
START_UNIX = float(int((2444514.48708465 - 2440587.5) * 86400.0 + 3600.0))
LOCATION = "lat=58.26541,lon=26.46667,alt=76"
FREQ = 437505000.0
OFFSET = 5000.0


class Failed(Exception):
    pass


def _tle_lines():
    """The conformance harness's test TLE with its checksums appended."""
    from doppler_tpu_torch.orbit.tle import _checksum

    lines = [ln.ljust(68)[:68] for ln in TLE_LINES]
    return [ln + str(_checksum(ln)) for ln in lines]


def check(cond, what):
    if not cond:
        raise Failed(what)


# --------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {card}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    return card


def phase_build():
    from doppler_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    info = build.build_info()
    build.load()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.3f} s ({'compiled' if info['built'] else 'cached'}) "
          f"-> {os.path.relpath(info['path'])}")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"build: ptxas {line.split('ptxas info    :')[-1].strip()}")
    return secs


def _plan(B, L, samplenum=40000, fs=FS):
    from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

    # rounding-reset-heavy ratio: many blocks switch segment mid-block
    return plan_blocks([327843.76] * (B // 2) + [-15000.0] * (B - B // 2),
                       [L] * B, fs, NCOState(samplenum=samplenum), L)


def _data(torch, intype, B, L, gen):
    if intype == "i16":
        return torch.randint(-(1 << 31), 1 << 31, (B, L), dtype=torch.int64,
                             device="cuda", generator=gen).to(torch.int32)
    return torch.randn((2, B, L), device="cuda", generator=gen) * 0.3


def _lsb_diff(torch, a, b):
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


FORMATS = (("i16", "i16"), ("i16", "f32"), ("f32", "i16"), ("f32", "f32"))


def phase_mixer(torch, gen):
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt, mix_blocks_fmt_plain

    worst = 0.0
    for intype, outtype in FORMATS:
        L = 2048 if intype == "i16" else 1024
        plan = _plan(B_MAIN, L)
        check((plan.t < L).any(), "plan words have no segment switch")
        x = _data(torch, intype, B_MAIN, L, gen)
        p = nco.plan_tensor(plan, device="cuda")
        got = mix_blocks_fmt(x, p, intype=intype, outtype=outtype)
        torch.cuda.synchronize()
        want = mix_blocks_fmt_plain(x, p, intype=intype, outtype=outtype)
        if outtype == "f32":
            err = float((got - want).abs().max())
            ok = torch.equal(got, want)
            print(f"mixer: {intype}->{outtype} B={B_MAIN} L={L}: max|d|={err!r} "
                  f"bitwise={ok}")
            check(ok, f"mixer {intype}->{outtype} not bitwise equal to plain")
        else:
            d = _lsb_diff(torch, got, want)
            err, frac = float(d.max()), float((d > 0).float().mean())
            print(f"mixer: {intype}->{outtype} B={B_MAIN} L={L}: max LSB={err:g} "
                  f"frac={frac!r} bitwise={torch.equal(got, want)}")
            check(err <= 1 and frac < 0.01, f"mixer {intype}->{outtype} off by >1 LSB")
        worst = max(worst, err)
    return worst


def phase_chain(torch, gen):
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda.chain import (
        mix_resample_chain_plain,
        mix_resample_chain_stream,
    )
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt
    from doppler_tpu_torch.ops.resample import RationalResampler

    rs = RationalResampler(FS, OUT_RATE)
    P, Q, T = rs.P, rs.Q, rs.T
    check((P, Q, T) == (3, 64, 370), f"config-3 geometry changed: {(P, Q, T)}")
    bank = torch.from_numpy(rs.bank).cuda()
    L = 2048
    worst = 0.0
    for intype, outtype in FORMATS:
        x0 = _data(torch, intype, B_MAIN, L, gen)
        x1 = _data(torch, intype, B_MAIN, L, gen)
        p0 = nco.plan_tensor(_plan(B_MAIN, L), device="cuda")
        p1 = nco.plan_tensor(_plan(B_MAIN, L, samplenum=7), device="cuda")
        # nonzero carry: the last T−1 mixed samples of a previous chunk
        prev = mix_blocks_fmt(x0, p0, intype=intype, outtype="f32").reshape(2, -1)
        carry = prev[:, -(T - 1):].contiguous()
        got, c_got = mix_resample_chain_stream(x1, p1, bank, carry, P=P, Q=Q,
                                               T=T, intype=intype, outtype=outtype)
        torch.cuda.synchronize()
        want, c_want = mix_resample_chain_plain(x1, p1, bank, carry, P=P, Q=Q,
                                                T=T, intype=intype, outtype=outtype)
        mixed = mix_blocks_fmt(x1, p1, intype=intype, outtype="f32").reshape(2, -1)
        check(torch.equal(c_got, mixed[:, -(T - 1):].contiguous()),
              f"chain {intype}->{outtype} carry differs from the mixer's output")
        check(torch.equal(c_got, c_want), "chain carry differs from plain carry")
        if outtype == "i16":
            d = _lsb_diff(torch, got, want)
            err, frac = float(d.max()), float((d > 0).float().mean())
            print(f"chain: {intype}->{outtype} B={B_MAIN} L={L}: max LSB={err:g} "
                  f"frac={frac!r}; carry bitwise")
            check(err <= 1 and frac < 0.01, f"chain {intype}->{outtype} off by >1 LSB")
        else:
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"chain: {intype}->{outtype} B={B_MAIN} L={L}: max|d|={err!r} "
                  f"(|y|max {scale!r}); carry bitwise")
            check(err <= 2.0 ** -20, f"chain {intype}->{outtype} f32 off by {err}")
        worst = max(worst, err)
        if (intype, outtype) == ("i16", "i16"):
            # bytes invariant to the chunk split: 256 blocks vs 4 × 64
            c = carry
            parts = []
            for k in range(0, B_MAIN, 64):
                o, c = mix_resample_chain_stream(
                    x1[k:k + 64].contiguous(), p1[:, k:k + 64].contiguous(),
                    bank, c, P=P, Q=Q, T=T)
                parts.append(o)
            torch.cuda.synchronize()
            split_ok = torch.equal(torch.cat(parts), got) and torch.equal(c, c_got)
            print(f"chain: 256 blocks vs 4x64 blocks bitwise={split_ok}")
            check(split_ok, "chain bytes depend on the chunk split")
    return worst


def _cascade(torch, fs):
    """A rate's cascade, its fused stages (split_point) and their banks."""
    from doppler_tpu_torch.ops.cuda.cascade import split_point
    from doppler_tpu_torch.ops.multistage import MultiStageResampler

    ms = MultiStageResampler(fs, OUT_RATE)
    fused = ms.stages[:split_point(ms.stages)]
    return (ms, tuple((st.P, st.Q, st.T) for st in fused),
            tuple(torch.from_numpy(st.bank).cuda() for st in fused))


def _carry_errs(torch, got, want):
    """Stage 0 bitwise (mixed samples); max |d| over the later stages."""
    later = [float((g - w).abs().max()) for g, w in zip(got[1:], want[1:])]
    return torch.equal(got[0], want[0]), max(later, default=0.0)


def phase_cascade(torch, gen):
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda import cascade
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt

    _, stages, banks = _cascade(torch, FS)
    check(stages == ((1, 8, 65), (3, 8, 51)), f"config-3 stages changed: {stages}")
    L = 2048
    zero = tuple(torch.zeros(2, T - 1, device="cuda") for _, _, T in stages)
    worst = 0.0
    for intype, outtype in FORMATS:
        x0 = _data(torch, intype, B_MAIN, L, gen)
        x1 = _data(torch, intype, B_MAIN, L, gen)
        p0 = nco.plan_tensor(_plan(B_MAIN, L), device="cuda")
        p1 = nco.plan_tensor(_plan(B_MAIN, L, samplenum=7), device="cuda")
        # nonzero carries: what a previous chunk left in every stage
        _, carry = cascade.mix_cascade_stream(x0, p0, banks, zero, stages=stages,
                                              intype=intype, outtype="f32")
        got, c_got = cascade.mix_cascade_stream(x1, p1, banks, carry, stages=stages,
                                                intype=intype, outtype=outtype)
        torch.cuda.synchronize()
        want, c_want = cascade.mix_cascade_plain(x1, p1, banks, carry, stages=stages,
                                                 intype=intype, outtype=outtype)
        mixed = mix_blocks_fmt(x1, p1, intype=intype, outtype="f32").reshape(2, -1)
        check(torch.equal(c_got[0], mixed[:, -(stages[0][2] - 1):].contiguous()),
              f"cascade {intype}->{outtype} stage-0 carry differs from the mixer")
        c0_ok, c_err = _carry_errs(torch, c_got, c_want)
        check(c0_ok, "cascade stage-0 carry differs from the plain carry")
        check(c_err <= TOL_F32, f"cascade later carries off by {c_err}")
        if outtype == "i16":
            d = _lsb_diff(torch, got, want)
            err, frac = float(d.max()), float((d > 0).float().mean())
            print(f"cascade: {intype}->{outtype} B={B_MAIN} L={L}: max LSB={err:g} "
                  f"frac={frac!r}; stage-0 carry bitwise, stage-1 carry "
                  f"max|d|={c_err!r}")
            check(err <= 1 and frac < 0.01, f"cascade {intype}->{outtype} off by >1 LSB")
        else:
            err = float((got - want).abs().max())
            print(f"cascade: {intype}->{outtype} B={B_MAIN} L={L}: max|d|={err!r} "
                  f"(|y|max {float(want.abs().max())!r}); stage-0 carry "
                  f"bitwise, stage-1 carry max|d|={c_err!r}")
            check(err <= TOL_F32, f"cascade {intype}->{outtype} f32 off by {err}")
        worst = max(worst, err)
        if (intype, outtype) == ("i16", "i16"):
            # bytes invariant to the chunk split: 256 blocks vs 4 × 64
            c, parts = carry, []
            for k in range(0, B_MAIN, 64):
                o, c = cascade.mix_cascade_stream(
                    x1[k:k + 64].contiguous(), p1[:, k:k + 64].contiguous(),
                    banks, c, stages=stages)
                parts.append(o)
            torch.cuda.synchronize()
            split_ok = (torch.equal(torch.cat(parts), got)
                        and all(torch.equal(a, b) for a, b in zip(c, c_got)))
            print(f"cascade: 256 blocks vs 4x64 blocks bitwise={split_ok}")
            check(split_ok, "cascade bytes depend on the chunk split")

    # the split front at the 100 Msps stages: float32 planes out
    ms, stages5, banks5 = _cascade(torch, FS_SPLIT)
    check(len(stages5) == 2 < len(ms.stages), f"100 Msps front changed: {stages5}")
    zero5 = tuple(torch.zeros(2, T - 1, device="cuda") for _, _, T in stages5)
    x0, x1 = (_data(torch, "i16", B_MAIN, L, gen) for _ in range(2))
    p0 = nco.plan_tensor(_plan(B_MAIN, L, fs=FS_SPLIT), device="cuda")
    p1 = nco.plan_tensor(_plan(B_MAIN, L, samplenum=7, fs=FS_SPLIT), device="cuda")
    kw = dict(stages=stages5, outtype="f32", final_dense=True)
    _, carry = cascade.mix_cascade_stream(x0, p0, banks5, zero5, **kw)
    got, c_got = cascade.mix_cascade_stream(x1, p1, banks5, carry, **kw)
    torch.cuda.synchronize()
    want, c_want = cascade.mix_cascade_plain(x1, p1, banks5, carry, **kw)
    err = float((got - want).abs().max())
    c0_ok, c_err = _carry_errs(torch, c_got, c_want)
    tile = cascade._pick_tile(torch.cuda.current_device(), stages5, B_MAIN * L)
    print(f"cascade: split front {stages5} B={B_MAIN}: out {tuple(got.shape)} "
          f"max|d|={err!r}; tile {tile} outputs; stage-0 carry bitwise={c0_ok}, "
          f"stage-1 carry max|d|={c_err!r}")
    check(err <= TOL_F32 and c0_ok and c_err <= TOL_F32,
          "split front differs from its plain version")
    return max(worst, err)


def _capture(torch, n, seed, fs=FS):
    """Tones in band plus noise, made on the card, as LE i16 IQ bytes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.arange(n, dtype=torch.float64, device="cuda")
    ph1 = 2 * torch.pi * 3000.0 / fs * k
    ph2 = -2 * torch.pi * 7000.0 / fs * k + 1.0
    re_ = 0.3 * torch.cos(ph1) + 0.2 * torch.cos(ph2)
    im_ = 0.3 * torch.sin(ph1) + 0.2 * torch.sin(ph2)
    re_ += 0.01 * torch.randn(n, dtype=torch.float64, device="cuda", generator=gen)
    im_ += 0.01 * torch.randn(n, dtype=torch.float64, device="cuda", generator=gen)
    iq = torch.stack([torch.trunc(re_ * 32767), torch.trunc(im_ * 32767)], dim=1)
    return iq.to(torch.int16).cpu().numpy().tobytes()


class _Sink(io.RawIOBase):
    def __init__(self):
        self.parts = []

    def writable(self):
        return True

    def write(self, b):
        self.parts.append(bytes(b))
        return len(b)


def _golden_mixed(raw, n_blocks, fs, shifts):
    """The reference's sequential f32 mix of the first ``n_blocks`` blocks."""
    import numpy as np

    from doppler_tpu_torch import oracle

    x = oracle.decode_i16_bytes(raw[:n_blocks * 2048 * 4])
    mixed = np.empty_like(x)
    sn = 0
    for b, s in enumerate(shifts):
        seg = slice(b * 2048, (b + 1) * 2048)
        mixed[seg], sn = oracle.shift_frequency_oracle(x[seg], sn, s, fs)
    return mixed


def _track_shifts(n_blocks):
    from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler

    tle = Tle.from_lines("TEST SAT", *_tle_lines())
    sched = TrackScheduler(Predictor(tle, Observer(58.26541, 26.46667, 76.0)),
                           FREQ, OFFSET, FS, START_UNIX, telemetry=False)
    return sched.shifts([2048] * n_blocks)


def _golden(mixed, stages):
    """The oracle's float64 polyphase dot over each stage's bank in turn,
    then the i16 round trip."""
    import numpy as np

    from doppler_tpu_torch import oracle

    y = mixed
    for st in stages:
        y = oracle.resample_oracle(y, st.P, st.Q, st.bank)
    return oracle.decode_i16_bytes(oracle.encode_i16_bytes(y.astype(np.complex64)))


def _counters():
    from doppler_tpu_torch.ops.cuda.cascade import mix_cascade_stream
    from doppler_tpu_torch.ops.cuda.chain import mix_resample_chain_stream
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt

    return {"mixer": mix_blocks_fmt, "chain": mix_resample_chain_stream,
            "cascade": mix_cascade_stream}


def _run_slice(name, argv, raw, card):
    """One capture through ``cli.main`` on the card, with every launch count
    set to 0 just before and read just after."""
    from doppler_tpu_torch import cli

    sink, log = _Sink(), io.StringIO()
    # the CLI's stderr handler binds the stream it first sees: drop it so
    # this run's handler writes to this run's log
    logger = logging.getLogger("doppler_tpu_torch")
    for h in list(logger.handlers):
        logger.removeHandler(h)
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = cli.main(argv + ["--device", "cuda", "--log-format", "json"],
                      stdin=io.BytesIO(raw), stdout=sink)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    check(rc == 0, f"{name}: cli.main returned {rc}: {log.getvalue()[-2000:]}")
    msgs = [json.loads(ln)["msg"] for ln in log.getvalue().splitlines()]
    done = [m for m in msgs if m.startswith("done:")]
    check(done, f"{name}: no 'done' line from the CLI")
    m = re.search(r"host plan\+stage ([0-9.]+) s, device ([0-9.]+) s", done[-1])
    host_s, device_s = float(m.group(1)), float(m.group(2))
    n_in = len(raw) // 4
    msps = n_in / wall / 1e6
    print(f"slice {name}: launches {launches}")
    print(f"slice {name}: wall {wall!r} s, {msps!r} Msps in [{card}]")
    print(f"slice {name}: split host plan+stage {host_s!r} s, device "
          f"{device_s!r} s (copies + kernels), other host {wall - host_s!r} s "
          f"[{card}]")
    return b"".join(sink.parts), launches, msgs, {
        "wall_s": wall, "msps_in": msps, "host_s": host_s, "device_s": device_s}


def _check_slice(name, out, n_in, want_n, launches, kernel, golden):
    from doppler_tpu_torch import oracle

    n_out = len(out) // 4
    full = n_in // (B_MAIN * 2048)
    print(f"slice {name}: {n_in} samples in -> {n_out} out (want {want_n}); "
          f"{full} full chunks")
    check(n_out == want_n, f"{name}: output length {n_out} != {want_n}")
    check(launches[kernel] == full,
          f"{name}: {kernel} launched {launches[kernel]} times, {full} full chunks")
    for other in ("chain", "cascade"):
        if other != kernel:
            check(launches[other] == 0, f"{name}: {other} launched {launches[other]} times")
    check(launches["mixer"] >= 1, f"{name}: the EOF chunk did not run the mixer kernel")
    got = oracle.decode_i16_bytes(out[:len(golden) * 4])
    snr = oracle.snr_db(golden, got)
    print(f"slice {name}: first {len(golden)} outputs vs golden: SNR {snr!r} dB")
    check(snr > 70.0, f"{name}: SNR {snr} dB <= 70 dB")
    return snr


def phase_slices(torch, card):
    from doppler_tpu_torch.ops.multistage import MultiStageResampler
    from doppler_tpu_torch.ops.resample import RationalResampler

    t0 = time.perf_counter()
    raw = _capture(torch, N_SLICE, seed=3)
    raw5 = _capture(torch, N_SPLIT, seed=5, fs=FS_SPLIT)
    print(f"slice: captures of {N_SLICE} and {N_SPLIT} samples made in "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    mixed = _golden_mixed(raw, GOLDEN_BLOCKS, FS, _track_shifts(GOLDEN_BLOCKS))
    mixed5 = _golden_mixed(raw5, GOLDEN_BLOCKS, FS_SPLIT, [OFFSET] * GOLDEN_BLOCKS)
    print(f"slice: golden mix of {GOLDEN_BLOCKS} blocks x2 in "
          f"{time.perf_counter() - t0:.1f} s")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        track = ["track", "-s", str(FS), "-i", "i16", "--tlefile", tle_path,
                 "--tlename", "TEST SAT", "--location", LOCATION,
                 "--frequency", str(int(FREQ)), "--offset", str(int(OFFSET)),
                 "--time", time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX)),
                 "--resample-to", str(OUT_RATE)]

        # (i) the default route: no --resample-stages → the cascade
        out, launches, msgs, split = _run_slice("default", track, raw, card)
        check(any("using the multi-stage cascade" in m for m in msgs),
              "default: the CLI did not pick the cascade")
        ms = MultiStageResampler(FS, OUT_RATE)
        snr = _check_slice("default", out, N_SLICE, ms.out_count_for(N_SLICE),
                           launches, "cascade", _golden(mixed, ms.stages))
        res["default"] = dict(split, launches=launches, snr_db=snr)

        # (ii) the split route: ÷16·÷16 fused front, 384/3125 tail
        argv = ["const", "-s", str(FS_SPLIT), "-i", "i16", "--shift", str(OFFSET),
                "--resample-to", str(OUT_RATE)]
        out, launches, _, split = _run_slice("split", argv, raw5, card)
        ms5 = MultiStageResampler(FS_SPLIT, OUT_RATE)
        snr = _check_slice("split", out, N_SPLIT, ms5.out_count_for(N_SPLIT),
                           launches, "cascade", _golden(mixed5, ms5.stages))
        res["split"] = dict(split, launches=launches, snr_db=snr)

        # (iii) the single-stage chain, on the first 20 s of (i)
        raw20 = raw[:N_CHAIN * 4]
        out, launches, _, split = _run_slice(
            "chain", track + ["--resample-stages", "single"], raw20, card)
        rs = RationalResampler(FS, OUT_RATE)
        snr = _check_slice("chain", out, N_CHAIN, -(-N_CHAIN * 3 // 64),
                           launches, "chain", _golden(mixed, [rs]))
        res["chain"] = dict(split, launches=launches, snr_db=snr)
    return res


def _median_ms(torch, fn, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_timing(torch, gen, card):
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda.cascade import mix_cascade_plain, mix_cascade_stream
    from doppler_tpu_torch.ops.cuda.chain import (
        mix_resample_chain_plain,
        mix_resample_chain_stream,
    )
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt, mix_blocks_fmt_plain
    from doppler_tpu_torch.ops.resample import RationalResampler

    rs = RationalResampler(FS, OUT_RATE)
    bank = torch.from_numpy(rs.bank).cuda()
    carry = torch.zeros(2, rs.T - 1, device="cuda")
    _, c3, b3 = _cascade(torch, FS)
    z3 = tuple(torch.zeros(2, T - 1, device="cuda") for _, _, T in c3)
    _, c5, b5 = _cascade(torch, FS_SPLIT)
    z5 = tuple(torch.zeros(2, T - 1, device="cuda") for _, _, T in c5)
    front = dict(stages=c5, outtype="f32", final_dense=True)
    L = 2048
    res = {}
    for B in (B_MAIN, B_BIG):
        x = _data(torch, "i16", B, L, gen)
        p = nco.plan_tensor(_plan(B, L), device="cuda")
        n = B * L
        pairs = {
            "mixer": (lambda: mix_blocks_fmt(x, p),
                      lambda: mix_blocks_fmt_plain(x, p)),
            "chain": (lambda: mix_resample_chain_stream(x, p, bank, carry, P=3, Q=64, T=rs.T),
                      lambda: mix_resample_chain_plain(x, p, bank, carry, P=3, Q=64, T=rs.T)),
            "cascade": (lambda: mix_cascade_stream(x, p, b3, z3, stages=c3),
                        lambda: mix_cascade_plain(x, p, b3, z3, stages=c3)),
        }
        if B == B_MAIN:
            p5 = nco.plan_tensor(_plan(B, L, fs=FS_SPLIT), device="cuda")
            pairs["split front"] = (
                lambda: mix_cascade_stream(x, p5, b5, z5, **front),
                lambda: mix_cascade_plain(x, p5, b5, z5, **front))
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the first of each pair warms up
            pl_a = _median_ms(torch, plain)
            k_a = _median_ms(torch, kern)
            k_b = _median_ms(torch, kern)
            pl_b = _median_ms(torch, plain)
            k_ms, pl_ms = min(k_a, k_b), min(pl_a, pl_b)
            # HBM bytes per input sample: words in, words or planes out
            bpi = {"mixer": 8.0, "split front": 4.0 + 8.0 / 256}.get(
                name, 4.0 + 4.0 * 3 / 64)
            fmt = "i16->f32" if name == "split front" else "i16->i16"
            print(f"timing: {name} {fmt} B={B} ({n} samples): kernel "
                  f"{k_a!r}/{k_b!r} ms, plain {pl_a!r}/{pl_b!r} ms; kernel "
                  f"{n / k_ms / 1e6!r} GS/s, {n * bpi / k_ms / 1e6!r} GB/s "
                  f"[{card}]")
            res[(name, B)] = (k_ms, pl_ms)
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    try:
        import doppler_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: doppler_tpu_torch is not importable ({e}); run from "
              "the repository root")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = phase_device(torch)
        phase_build()
        gen = torch.Generator(device="cuda").manual_seed(0)
        mix_err = phase_mixer(torch, gen)
        chain_err = phase_chain(torch, gen)
        cascade_err = phase_cascade(torch, gen)
        slices = phase_slices(torch, card)
        times = phase_timing(torch, gen, card)
        if "jax" in sys.modules:
            raise Failed("jax was imported")
    except Exception as e:      # every failure ends the run non-zero
        traceback.print_exc()
        print(f"FAIL: {e}")
        return 1
    kernels = [
        {"name": "mixer", "route": "cuda",
         "source": "doppler_tpu_torch/csrc/mixer.cu",
         "replaces": "doppler_tpu/ops/pallas/mixer.py:227",
         "launches": slices["default"]["launches"]["mixer"], "max_abs_err": mix_err,
         "ms": times[("mixer", B_MAIN)][0], "plain_ms": times[("mixer", B_MAIN)][1]},
        {"name": "chain", "route": "cuda",
         "source": "doppler_tpu_torch/csrc/chain.cu",
         "replaces": "doppler_tpu/ops/pallas/chain.py:404",
         "launches": slices["chain"]["launches"]["chain"], "max_abs_err": chain_err,
         "ms": times[("chain", B_MAIN)][0], "plain_ms": times[("chain", B_MAIN)][1]},
        {"name": "cascade", "route": "cuda",
         "source": "doppler_tpu_torch/csrc/cascade.cu",
         "replaces": "doppler_tpu/ops/pallas/chain.py:960",
         "launches": slices["default"]["launches"]["cascade"],
         "max_abs_err": cascade_err,
         "ms": times[("cascade", B_MAIN)][0], "plain_ms": times[("cascade", B_MAIN)][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
