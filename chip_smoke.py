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
5. slice   — a 60 s synthetic config-3 capture (1.024 Msps i16, track mode
             with a TLE, resampled to 48 ksps) through the CLI entry point
             ``doppler_tpu_torch.cli.main`` on the card; exact output length,
             kernel launch counts, and SNR against the golden model.
6. timing  — each kernel and its plain version at B = 256 and B = 16384
             (median of 20 runs, CUDA events), and the slice's host/device
             split.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

FS = 1024000
OUT_RATE = 48000
B_MAIN = 256                       # the pipeline's default chunk_blocks
B_BIG = 16384                      # 33.5 M samples a dispatch
N_SLICE = 61_440_000 + 1000        # 60 s at 1.024 Msps, plus a partial block
GOLDEN_BLOCKS = 512
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


def _plan(B, L, samplenum=40000):
    from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

    # rounding-reset-heavy ratio: many blocks switch segment mid-block
    return plan_blocks([327843.76] * (B // 2) + [-15000.0] * (B - B // 2),
                       [L] * B, FS, NCOState(samplenum=samplenum), L)


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


def _capture(torch, n, seed):
    """Tones in band plus noise, made on the card, as LE i16 IQ bytes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.arange(n, dtype=torch.float64, device="cuda")
    ph1 = 2 * torch.pi * 3000.0 / FS * k
    ph2 = -2 * torch.pi * 7000.0 / FS * k + 1.0
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


def _golden(raw, n_blocks):
    import numpy as np

    from doppler_tpu_torch import oracle
    from doppler_tpu_torch.ops.resample import RationalResampler
    from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler

    x = oracle.decode_i16_bytes(raw[:n_blocks * 2048 * 4])
    tle = Tle.from_lines("TEST SAT", *_tle_lines())
    sched = TrackScheduler(Predictor(tle, Observer(58.26541, 26.46667, 76.0)),
                           FREQ, OFFSET, FS, START_UNIX, telemetry=False)
    shifts = sched.shifts([2048] * n_blocks)
    mixed = np.empty_like(x)
    sn = 0
    for b, s in enumerate(shifts):
        seg = slice(b * 2048, (b + 1) * 2048)
        mixed[seg], sn = oracle.shift_frequency_oracle(x[seg], sn, s, FS)
    rs = RationalResampler(FS, OUT_RATE)
    want = oracle.resample_oracle(mixed, rs.P, rs.Q, rs.bank).astype(np.complex64)
    return oracle.decode_i16_bytes(oracle.encode_i16_bytes(want))


def phase_slice(torch, card):
    from doppler_tpu_torch import cli, oracle
    from doppler_tpu_torch.ops.cuda.chain import mix_resample_chain_stream
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt

    t0 = time.perf_counter()
    raw = _capture(torch, N_SLICE, seed=3)
    print(f"slice: capture {N_SLICE} samples ({len(raw)} bytes) made in "
          f"{time.perf_counter() - t0:.3f} s")
    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        argv = ["track", "-s", str(FS), "-i", "i16", "--tlefile", tle_path,
                "--tlename", "TEST SAT", "--location", LOCATION,
                "--frequency", str(int(FREQ)), "--offset", str(int(OFFSET)),
                "--time", time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX)),
                "--resample-to", str(OUT_RATE), "--device", "cuda",
                "--log-format", "json"]
        sink, log = _Sink(), io.StringIO()
        fin = io.BytesIO(raw)
        mix_blocks_fmt.launches = 0
        mix_resample_chain_stream.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            rc = cli.main(argv, stdin=fin, stdout=sink)
        wall = time.perf_counter() - t0
        launches = {"mixer": mix_blocks_fmt.launches,
                    "chain": mix_resample_chain_stream.launches}
    check(rc == 0, f"cli.main returned {rc}: {log.getvalue()[-2000:]}")
    out = b"".join(sink.parts)
    n_out = len(out) // 4
    want_n = -(-N_SLICE * 3 // 64)
    print(f"slice: {N_SLICE} samples in -> {n_out} out (want {want_n}); "
          f"launches chain={launches['chain']} mixer={launches['mixer']}")
    check(n_out == want_n, "output length is not ceil(n*P/Q)")
    full_chunks = N_SLICE // (B_MAIN * 2048)
    check(launches["chain"] == full_chunks,
          f"chain launched {launches['chain']} times, {full_chunks} full chunks")
    check(launches["mixer"] >= 1, "the EOF chunk did not run the mixer kernel")
    done = [json.loads(ln)["msg"] for ln in log.getvalue().splitlines()
            if '"done:' in ln]
    check(done, "no 'done' line from the CLI")
    m = re.search(r"host plan\+stage ([0-9.]+) s, device ([0-9.]+) s", done[-1])
    host_s, device_s = float(m.group(1)), float(m.group(2))
    msps = N_SLICE / wall / 1e6
    print(f"slice: wall {wall!r} s, {msps!r} Msps in [{card}]")
    print(f"slice: split host plan+stage {host_s!r} s, device {device_s!r} s "
          f"(copies + kernels), other host {wall - host_s!r} s [{card}]")

    t0 = time.perf_counter()
    golden = _golden(raw, GOLDEN_BLOCKS)
    got = oracle.decode_i16_bytes(out[:len(golden) * 4])
    snr = oracle.snr_db(golden, got)
    print(f"slice: first {GOLDEN_BLOCKS} blocks vs golden: {len(golden)} outputs, "
          f"SNR {snr!r} dB (golden {time.perf_counter() - t0:.1f} s)")
    check(snr > 70.0, f"SNR {snr} dB <= 70 dB")
    return launches, {"wall_s": wall, "msps_in": msps, "host_s": host_s,
                      "device_s": device_s, "snr_db": snr}


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
    from doppler_tpu_torch.ops.cuda.chain import (
        mix_resample_chain_plain,
        mix_resample_chain_stream,
    )
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt, mix_blocks_fmt_plain
    from doppler_tpu_torch.ops.resample import RationalResampler

    rs = RationalResampler(FS, OUT_RATE)
    bank = torch.from_numpy(rs.bank).cuda()
    carry = torch.zeros(2, rs.T - 1, device="cuda")
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
        }
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the first of each pair warms up
            pl_a = _median_ms(torch, plain)
            k_a = _median_ms(torch, kern)
            k_b = _median_ms(torch, kern)
            pl_b = _median_ms(torch, plain)
            k_ms, pl_ms = min(k_a, k_b), min(pl_a, pl_b)
            bpi = 8.0 if name == "mixer" else 4.0 + 4.0 * 3 / 64
            print(f"timing: {name} i16->i16 B={B} ({n} samples): kernel "
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
        launches, _ = phase_slice(torch, card)
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
         "launches": launches["mixer"], "max_abs_err": mix_err,
         "ms": times[("mixer", B_MAIN)][0], "plain_ms": times[("mixer", B_MAIN)][1]},
        {"name": "chain", "route": "cuda",
         "source": "doppler_tpu_torch/csrc/chain.cu",
         "replaces": "doppler_tpu/ops/pallas/chain.py:404",
         "launches": launches["chain"], "max_abs_err": chain_err,
         "ms": times[("chain", B_MAIN)][0], "plain_ms": times[("chain", B_MAIN)][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
