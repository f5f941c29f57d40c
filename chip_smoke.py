#!/usr/bin/env python3
"""Smoke test of doppler_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (each prints one line or a few; any failure exits non-zero):

1. device  — ``nvidia-smi`` name and power limit, torch's CUDA version.
2. build   — compiles ``doppler_tpu_torch/csrc`` with nvcc (sm_90a); the
             mixer's SASS instructions a channel-sample (``cuobjdump``).
3. mixer   — the mixer kernel against its plain torch version on the card,
             all four wire formats, at the pipeline's chunk (B = 256), on
             its 16-byte path and its one-sample path (an L that is not a
             multiple of 4, a misaligned input), float32 input with NaN and
             ±inf among its samples: bitwise.
4. chain   — the fused chain kernel against its plain version at config-3
             geometry (P/Q = 3/64, T = 370, B = 256) from a nonzero carry;
             its carry against the mixer's output; its bytes across chunk
             splits; its bytes on seeded inputs (B = 256 and 16384) against
             the SHA-256 digests pinned in ``tools/kernel_digests.py``.
4b. cascade — the fused cascade kernel against its plain version at the
             config-3 stages (÷8 T = 65, 3/8 T = 51; B = 256) from nonzero
             carries in all four formats; stage-0 carry bitwise, later
             carries within 2^-20; its bytes across chunk splits; the split
             front (float32 planes) at the 100 Msps → 48 ksps stages; the
             pinned digests of both.
4c. channels — the three channel-batched kernels against their plain
             versions at C = 16, B = 256 (the channel mixer bitwise; the
             chain and the cascade at the config-3 geometries in all four
             formats from nonzero carries, and the 100 Msps split front):
             channel c bitwise against the one-channel launch, and the chunk
             split; then config 5's width, C = 256: the split front over a
             full chunk and the channel mixer over an EOF chunk, against
             their plain versions; the pinned digests of the chain, the
             cascade and the front at C = 16.
4d. probes — the Q15 mixer and the roofline probes against their plain
             versions at B = 256 and B = 16384, plan words with the segment
             switch inside some blocks, all bitwise: Q15; copy and codec at 4-
             and 16-byte accesses; chain-copy, chain-mix, mix-select and
             mix-fold with their XOR side output (which shows that the kernel
             did the work of every sample it does not store); select == fold;
             chain-mix's words == the mixer kernel's, sliced alike; Q15 against
             the exact mixer kernel within 2 LSB, SNR printed.
4e. fast  — the kernel of ``--precision fast`` (``csrc/chain_fast.cu``) at
             config-3 geometry, B = 256, from nonzero carries, all four
             formats, one stream and C = 16: against the split3 plain version
             (≤ 1 LSB in under 1%; float32 within 1e-5 of the largest
             output) and the exact kernel (≤ 1 LSB, SNR > 80 dB; float32 3e-5),
             carries bitwise the exact kernel's, bytes across three launch
             geometries, the 256 against 4 × 64 block split and channel c
             against the one-channel launch.
4f. cascade_fast — the cascade of the bf16 dots (``csrc/cascade_fast.cu``,
             ``dot_precision`` ``split3`` and ``default``) at the config-3
             stages, B = 256, from nonzero carries, all four formats: against
             its plain version (split3 as 4e; default ≥ 70 dB and beyond
             1 LSB, float32 1e-5 of the largest output, in under 0.1% of
             samples) and the exact kernel (split3 ≤ 1 LSB, > 80 dB;
             default ≥ 45 dB); stage-0 carries bitwise the exact kernel's;
             bytes and carries across three launch geometries and two
             block splits of 256 (4 × 64, 8 × 32); the 100 Msps split
             front; then
             ``csrc/chain_fast.cu`` with one pass (kernels 2 and 4 in
             ``default``) at C = 1 and 16 against its plain version.
5. slices  — synthetic captures through the CLI entry point
             ``doppler_tpu_torch.cli.main`` on the card, each with the launch
             counts set to 0 just before it and read just after:
             (i) the default config-3 route: 20 s at 1.024 Msps i16, track
             mode with a TLE, ``--resample-to 48000`` and no
             ``--resample-stages`` (the cascade); (ii) the split route:
             0.5 s at 100 Msps i16, const, → 48 ksps; (iii) the single-stage
             chain: (i) with ``--resample-stages single``; then channels
             mode, ``channels --config …``: (iv) BASELINE config 4, 16 track
             channels out of one 1.024 Msps capture → 48 ksps, 20 s (the
             channel-batched cascade); (v) its first 10 s with
             ``--resample-stages single`` (the channel-batched chain);
             (vi) config 4 as the conformance harness runs it, 16 const
             channels and no resampler (the channel mixer); (vii) config
             5's rate and width on one card: 100 Msps, 256 const channels →
             48 ksps, 0.1 s (the ÷256 front batched, the tail batched in
             plain torch).  Exact output lengths on every channel, launch
             counts, and SNR against the golden model (on the first, the
             middle and the last channel from the plan words, and on the
             middle channel from the reference's sequential mix as well).
             With ``--precision fast``: (i) again, whose bytes must be (i)'s
             (the cascade stays exact); (iii-fast) (iii) through the fast
             kernel, against (iii)'s golden and within 1 LSB of (iii)'s
             bytes; (v-fast) the first 5 s of (v) through the fast channel
             kernel, against (v)'s goldens and within 1 LSB of (v)'s bytes.
5b. conformance — ``doppler_tpu_torch.tools.conformance --device cuda``:
             the five BASELINE configs through ``python -m doppler_tpu_torch``
             subprocesses on the card against the golden model, > 60 dB each.
6. timing  — each kernel and its plain version at B = 256 and B = 16384
             (median of 20 runs, CUDA events; the split front at B = 256),
             the channel-batched ones at C = 16 with ``torch.profiler``'s
             device time, each kernel's bound, and each slice's host/device
             split; the Q15 mixer and the probes likewise, with the
             library's ``copy_`` beside the two copies (events and device
             time); the bf16-dot branches (chain and cascade, split3 and
             default) likewise; the split3 chain's and the split3
             cascade's mix and dots each alone (the other cut); the
             elementwise probe's four variants and the library's ``copy_``
             by one timer (16 calls between two events, best of 10, into a
             buffer the caller owns); the channel mixer by channels a CTA
             at C = 16 and at C = 256.
6b. roofline — the launch counts set to 0, then
             ``doppler_tpu_torch.tools.roofline.main`` (all variants),
             ``…probe_chain_precision.main`` (its ``def`` variant included),
             ``…probe_cascade_precision.main`` (exact, fast, def) and
             ``…probe_split_tail.main`` (full, front: the tail's share) in
             process at 33,554,432 samples; every variant's line; then the
             counts are read.

The kernels' JSON record takes the mixer's and the cascade's launch counts
from slice (i), the chain's from slice (iii), the channel cascade's from
(iv), the channel chain's from (v), the fast kernel's from (iii-fast) and
(v-fast), and the Q15 mixer's, the probes', the one-pass chain's and the
fast cascade's (split3 and default, which no CLI path reaches) from
phase 6b; the Q15 mixer's and the probes' times are at B = 16384, the
tools' shape (the elementwise probe's and its ``library_ms`` by phase 6's
one timer of 16 calls).  The line before the last is that
record; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script fails before printing
either.
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
N_SLICE = 20_480_000 + 1000        # 20 s at 1.024 Msps, plus a partial block
N_SPLIT = 50_000_000 + 1000        # 0.5 s at 100 Msps
N_CH_CHAIN = 10_240_000 + 1000     # the first 10 s of the channels capture
N_CH_MIX = 5_120_000 + 1000        # its first 5 s
N_CH_FAST = N_CH_MIX               # (v-fast): the first 5 s
N_WIDE = 10_000_000 + 1000         # 0.1 s at 100 Msps
C_MAIN = 16                        # BASELINE config 4's channel count
C_WIDE = 256                       # BASELINE config 5's
GOLDEN_BLOCKS = 512
TOL_F32 = 2.0 ** -20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # float32 FMA outside the tensor cores (2 a FMA)
F32_OPS_PER_S = F32_FLOP_PER_S / 2  # float32 operations that are not an FMA: one
                                   # instruction each (-fmad=false), half the rate
BF16_FLOP_PER_S = 989e12           # dense bf16 on the tensor cores
MIX_FLOP = 29                      # csrc/nco.cuh: decode 2, tone 21, rotate 6
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
    _print_sass_counts(info["path"])
    return secs


# The mixer's instance whose SASS is counted (i16 -> i16, the 16-byte path)
# and the channel-samples one trip of its channel loop handles (csrc/mixer.cu:
# kMixerIters groups of four).
SASS_MIXER = (("mixer_kernel", "ILb0ELb0ELb1E"), 16)


def _sass_instructions(path):
    """Static SASS of every kernel in the library at ``path`` (``cuobjdump
    -sass`` of the toolkit that built it): name -> [(address, opcode text)],
    NOPs left out."""
    from doppler_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:400]}")
    funcs, name = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^/;]+);", line)
        if name and m and not m.group(2).strip().startswith("NOP"):
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _print_sass_counts(path):
    """The mixer's static instruction count: the whole kernel, and its
    channel loop (the longest backward branch), per channel-sample at the
    channel group the C = 16, B = 16384 launch picks."""
    from doppler_tpu_torch.ops.cuda import build

    keys, per_trip = SASS_MIXER
    funcs = _sass_instructions(path)
    found = [(n, ins) for n, ins in funcs.items() if all(k in n for k in keys)]
    check(len(found) == 1, f"sass: {len(found)} kernels match {keys}")
    name, ins = found[0]
    loop = (0, 0)
    for addr, text in ins:
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loop = max(loop, (addr - int(m.group(1), 16), int(m.group(1), 16)))
    span, top = loop
    check(span > 0, f"sass: no channel loop in {name}")
    in_loop = sum(1 for a, _ in ins if top <= a <= top + span)
    G = build.load().doppler_mixer_group(C_MAIN, B_BIG, 2048)
    per = (len(ins) - in_loop) / (per_trip * G) + in_loop / per_trip
    print(f"sass: mixer i16->i16 ({name}): {len(ins)} instructions, {in_loop} of them "
          f"in the channel loop ({per_trip} channel-samples a trip); at C={C_MAIN} "
          f"B={B_BIG} (G={G}): {per!r} a channel-sample")


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


def _bitwise(torch, got, want):
    """Equal bits, NaN in the same places (whatever its payload)."""
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = got.isnan()
    return (torch.equal(nan, want.isnan())
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def phase_mixer(torch, gen):
    """The mixer in the four formats at B = 256 on its 16-byte path, then on
    its one-sample path (an L that is not a multiple of 4, an input that is
    not 16-byte aligned): bitwise the plain version, float32 input with NaN,
    ±inf and out-of-range values among its samples."""
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt, mix_blocks_fmt_plain

    cases = [(intype, outtype, 2048 if intype == "i16" else 1024, False)
             for intype, outtype in FORMATS]
    cases += [("i16", "i16", 2046, False), ("f32", "f32", 1022, False),
              ("i16", "i16", 2048, True), ("f32", "i16", 1024, True)]
    for intype, outtype, L, misalign in cases:
        plan = _plan(B_MAIN, L)
        check((plan.t < L).any(), "plan words have no segment switch")
        x = _data(torch, intype, B_MAIN, L, gen)
        if intype == "f32":     # the encode's NaN -> 0 and its saturation
            x.view(-1)[::997] = float("nan")
            x.view(-1)[5::1009] = float("inf")
            x.view(-1)[7::1013] = -3.0
        if misalign:            # the same values 4 bytes past a 16-byte boundary
            flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
            flat[1:] = x.reshape(-1)
            x = flat[1:].view(x.shape)
        p = nco.plan_tensor(plan, device="cuda")
        got = mix_blocks_fmt(x, p, intype=intype, outtype=outtype)
        torch.cuda.synchronize()
        want = mix_blocks_fmt_plain(x, p, intype=intype, outtype=outtype)
        ok = _bitwise(torch, got, want)
        path = "16-byte" if L % 4 == 0 and not misalign else "one-sample"
        print(f"mixer: {intype}->{outtype} B={B_MAIN} L={L} ({path} path"
              f"{', misaligned input' if misalign else ''}): bitwise={ok}")
        check(ok, f"mixer {intype}->{outtype} L={L} not bitwise equal to plain")
    return 0.0


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
    _check_digests(("chain",), (1,))
    return worst


def _check_digests(kernels, channels):
    """The kernels' outputs and carries on the seeded inputs of
    ``tools/kernel_digests.py`` (B = 256 and 16384, i16 and float32 in, from
    non-zero carries) against the SHA-256 pinned there, which were taken on
    the kernels before their redesign: the bytes may depend on nothing but
    the inputs."""
    from doppler_tpu_torch.tools import kernel_digests

    t0 = time.perf_counter()
    got = kernel_digests.compute(kernels=kernels, channels=channels)
    bad = kernel_digests.mismatches(got)
    print(f"digests: {'/'.join(kernels)} at C={'/'.join(map(str, channels))}: "
          f"{len(got) - len(bad)} of {len(got)} cases (B = "
          f"{'/'.join(map(str, kernel_digests.BLOCKS))}, i16 and f32, outputs "
          f"and carries) equal the pinned SHA-256 in "
          f"{time.perf_counter() - t0:.1f} s")
    check(not bad, f"bytes differ from the pinned digests: {bad}")


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
    lay = cascade.plan_launch(torch.device("cuda"), stages5)
    print(f"cascade: split front {stages5} B={B_MAIN}: out {tuple(got.shape)} "
          f"max|d|={err!r}; tile {lay.tile} outputs, {lay.threads} threads, R "
          f"{lay.regs}, {lay.smem_bytes} B of shared memory a CTA; stage-0 carry "
          f"bitwise={c0_ok}, stage-1 carry max|d|={c_err!r}")
    check(err <= TOL_F32 and c0_ok and c_err <= TOL_F32,
          "split front differs from its plain version")
    _check_digests(("cascade", "front"), (1,))
    return max(worst, err)


def _channel_plans(torch, C, B, L, samplenum=40000, fs=FS):
    """``(7, C, B)`` plan words: every channel its own shifts and its own
    samplenum state (rounding-reset-heavy ratios among them)."""
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

    return torch.stack([
        nco.plan_tensor(plan_blocks(
            [327843.76 - 9000.0 * c] * (B // 2) + [-15000.0 + 777.0 * c] * (B - B // 2),
            [L] * B, fs, NCOState(samplenum=samplenum + 13 * c), L))
        for c in range(C)], dim=1).cuda()


def _channel_of(out, c, outtype):
    return out[c] if outtype == "i16" else out[:, c]


def _err_vs_plain(torch, got, want, outtype, what):
    """max LSB (≤ 1 in under 1%) or max |d| (≤ 2^-20) against plain."""
    if outtype == "i16":
        d = _lsb_diff(torch, got, want)
        err, frac = float(d.max()), float((d > 0).float().mean())
        check(err <= 1 and frac < 0.01, f"{what} off by >1 LSB ({err}, {frac})")
        return err, f"max LSB={err:g} frac={frac!r}"
    err = float((got - want).abs().max())
    check(err <= TOL_F32, f"{what} f32 off by {err}")
    return err, f"max|d|={err!r}"


def phase_channels(torch, gen):
    """The channel-batched kernels at C = 16, B = 256: against plain, channel
    c against the one-channel launch, the chunk split; then the front and the
    mixer at C = 256."""
    from doppler_tpu_torch.ops.cuda import cascade, chain, mixer
    from doppler_tpu_torch.ops.resample import RationalResampler

    C, B, L = C_MAIN, B_MAIN, 2048
    worst = {"mixer": 0.0, "chain": 0.0, "cascade": 0.0}

    for intype, outtype in FORMATS:
        Lm = L if intype == "i16" else 1024
        x = _data(torch, intype, B, Lm, gen)
        p = _channel_plans(torch, C, B, Lm)
        got = mixer.mix_blocks_fmt_channels(x, p, intype=intype, outtype=outtype)
        torch.cuda.synchronize()
        want = mixer.mix_blocks_fmt_channels_plain(x, p, intype=intype, outtype=outtype)
        same = torch.equal(got, want)
        rows = all(torch.equal(
            _channel_of(got, c, outtype),
            mixer.mix_blocks_fmt(x, p[:, c].contiguous(), intype=intype,
                                 outtype=outtype)) for c in range(C))
        print(f"channels: mixer {intype}->{outtype} C={C} B={B} L={Lm}: bitwise vs "
              f"plain={same}, rows vs C=1 launch bitwise={rows}")
        check(same and rows, f"channel mixer {intype}->{outtype} differs")

    rs = RationalResampler(FS, OUT_RATE)
    P, Q, T = rs.P, rs.Q, rs.T
    bank = torch.from_numpy(rs.bank).cuda()
    for intype, outtype in FORMATS:
        kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
        x0, x1 = (_data(torch, intype, B, L, gen) for _ in range(2))
        p0 = _channel_plans(torch, C, B, L)
        p1 = _channel_plans(torch, C, B, L, samplenum=7)
        zero = torch.zeros(C, 2, T - 1, device="cuda")
        # nonzero carries: what a previous chunk left in every channel
        _, carry = chain.mix_resample_chain_channels(x0, p0, bank, zero, **kw)
        got, c_got = chain.mix_resample_chain_channels(x1, p1, bank, carry, **kw)
        torch.cuda.synchronize()
        want, c_want = chain.mix_resample_chain_channels_plain(x1, p1, bank, carry, **kw)
        err, text = _err_vs_plain(torch, got, want, outtype,
                                  f"chain_channels {intype}->{outtype}")
        check(torch.equal(c_got, c_want), "chain_channels carries differ from plain")
        rows = True
        for c in range(C):
            one, c_one = chain.mix_resample_chain_stream(
                x1, p1[:, c].contiguous(), bank, carry[c].contiguous(), **kw)
            rows = rows and torch.equal(_channel_of(got, c, outtype), one) \
                and torch.equal(c_got[c], c_one)
        print(f"channels: chain {intype}->{outtype} C={C} B={B}: {text}; carries "
              f"bitwise; rows vs C=1 launch bitwise={rows}")
        check(rows, f"chain_channels {intype}->{outtype}: a channel differs "
                              "from its one-channel launch")
        worst["chain"] = max(worst["chain"], err)
        if (intype, outtype) == ("i16", "i16"):
            cc, parts = carry, []
            for k in range(0, B, 64):
                o, cc = chain.mix_resample_chain_channels(
                    x1[k:k + 64].contiguous(), p1[:, :, k:k + 64].contiguous(),
                    bank, cc, **kw)
                parts.append(o)
            torch.cuda.synchronize()
            split_ok = torch.equal(torch.cat(parts, dim=1), got) and torch.equal(cc, c_got)
            print(f"channels: chain 256 blocks vs 4x64 blocks bitwise={split_ok}")
            check(split_ok, "chain_channels bytes depend on the chunk split")

    for fs, formats in ((FS, FORMATS), (FS_SPLIT, (("i16", "f32"),))):
        ms, stages, banks = _cascade(torch, fs)
        dense = len(stages) < len(ms.stages)
        for intype, outtype in formats:
            kw = dict(stages=stages, intype=intype, outtype=outtype, final_dense=dense)
            x0, x1 = (_data(torch, intype, B, L, gen) for _ in range(2))
            p0 = _channel_plans(torch, C, B, L, fs=fs)
            p1 = _channel_plans(torch, C, B, L, samplenum=7, fs=fs)
            zero = tuple(torch.zeros(C, 2, Ts - 1, device="cuda") for _, _, Ts in stages)
            _, carry = cascade.mix_cascade_channels(x0, p0, banks, zero, **kw)
            got, c_got = cascade.mix_cascade_channels(x1, p1, banks, carry, **kw)
            torch.cuda.synchronize()
            want, c_want = cascade.mix_cascade_channels_plain(x1, p1, banks, carry, **kw)
            err, text = _err_vs_plain(torch, got, want, outtype,
                                      f"cascade_channels {intype}->{outtype} at {fs}")
            c0_ok, c_err = _carry_errs(torch, c_got, c_want)
            check(c0_ok and c_err <= TOL_F32, "cascade_channels carries differ from plain")
            rows = True
            for c in range(C):
                one, c_one = cascade.mix_cascade_stream(
                    x1, p1[:, c].contiguous(), banks,
                    [cr[c].contiguous() for cr in carry], **kw)
                rows = rows and torch.equal(_channel_of(got, c, outtype), one) \
                    and all(torch.equal(a[c], b) for a, b in zip(c_got, c_one))
            print(f"channels: cascade {stages} {intype}->{outtype} C={C} B={B}: {text}; "
                  f"stage-0 carries bitwise, later max|d|={c_err!r}; rows vs C=1 "
                  f"launch bitwise={rows}")
            check(rows, f"cascade_channels {intype}->{outtype} at {fs}: a "
                                  "channel differs from its one-channel launch")
            worst["cascade"] = max(worst["cascade"], err)
            if intype == "i16":
                cc, parts = carry, []
                for k in range(0, B, 64):
                    o, cc = cascade.mix_cascade_channels(
                        x1[k:k + 64].contiguous(), p1[:, :, k:k + 64].contiguous(),
                        banks, cc, **kw)
                    parts.append(o)
                torch.cuda.synchronize()
                split_ok = torch.equal(torch.cat(parts, dim=-2), got) and all(
                    torch.equal(a, b) for a, b in zip(cc, c_got))
                print(f"channels: cascade at {fs} 256 blocks vs 4x64 blocks "
                      f"bitwise={split_ok}")
                check(split_ok, "cascade_channels bytes depend on the chunk split")

    # config 5's width, at the shapes slice (vii) gives the kernels: the
    # 100 Msps front for 256 channels over a full chunk from nonzero
    # carries, and the channel mixer on the EOF chunk's 20 blocks
    _, stages, banks = _cascade(torch, FS_SPLIT)
    kw = dict(stages=stages, intype="i16", outtype="f32", final_dense=True)
    x0, x1 = (_data(torch, "i16", B, L, gen) for _ in range(2))
    p0 = _channel_plans(torch, C_WIDE, B, L, fs=FS_SPLIT)
    p1 = _channel_plans(torch, C_WIDE, B, L, samplenum=7, fs=FS_SPLIT)
    zero = tuple(torch.zeros(C_WIDE, 2, Ts - 1, device="cuda") for _, _, Ts in stages)
    _, carry = cascade.mix_cascade_channels(x0, p0, banks, zero, **kw)
    got, c_got = cascade.mix_cascade_channels(x1, p1, banks, carry, **kw)
    torch.cuda.synchronize()
    want, c_want = cascade.mix_cascade_channels_plain(x1, p1, banks, carry, **kw)
    err, text = _err_vs_plain(torch, got, want, "f32",
                              f"cascade_channels front at C={C_WIDE}")
    c0_ok, c_err = _carry_errs(torch, c_got, c_want)
    print(f"channels: cascade {stages} i16->f32 C={C_WIDE} B={B}: out "
          f"{tuple(got.shape)} {text}; stage-0 carries bitwise={c0_ok}, later "
          f"max|d|={c_err!r}")
    check(c0_ok and c_err <= TOL_F32,
          f"cascade_channels carries at C={C_WIDE} differ from plain")
    worst["cascade"] = max(worst["cascade"], err)
    B_eof = (N_WIDE % (B * L) + L - 1) // L
    xe = _data(torch, "i16", B_eof, L, gen)
    pe = _channel_plans(torch, C_WIDE, B_eof, L, fs=FS_SPLIT)
    got = mixer.mix_blocks_fmt_channels(xe, pe, outtype="f32")
    torch.cuda.synchronize()
    same = torch.equal(got, mixer.mix_blocks_fmt_channels_plain(xe, pe, outtype="f32"))
    print(f"channels: mixer i16->f32 C={C_WIDE} B={B_eof} L={L}: bitwise vs "
          f"plain={same}")
    check(same, f"channel mixer at C={C_WIDE} differs from plain")
    _check_digests(("chain", "cascade", "front"), (C_MAIN,))
    return worst


FAST_REL = 1e-5                    # fast kernel vs its plain version, f32 out
# (windows, threads): windows a multiple of 16·D = 32 (D = 2 at 3/64, L = 2048)
FAST_GEOMS = ((32, 64), (64, 128), (128, 256))


def _fast_vs(torch, got, want, outtype, what, *, exact=False):
    """The fast kernel against its plain version (≤ 1 LSB in under 1%;
    float32 within FAST_REL of the largest output) or, ``exact``, against the
    exact kernel (≤ 1 LSB and SNR ≥ 80 dB; float32 within 3e-5): a tensor
    core does not add as IEEE float32 does.  Returns (max LSB or max |d|,
    text)."""
    if outtype == "i16":
        d = _lsb_diff(torch, got, want)
        err, frac = float(d.max()), float((d > 0).float().mean())
        if exact:
            snr = _snr_db_words(torch, want, got)
            check(err <= 1 and snr > 80.0, f"{what} vs exact: {err} LSB, {snr} dB")
            return err, f"vs exact max LSB={err:g} frac={frac!r} SNR={snr!r} dB"
        check(err <= 1 and frac < 0.01, f"{what} off by >1 LSB ({err}, {frac})")
        return err, f"max LSB={err:g} frac={frac!r}"
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    rel = 3e-5 if exact else FAST_REL
    check(err <= rel * scale, f"{what} f32 off by {err} of {scale}")
    return err, f"{'vs exact ' if exact else ''}max|d|={err!r} (|y|max {scale!r})"


def phase_chain_fast(torch, gen):
    """The kernel of ``--precision fast`` (csrc/chain_fast.cu) at config-3
    geometry, B = 256, from nonzero carries, all four formats: one stream and
    C = 16 against the split3 plain version and against the exact kernel;
    carries bitwise the exact kernel's; bytes across launch geometries, the
    256 against 4 × 64 block split and channel c against the one-channel
    launch."""
    from doppler_tpu_torch.ops.cuda import chain
    from doppler_tpu_torch.ops.resample import RationalResampler

    rs = RationalResampler(FS, OUT_RATE)
    P, Q, T = rs.P, rs.Q, rs.T
    bank = torch.from_numpy(rs.bank).cuda()
    C, B, L = C_MAIN, B_MAIN, 2048
    worst = {"stream": 0.0, "channels": 0.0}
    for intype, outtype in FORMATS:
        kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
        x0, x1 = (_data(torch, intype, B, L, gen) for _ in range(2))
        p0 = _channel_plans(torch, C, B, L)
        p1 = _channel_plans(torch, C, B, L, samplenum=7)
        zero = torch.zeros(C, 2, T - 1, device="cuda")
        _, carry = chain.mix_resample_chain_channels(x0, p0, bank, zero, **kw)
        # one stream: channel 0's plan words and carry
        ps, cs_ = p1[:, 0].contiguous(), carry[0].contiguous()
        got, c_got = chain.mix_resample_chain_stream(x1, ps, bank, cs_,
                                                     dot_precision="split3", **kw)
        torch.cuda.synchronize()
        want, c_want = chain.mix_resample_chain_plain(x1, ps, bank, cs_,
                                                      dot_precision="split3", **kw)
        exact, c_exact = chain.mix_resample_chain_stream(x1, ps, bank, cs_, **kw)
        err, text = _fast_vs(torch, got, want, outtype, f"chain_fast {intype}->{outtype}")
        _, text_x = _fast_vs(torch, got, exact, outtype,
                             f"chain_fast {intype}->{outtype}", exact=True)
        check(torch.equal(c_got, c_exact) and torch.equal(c_got, c_want),
              f"chain_fast {intype}->{outtype} carry differs from the exact kernel's")
        geoms = all(torch.equal(chain._launch_fast(
            x1, ps, bank, cs_[None], 1, B, L, P, Q, T, intype, outtype, geom=g)[0]
            .reshape(got.shape), got) for g in FAST_GEOMS)
        print(f"chain_fast: {intype}->{outtype} B={B}: {text}; {text_x}; carry "
              f"bitwise the exact kernel's; {len(FAST_GEOMS)} geometries bitwise={geoms}")
        check(geoms, "chain_fast bytes depend on the launch geometry")
        worst["stream"] = max(worst["stream"], err)
        # C = 16
        got_c, c_got_c = chain.mix_resample_chain_channels(x1, p1, bank, carry,
                                                           dot_precision="split3", **kw)
        torch.cuda.synchronize()
        want_c, c_want_c = chain.mix_resample_chain_channels_plain(
            x1, p1, bank, carry, dot_precision="split3", **kw)
        _, c_exact_c = chain.mix_resample_chain_channels(x1, p1, bank, carry, **kw)
        err, text = _fast_vs(torch, got_c, want_c, outtype,
                             f"chain_channels_fast {intype}->{outtype}")
        check(torch.equal(c_got_c, c_exact_c) and torch.equal(c_got_c, c_want_c),
              "chain_channels_fast carries differ from the exact kernel's")
        rows = all(torch.equal(_channel_of(got_c, c, outtype), chain.mix_resample_chain_stream(
            x1, p1[:, c].contiguous(), bank, carry[c].contiguous(),
            dot_precision="split3", **kw)[0]) for c in range(C))
        print(f"chain_fast: channels {intype}->{outtype} C={C} B={B}: {text}; carries "
              f"bitwise the exact kernel's; rows vs C=1 launch bitwise={rows}")
        check(rows, "chain_channels_fast: a channel differs from its one-channel launch")
        worst["channels"] = max(worst["channels"], err)
        if (intype, outtype) == ("i16", "i16"):
            c, parts = cs_, []
            for k in range(0, B, 64):
                o, c = chain.mix_resample_chain_stream(
                    x1[k:k + 64].contiguous(), ps[:, k:k + 64].contiguous(), bank, c,
                    dot_precision="split3", **kw)
                parts.append(o)
            torch.cuda.synchronize()
            split_ok = torch.equal(torch.cat(parts), got) and torch.equal(c, c_got)
            print(f"chain_fast: 256 blocks vs 4x64 blocks bitwise={split_ok}")
            check(split_ok, "chain_fast bytes depend on the chunk split")
    return worst


def _default_vs(torch, got, want, outtype, what):
    """The one-pass cascade against its plain version: ≥ 70 dB, and beyond
    1 LSB (float32: FAST_REL of the largest output) in under 0.1% of
    samples.  Its later stages read x_s that the two sum in other orders;
    where those lie either side of a bf16 rounding boundary the one pass
    takes x_h one bf16 ulp apart and nothing takes the difference up, so a
    few outputs move by up to 2^-8 of x_s times a tap.  Returns (max LSB or
    max |d|, text)."""
    if outtype == "i16":
        d = _lsb_diff(torch, got, want)
        err, off = float(d.max()), float((d > 1).float().mean())
        snr = _snr_db_words(torch, want, got)
    else:
        d = (got - want).abs()
        err, scale = float(d.max()), float(want.abs().max())
        off = float((d > FAST_REL * scale).float().mean())
        w = want.double()
        snr = float(10 * torch.log10((w * w).sum() / (d.double() ** 2).sum()))
    check(off < 1e-3 and snr >= 70.0, f"{what}: {off} of samples off, {snr} dB")
    return err, (f"max {'LSB' if outtype == 'i16' else '|d|'}={err!r}, beyond "
                 f"the bound {off!r} of samples, {snr!r} dB")


# (windows, threads[, slab]): multiples of 16·D = 32 and 128 windows at config 3
CASCADE_FAST_GEOMS = ((32, 64), (64, 128, 1024), (96, 256, 128))
DOTS = ("split3", "default")
DEFAULT_VS_EXACT_DB = 45.0         # one bf16 pass against the float32 dots


def _snr_db(torch, ref, test, outtype):
    """SNR of ``test`` against ``ref``, i16 words or float32 planes."""
    if outtype == "i16":
        return _snr_db_words(torch, ref, test)
    r = ref.double()
    d = r - test.double()
    return float(10 * torch.log10((r * r).sum() / (d * d).sum()))


def phase_cascade_fast(torch, gen):
    """The cascade of the bf16 dots (csrc/cascade_fast.cu) at the config-3
    stages, from nonzero carries, split3 and default: all four formats at
    B = 256 and i16 -> i16 at B = 16384, the tools' shape (the one path that
    launches this kernel).  Against its plain version and the exact kernel;
    stage-0 carries bitwise the exact kernel's; bytes and carries across
    three launch geometries; the 256 against 4 × 64 block split; the 100 Msps
    split front; then chain_fast.cu's one pass (kernels 2 and 4 in default)
    against its plain version and the exact kernel, at both B."""
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda import cascade, chain
    from doppler_tpu_torch.ops.precision import PASSES
    from doppler_tpu_torch.ops.resample import RationalResampler

    _, stages, banks = _cascade(torch, FS)
    L = 2048
    zero = tuple(torch.zeros(2, T - 1, device="cuda") for _, _, T in stages)
    worst = {dot: 0.0 for dot in DOTS}
    for B, formats in ((B_MAIN, FORMATS), (B_BIG, (("i16", "i16"),))):
        for intype, outtype in formats:
            x0, x1 = (_data(torch, intype, B, L, gen) for _ in range(2))
            p0 = nco.plan_tensor(_plan(B, L), device="cuda")
            p1 = nco.plan_tensor(_plan(B, L, samplenum=7), device="cuda")
            _, carry = cascade.mix_cascade_stream(x0, p0, banks, zero, stages=stages,
                                                  intype=intype, outtype="f32")
            kw = dict(stages=stages, intype=intype, outtype=outtype)
            exact, c_exact = cascade.mix_cascade_stream(x1, p1, banks, carry, **kw)
            for dot in DOTS:
                what = f"cascade_fast {dot} {intype}->{outtype} B={B}"
                got, c_got = cascade.mix_cascade_stream(x1, p1, banks, carry,
                                                        dot_precision=dot, **kw)
                torch.cuda.synchronize()
                want, c_want = cascade.mix_cascade_plain(x1, p1, banks, carry,
                                                         dot_precision=dot, **kw)
                check(torch.equal(c_got[0], c_exact[0])
                      and torch.equal(c_got[0], c_want[0]),
                      f"{what}: stage-0 carry differs from the exact kernel's")
                _, c_err = _carry_errs(torch, c_got, c_want)
                if dot == "split3":
                    err, text = _fast_vs(torch, got, want, outtype, what)
                    _, text_x = _fast_vs(torch, got, exact, outtype, what, exact=True)
                    check(c_err <= FAST_REL * max(float(c.abs().max()) for c in c_want[1:]),
                          f"{what}: later carries off by {c_err}")
                else:
                    err, text = _default_vs(torch, got, want, outtype, what)
                    snr = _snr_db(torch, exact, got, outtype)
                    check(snr >= DEFAULT_VS_EXACT_DB, f"{what}: {snr} dB from the exact kernel")
                    text_x = f"vs exact SNR={snr!r} dB"
                args = (x1, p1, banks, carry, B, L, stages, B * L * 3 // 64,
                        intype, outtype, PASSES[dot])
                flat = got.reshape(-1)
                geoms = True
                for g in CASCADE_FAST_GEOMS:
                    o, c = cascade._launch_fast(*args, geom=g)
                    geoms &= (torch.equal(o.reshape(-1), flat)
                              and all(torch.equal(a, b) for a, b in zip(c, c_got)))
                print(f"cascade_fast: {dot} {intype}->{outtype} B={B}: {text}; "
                      f"{text_x}; stage-0 carry bitwise the exact kernel's, stage-1 "
                      f"carry max|d|={c_err!r} from plain; {len(CASCADE_FAST_GEOMS)} "
                      f"geometries bitwise={geoms}")
                check(geoms, f"{what}: bytes depend on the launch geometry")
                worst[dot] = max(worst[dot], err)
                if (B, intype, outtype) == (B_MAIN, "i16", "i16"):
                    for n in (64, 32):          # two cuts: 4 × 64 and 8 × 32
                        c, parts = carry, []
                        for k in range(0, B, n):
                            o, c = cascade.mix_cascade_stream(
                                x1[k:k + n].contiguous(), p1[:, k:k + n].contiguous(),
                                banks, c, stages=stages, dot_precision=dot)
                            parts.append(o)
                        torch.cuda.synchronize()
                        split_ok = (torch.equal(torch.cat(parts), got)
                                    and all(torch.equal(a, b) for a, b in zip(c, c_got)))
                        print(f"cascade_fast: {dot} 256 blocks vs {B // n}x{n} blocks "
                              f"bitwise={split_ok}")
                        check(split_ok, f"{what}: bytes depend on the chunk split")

    # the split front at the 100 Msps stages: float32 planes out
    _, stages5, banks5 = _cascade(torch, FS_SPLIT)
    zero5 = tuple(torch.zeros(2, T - 1, device="cuda") for _, _, T in stages5)
    x0, x1 = (_data(torch, "i16", B_MAIN, L, gen) for _ in range(2))
    p0 = nco.plan_tensor(_plan(B_MAIN, L, fs=FS_SPLIT), device="cuda")
    p1 = nco.plan_tensor(_plan(B_MAIN, L, samplenum=7, fs=FS_SPLIT), device="cuda")
    kw = dict(stages=stages5, outtype="f32", final_dense=True)
    _, carry = cascade.mix_cascade_stream(x0, p0, banks5, zero5, **kw)
    exact, c_exact = cascade.mix_cascade_stream(x1, p1, banks5, carry, **kw)
    lay = cascade.plan_launch_fast(torch.device("cuda"), stages5, L, 3)
    for dot in DOTS:
        got, c_got = cascade.mix_cascade_stream(x1, p1, banks5, carry,
                                                dot_precision=dot, **kw)
        torch.cuda.synchronize()
        want, c_want = cascade.mix_cascade_plain(x1, p1, banks5, carry,
                                                 dot_precision=dot, **kw)
        what = f"cascade_fast {dot} split front"
        if dot == "split3":
            err, text = _fast_vs(torch, got, want, "f32", what)
            _, text_x = _fast_vs(torch, got, exact, "f32", what, exact=True)
        else:
            err, text = _default_vs(torch, got, want, "f32", what)
            snr = _snr_db(torch, exact, got, "f32")
            check(snr >= DEFAULT_VS_EXACT_DB, f"{what}: {snr} dB from the exact kernel")
            text_x = f"vs exact SNR={snr!r} dB"
        check(torch.equal(c_got[0], c_want[0]) and torch.equal(c_got[0], c_exact[0]),
              f"{what}: stage-0 carry differs")
        print(f"cascade_fast: {dot} split front {stages5} B={B_MAIN}: {text}; "
              f"{text_x}; {lay.windows} windows, {lay.threads} threads, slabs of "
              f"{lay.slab}, {lay.smem_bytes} B of shared memory a CTA; stage-0 carry "
              f"bitwise the exact kernel's")
        worst[dot] = max(worst[dot], err)

    # kernels 2 and 4 in default: chain_fast.cu with one pass
    rs = RationalResampler(FS, OUT_RATE)
    bank = torch.from_numpy(rs.bank).cuda()
    ckw = dict(P=rs.P, Q=rs.Q, T=rs.T)
    for B, formats in ((B_MAIN, FORMATS), (B_BIG, (("i16", "i16"),))):
        for intype, outtype in formats:
            x = _data(torch, intype, B, L, gen)
            C = C_MAIN if B == B_MAIN else 1
            p = _channel_plans(torch, C, B, L)
            carries = torch.randn((C, 2, rs.T - 1), device="cuda", generator=gen) * 0.3
            kw = dict(ckw, intype=intype, outtype=outtype)
            ps, cs_ = p[:, 0].contiguous(), carries[0].contiguous()
            what = f"chain_fast default {intype}->{outtype} B={B}"
            got, c_got = chain.mix_resample_chain_stream(x, ps, bank, cs_,
                                                         dot_precision="default", **kw)
            torch.cuda.synchronize()
            want, _ = chain.mix_resample_chain_plain(x, ps, bank, cs_,
                                                     dot_precision="default", **kw)
            exact, c_exact = chain.mix_resample_chain_stream(x, ps, bank, cs_, **kw)
            err, text = _fast_vs(torch, got, want, outtype, what)
            check(torch.equal(c_got, c_exact), f"{what}: carry differs")
            snr = _snr_db(torch, exact, got, outtype)
            check(snr >= DEFAULT_VS_EXACT_DB, f"{what}: {snr} dB from the exact kernel")
            line = (f"chain_fast: default {intype}->{outtype} B={B}: {text}; vs exact "
                    f"SNR={snr!r} dB; carry bitwise")
            worst["chain default"] = max(worst.get("chain default", 0.0), err)
            if (B, intype, outtype) == (B_MAIN, "i16", "i16"):
                got_c, _ = chain.mix_resample_chain_channels(x, p, bank, carries,
                                                             dot_precision="default", **kw)
                torch.cuda.synchronize()
                want_c, _ = chain.mix_resample_chain_channels_plain(
                    x, p, bank, carries, dot_precision="default", **kw)
                _, text_c = _fast_vs(torch, got_c, want_c, outtype,
                                     "chain_channels_fast default")
                check(torch.equal(got_c[0], got), "chain_channels_fast default: "
                      "channel 0 differs from the one-channel launch")
                geoms = all(torch.equal(chain._launch_fast(
                    x, ps, bank, cs_[None], 1, B, L, rs.P, rs.Q, rs.T, intype, outtype,
                    geom=g, passes=1)[0].reshape(got.shape), got) for g in FAST_GEOMS)
                check(geoms, "chain_fast default bytes depend on the launch geometry")
                line += (f"; C={C_MAIN}: {text_c}, channel 0 bitwise the C=1 launch; "
                         f"{len(FAST_GEOMS)} geometries bitwise")
            print(line)
    return worst


def _snr_db_words(torch, ref, test):
    """SNR of i16 IQ words ``test`` against ``ref``, in float64 on the card."""
    r = ref.view(torch.int16).double()
    d = r - test.view(torch.int16).double()
    return float(10 * torch.log10((r * r).sum() / (d * d).sum()))


def phase_probes(torch, gen):
    """The Q15 mixer and the roofline probes against their plain versions,
    bitwise, at the pipeline's chunk and at the tools' shape."""
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda import mixer, probes

    P, Q, L = 3, 64, 2048
    for B in (B_MAIN, B_BIG):
        plan = _plan(B, L)
        check((plan.t < L).any(), "plan words have no segment switch")
        p = nco.plan_tensor(plan, device="cuda")
        x = _data(torch, "i16", B, L, gen)

        got = mixer.mix_blocks_q15(x, p)
        torch.cuda.synchronize()
        same = torch.equal(got, mixer.mix_blocks_q15_plain(x, p))
        # against the exact mixer at moderate amplitudes (no saturation)
        pairs = torch.randint(-9000, 9000, (B, L, 2), dtype=torch.int16,
                              device="cuda", generator=gen)
        xm = pairs.view(torch.int32).reshape(B, L)
        q15, exact = mixer.mix_blocks_q15(xm, p), mixer.mix_blocks_fmt(xm, p)
        lsb = int(_lsb_diff(torch, q15, exact).max())
        snr = _snr_db_words(torch, exact, q15)
        print(f"probes: q15 B={B}: bitwise vs plain={same}; vs the exact mixer "
              f"kernel max LSB={lsb}, SNR {snr!r} dB")
        check(same, f"q15 mixer at B={B} differs from its plain version")
        check(lsb <= 2, f"q15 mixer at B={B} is {lsb} LSB from the exact mixer")

        for body in ("copy", "codec"):
            want = probes.probe_elementwise_plain(x, body=body)
            ok = {vec: torch.equal(probes.probe_elementwise(x, body=body, vec=vec), want)
                  for vec in (1, 4)}
            print(f"probes: {body} B={B}: bitwise vs plain at 4-byte accesses="
                  f"{ok[1]}, at 16-byte accesses={ok[4]}")
            check(all(ok.values()), f"{body} probe at B={B} differs from plain")

        tile = probes.chain_tile(B * L, P, Q)
        keep = tile * P // Q
        runs = {
            "chain-copy": (probes.chain_shape_run(x, p, P=P, Q=Q, do_mix=False),
                           probes.chain_shape_run_plain(x, p, P=P, Q=Q, do_mix=False)),
            "chain-mix": (probes.chain_shape_run(x, p, P=P, Q=Q, do_mix=True),
                          probes.chain_shape_run_plain(x, p, P=P, Q=Q, do_mix=True)),
            "mix-select": (probes.mix_shape_run(x, p, P=P, Q=Q, tone="select"),
                           probes.mix_shape_run_plain(x, p, P=P, Q=Q, tone="select")),
            "mix-fold": (probes.mix_shape_run(x, p, P=P, Q=Q, tone="fold"),
                         probes.mix_shape_run_plain(x, p, P=P, Q=Q, tone="fold")),
        }
        torch.cuda.synchronize()
        for name, (got, want) in runs.items():
            words, side = torch.equal(got[0], want[0]), torch.equal(got[1], want[1])
            print(f"probes: {name} B={B} tile={tile} keep={keep}: out "
                  f"{tuple(got[0].shape)} bitwise vs plain={words}, XOR side "
                  f"output {tuple(got[1].shape)} bitwise={side}")
            check(words and side, f"{name} probe at B={B} differs from plain")
        sel, fold, mix = runs["mix-select"][0], runs["mix-fold"][0], runs["chain-mix"][0]
        tones = torch.equal(sel[0], fold[0]) and torch.equal(sel[1], fold[1])
        sliced = torch.equal(
            mix[0], mixer.mix_blocks_fmt(x, p).reshape(-1, tile)[:, :keep])
        print(f"probes: B={B}: mix-select == mix-fold bitwise={tones}; chain-mix "
              f"words == the mixer kernel's, sliced alike={sliced}")
        check(tones, f"select and fold tones differ at B={B}")
        check(sliced, f"chain-mix differs from the mixer kernel's words at B={B}")
        del runs, sel, fold, mix, got, want
        torch.cuda.empty_cache()


def _capture(torch, n, seed, fs=FS, tones=((3000.0, 0.3, 0.0), (-7000.0, 0.2, 1.0))):
    """Tones ``(Hz, amplitude, phase)`` plus noise, made on the card, as LE
    i16 IQ bytes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.arange(n, dtype=torch.float64, device="cuda")
    re_ = torch.zeros(n, dtype=torch.float64, device="cuda")
    im_ = torch.zeros(n, dtype=torch.float64, device="cuda")
    for hz, amp, ph0 in tones:
        ph = torch.remainder(hz / fs * k, 1.0) * (2 * torch.pi) + ph0
        re_ += amp * torch.cos(ph)
        im_ += amp * torch.sin(ph)
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


def _golden_mixed_plan(raw, n_blocks, fs, shifts):
    """The mix of the first ``n_blocks`` blocks from the plan words, in
    float64: phase = the exact Q0.64 plan phase's top 24 bits (the host
    planner and ``ops.nco.phase_q24`` on the CPU), tone = numpy's float64
    exp.

    The reference's own sequential mix (``shift_frequency_oracle``) rounds
    ``ratio · samplenum`` to float32, so its phase noise grows with
    shift / rate, and a channel near half the sample rate resets its counter
    several times a block: :func:`phase_channel_slices` prints how far the
    sequential oracle is from this golden on the widest channels (under the
    70 dB bar on some).  Those channels are therefore held to the plan words
    (which the CPU tests pin bitwise to the JAX planner).  The planner does
    not vouch for itself: in every channels slice one channel with a small
    composed shift is held to the sequential oracle over the same blocks,
    and this golden is held to that oracle there too."""
    import numpy as np

    from doppler_tpu_torch import oracle
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

    plan = plan_blocks(list(shifts), [2048] * n_blocks, fs, NCOState(), 2048)
    q24 = nco.phase_q24(nco.plan_tensor(plan), 2048).numpy().reshape(-1)
    x = oracle.decode_i16_bytes(raw[:n_blocks * 2048 * 4]).astype(np.complex128)
    return (x * np.exp(-2j * np.pi * (q24 / float(1 << 24)))).astype(np.complex64)


def _track_scheduler(freq=FREQ):
    from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler

    tle = Tle.from_lines("TEST SAT", *_tle_lines())
    return TrackScheduler(Predictor(tle, Observer(58.26541, 26.46667, 76.0)),
                          freq, OFFSET, FS, START_UNIX, telemetry=False)


def _track_shifts(n_blocks):
    return _track_scheduler().shifts([2048] * n_blocks)


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
    """Each kernel's launch count: (wrapper, attribute).  A ``*_fast``
    count holds both pass counts of its source, ``*_default`` the one-pass
    launches among them."""
    from doppler_tpu_torch.ops.cuda import cascade, chain, mixer

    return {"mixer": (mixer.mix_blocks_fmt, "launches"),
            "chain": (chain.mix_resample_chain_stream, "launches"),
            "chain_fast": (chain.mix_resample_chain_stream, "launches_fast"),
            "chain_fast_default": (chain.mix_resample_chain_stream, "launches_default"),
            "cascade": (cascade.mix_cascade_stream, "launches"),
            "cascade_fast": (cascade.mix_cascade_stream, "launches_fast"),
            "cascade_fast_default": (cascade.mix_cascade_stream, "launches_default"),
            "mixer_channels": (mixer.mix_blocks_fmt_channels, "launches"),
            "chain_channels": (chain.mix_resample_chain_channels, "launches"),
            "chain_channels_fast": (chain.mix_resample_chain_channels, "launches_fast"),
            "chain_channels_fast_default": (chain.mix_resample_chain_channels,
                                            "launches_default"),
            "cascade_channels": (cascade.mix_cascade_channels, "launches")}


def _tool_counters():
    """The kernels that only the measuring tools launch."""
    from doppler_tpu_torch.ops.cuda import mixer, probes

    return {"mixer_q15": (mixer.mix_blocks_q15, "launches"),
            "probe_elementwise": (probes.probe_elementwise, "launches"),
            "chain_shape": (probes.chain_shape_run, "launches"),
            "mix_shape": (probes.mix_shape_run, "launches")}


def _zero_counts(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read_counts(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def _run_slice(name, argv, raw, card, channels=1):
    """One capture through ``cli.main`` on the card, with every launch count
    set to 0 just before and read just after.  ``channels`` scales the rate
    line of a channels run (its outputs go to ``--output-dir``)."""
    from doppler_tpu_torch import cli

    sink, log = _Sink(), io.StringIO()
    # the CLI's stderr handler binds the stream it first sees: drop it so
    # this run's handler writes to this run's log
    logger = logging.getLogger("doppler_tpu_torch")
    for h in list(logger.handlers):
        logger.removeHandler(h)
    _zero_counts(_counters())
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = cli.main(argv + ["--device", "cuda", "--log-format", "json"],
                      stdin=io.BytesIO(raw), stdout=sink)
    wall = time.perf_counter() - t0
    launches = _read_counts(_counters())
    check(rc == 0, f"{name}: cli.main returned {rc}: {log.getvalue()[-2000:]}")
    msgs = [json.loads(ln)["msg"] for ln in log.getvalue().splitlines()]
    done = [m for m in msgs if m.startswith("done:")]
    check(done, f"{name}: no 'done' line from the CLI")
    m = re.search(r"host plan\+stage ([0-9.]+) s, device span ([0-9.]+) s", done[-1])
    host_s, device_s = float(m.group(1)), float(m.group(2))
    n_in = len(raw) // 4
    msps = n_in / wall / 1e6
    print(f"slice {name}: launches {launches}")
    print(f"slice {name}: wall {wall!r} s, {msps!r} Msps in"
          + (f" x {channels} channels = {msps * channels!r} M channel-samples/s"
             if channels > 1 else "") + f" [{card}]")
    print(f"slice {name}: split host plan+stage {host_s!r} s, device span "
          f"{device_s!r} s (CUDA events around each chunk: copies, kernels and "
          f"the gaps while the host enqueues), other host {wall - host_s!r} s "
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
    for other, count in launches.items():
        if other not in (kernel, "mixer"):
            check(count == 0, f"{name}: {other} launched {count} times")
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
        # --precision fast leaves the cascade exact: the same bytes
        out_fast, launches, _, split = _run_slice(
            "default-fast", track + ["--precision", "fast"], raw, card)
        same = out_fast == out
        print(f"slice default-fast: bytes equal to the exact run's={same}")
        check(same and launches["cascade"] == N_SLICE // (B_MAIN * 2048)
              and launches["chain_fast"] == 0,
              "default-fast: the cascade under --precision fast is not the exact run")
        res["default-fast"] = dict(split, launches=launches)

        # (ii) the split route: ÷16·÷16 fused front, 384/3125 tail
        argv = ["const", "-s", str(FS_SPLIT), "-i", "i16", "--shift", str(OFFSET),
                "--resample-to", str(OUT_RATE)]
        out, launches, _, split = _run_slice("split", argv, raw5, card)
        ms5 = MultiStageResampler(FS_SPLIT, OUT_RATE)
        snr = _check_slice("split", out, N_SPLIT, ms5.out_count_for(N_SPLIT),
                           launches, "cascade", _golden(mixed5, ms5.stages))
        res["split"] = dict(split, launches=launches, snr_db=snr)

        # (iii) the single-stage chain, on the capture of (i)
        out, launches, _, split = _run_slice(
            "chain", track + ["--resample-stages", "single"], raw, card)
        rs = RationalResampler(FS, OUT_RATE)
        golden = _golden(mixed, [rs])
        snr = _check_slice("chain", out, N_SLICE, -(-N_SLICE * 3 // 64),
                           launches, "chain", golden)
        res["chain"] = dict(split, launches=launches, snr_db=snr)

        # (iii-fast) the same with --precision fast: the fast kernel, held
        # to (iii)'s golden and within 1 LSB of (iii)'s bytes
        out_fast, launches, _, split = _run_slice(
            "chain-fast", track + ["--resample-stages", "single", "--precision",
                                   "fast"], raw, card)
        snr = _check_slice("chain-fast", out_fast, N_SLICE, -(-N_SLICE * 3 // 64),
                           launches, "chain_fast", golden)
        d = _lsb_diff(torch, torch.frombuffer(bytearray(out_fast), dtype=torch.int32),
                      torch.frombuffer(bytearray(out), dtype=torch.int32))
        lsb, frac = int(d.max()), float((d > 0).float().mean())
        print(f"slice chain-fast: against (iii)'s bytes max LSB={lsb} frac={frac!r}")
        check(lsb <= 1, f"chain-fast: {lsb} LSB from the exact run")
        res["chain-fast"] = dict(split, launches=launches, snr_db=snr)
    return res


# -- channels mode ---------------------------------------------------------------

def _f32_sum(a, b):
    """f32(a) + f32(b) in float32: how a channel's shift and center compose."""
    import numpy as np

    return float(np.float32(a) + np.float32(b))


def _config4_channels():
    """BASELINE config 4: 16 TLE-tracked channels across a 1.024 Msps
    capture, 64 kHz apart, each at its own downlink frequency."""
    return [{"name": f"sat{k:02d}", "tlename": "TEST SAT",
             "frequency": FREQ + 25000.0 * k, "offset": OFFSET,
             "center_offset": -480000.0 + 64000.0 * k} for k in range(C_MAIN)]


def _config4_const_channels():
    """Config 4 as the conformance harness runs it (16 const channels)."""
    return [{"name": f"ch{k}", "shift": -40000.0 + 10000.0 * k,
             "center_offset": 1000.0 * k} for k in range(C_MAIN)]


def _config5_channels():
    """BASELINE config 5's width: 256 const channels across 100 Msps."""
    return [{"name": f"w{k:03d}", "shift": -39_876_543.0 + 311_111.0 * k}
            for k in range(C_WIDE)]


def _channel_shifts(ch, n_blocks):
    """Per-block composed shifts of one config entry, as the pipeline plans
    them: f32(scheduler) + f32(center)."""
    center = ch.get("center_offset", 0.0)
    if "shift" in ch:
        return [_f32_sum(ch["shift"], center)] * n_blocks
    sched = _track_scheduler(ch["frequency"])
    return [_f32_sum(s, center) for s in sched.shifts([2048] * n_blocks)]


def _run_channels_slice(name, tmp, channels, argv, raw, card, top=None):
    """One capture through ``cli.main(['channels', …])`` on the card; returns
    the per-channel output bytes, the launch counts and the timing split."""
    cfg = dict(top or {}, channels=channels)
    cfg_path = os.path.join(tmp, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_dir = os.path.join(tmp, name)
    _, launches, msgs, split = _run_slice(
        name, ["channels", "--config", cfg_path, "--output-dir", out_dir] + argv,
        raw, card, channels=len(channels))
    check(any(f"multi-channel mode: {len(channels)} channels" in m for m in msgs),
          f"{name}: the CLI did not report {len(channels)} channels")
    outs = []
    for ch in channels:
        with open(os.path.join(out_dir, ch["name"] + ".iq"), "rb") as f:
            outs.append(f.read())
    return outs, launches, split


def _check_channels_slice(name, outs, n_in, want_n, launches, want_launches,
                          goldens):
    """Exact length on every channel, the launch counts of the route, and
    SNR against every golden of ``goldens``: pairs ``(channel, which golden,
    its outputs)``."""
    import numpy as np

    from doppler_tpu_torch import oracle

    lengths = {len(o) // 4 for o in outs}
    print(f"slice {name}: {n_in} samples in -> {sorted(lengths)} out on "
          f"{len(outs)} channels (want {want_n})")
    check(lengths == {want_n}, f"{name}: output lengths {sorted(lengths)} != {want_n}")
    check(launches == want_launches,
          f"{name}: launches {launches}, want {want_launches}")
    worst = float("inf")
    for c, which, golden in goldens:
        got = oracle.decode_i16_bytes(outs[c][:len(golden) * 4])
        snr = oracle.snr_db(golden, got)
        rms = float(np.sqrt(np.mean(np.abs(golden) ** 2)))
        print(f"slice {name}: channel {c}: first {len(golden)} outputs vs the "
              f"{which} golden (rms {rms!r}): SNR {snr!r} dB")
        # an equal pair of silent signals would read as infinite SNR
        check(rms > 0.05, f"{name}: channel {c} golden holds no signal (rms {rms})")
        check(snr > 70.0, f"{name}: channel {c} SNR {snr} dB <= 70 dB")
        worst = min(worst, snr)
    return worst


def _launches(**counts):
    return dict({k: 0 for k in _counters()}, **counts)


def phase_channel_slices(torch, card):
    import numpy as np

    from doppler_tpu_torch import oracle
    from doppler_tpu_torch.ops.multistage import MultiStageResampler
    from doppler_tpu_torch.ops.resample import RationalResampler

    checked = (0, C_MAIN // 2, C_MAIN - 1)
    checked5 = (0, C_WIDE // 2, C_WIDE - 1)
    # the middle channels' composed shifts are small (under 0.05 of the
    # rate): they are held to the reference's sequential mix as well
    mid, mid5 = C_MAIN // 2, C_WIDE // 2
    cfg4, cfg4c, cfg5 = _config4_channels(), _config4_const_channels(), _config5_channels()
    # a tone 3 kHz above where each checked channel's shift brings DC from
    t0 = time.perf_counter()
    raw4 = _capture(torch, N_SLICE, seed=4, tones=[
        (_channel_shifts(cfg4[c], 1)[0] + 3000.0, 0.22, float(c)) for c in checked])
    raw5 = _capture(torch, N_WIDE, seed=6, fs=FS_SPLIT, tones=[
        (_channel_shifts(cfg5[c], 1)[0] + 5000.0, 0.22, float(c)) for c in checked5])
    print(f"slice: channel captures of {N_SLICE} and {N_WIDE} samples made in "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    mixed4 = {c: _golden_mixed_plan(raw4, GOLDEN_BLOCKS, FS,
                                     _channel_shifts(cfg4[c], GOLDEN_BLOCKS))
              for c in checked}
    mixed4c = {c: _golden_mixed_plan(raw4, GOLDEN_BLOCKS, FS,
                                      _channel_shifts(cfg4c[c], GOLDEN_BLOCKS))
               for c in checked}
    mixed5 = {c: _golden_mixed_plan(raw5, GOLDEN_BLOCKS, FS_SPLIT,
                                     _channel_shifts(cfg5[c], GOLDEN_BLOCKS))
              for c in checked5}
    print(f"slice: plan-word golden mixes of {GOLDEN_BLOCKS} blocks x9 in "
          f"{time.perf_counter() - t0:.1f} s")
    # the reference's sequential float32 mix over the same blocks: the middle
    # channel of each configuration, and the last (widest) of configs 4 and 5
    t0 = time.perf_counter()
    seq = {}
    for key, raw, fs, cfg, mixed, cs in (
            ("config 4", raw4, FS, cfg4, mixed4, (mid, C_MAIN - 1)),
            ("config 4 const", raw4, FS, cfg4c, mixed4c, (mid,)),
            ("config 5", raw5, FS_SPLIT, cfg5, mixed5, (mid5, C_WIDE - 1))):
        for c in cs:
            shifts = _channel_shifts(cfg[c], GOLDEN_BLOCKS)
            seq[key, c] = _golden_mixed(raw, GOLDEN_BLOCKS, fs, shifts)
            tie = oracle.snr_db(seq[key, c], mixed[c])
            print(f"slice: {key} channel {c} (shift / rate {shifts[0] / fs!r}): "
                  f"plan-word golden vs the sequential float32 oracle over "
                  f"{GOLDEN_BLOCKS} blocks of mixed samples: {tie!r} dB")
            if c in (mid, mid5):
                check(tie > 70.0, f"{key} channel {c}: the plan-word golden is "
                                  f"{tie} dB from the sequential oracle")
    print(f"slice: sequential golden mixes of {GOLDEN_BLOCKS} blocks x5 in "
          f"{time.perf_counter() - t0:.1f} s")

    def i16(y):
        return oracle.decode_i16_bytes(oracle.encode_i16_bytes(y.astype(np.complex64)))

    full = lambda n: n // (B_MAIN * 2048)                       # noqa: E731
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        top = {"tlefile": tle_path, "location": LOCATION,
               "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX))}
        io_args = ["-s", str(FS), "-i", "i16"]

        # (iv) config 4: 16 track channels -> 48 ksps, the default route
        ms = MultiStageResampler(FS, OUT_RATE)
        outs, launches, split = _run_channels_slice(
            "config4", tmp, cfg4, io_args + ["--resample-to", str(OUT_RATE)],
            raw4, card, top)
        snr = _check_channels_slice(
            "config4", outs, N_SLICE, ms.out_count_for(N_SLICE), launches,
            _launches(cascade_channels=full(N_SLICE), mixer_channels=1),
            [(c, "plan-word", _golden(mixed4[c], ms.stages)) for c in checked]
            + [(mid, "sequential", _golden(seq["config 4", mid], ms.stages))])
        res["config4"] = dict(split, launches=launches, snr_db=snr)

        # (v) its first 10 s through the single-stage chain
        rs = RationalResampler(FS, OUT_RATE)
        outs, launches, split = _run_channels_slice(
            "config4-chain", tmp, cfg4,
            io_args + ["--resample-to", str(OUT_RATE), "--resample-stages", "single"],
            raw4[:N_CH_CHAIN * 4], card, top)
        goldens_v = {c: _golden(mixed4[c], [rs]) for c in checked}
        snr = _check_channels_slice(
            "config4-chain", outs, N_CH_CHAIN, -(-N_CH_CHAIN * 3 // 64), launches,
            _launches(chain_channels=full(N_CH_CHAIN), mixer_channels=1),
            [(c, "plan-word", goldens_v[c]) for c in checked]
            + [(mid, "sequential", _golden(seq["config 4", mid], [rs]))])
        res["config4-chain"] = dict(split, launches=launches, snr_db=snr)

        # (v-fast) its first 5 s with --precision fast: the fast channel
        # kernel, held to (v)'s goldens and within 1 LSB of (v)'s bytes
        n_fast = full(N_CH_FAST) * B_MAIN * 2048 * 3 // 64
        outs_f, launches, split = _run_channels_slice(
            "config4-chain-fast", tmp, cfg4,
            io_args + ["--resample-to", str(OUT_RATE), "--resample-stages", "single",
                       "--precision", "fast"],
            raw4[:N_CH_FAST * 4], card, top)
        snr = _check_channels_slice(
            "config4-chain-fast", outs_f, N_CH_FAST, -(-N_CH_FAST * 3 // 64), launches,
            _launches(chain_channels_fast=full(N_CH_FAST), mixer_channels=1),
            [(c, "plan-word", goldens_v[c]) for c in checked])
        lsb = max(int(_lsb_diff(
            torch, torch.frombuffer(bytearray(f[:4 * n_fast]), dtype=torch.int32),
            torch.frombuffer(bytearray(o[:4 * n_fast]), dtype=torch.int32)).max())
            for f, o in zip(outs_f, outs))
        print(f"slice config4-chain-fast: the {n_fast} outputs of its full chunks "
              f"against (v)'s on every channel: max LSB={lsb}")
        check(lsb <= 1, f"config4-chain-fast: {lsb} LSB from the exact run")
        res["config4-chain-fast"] = dict(split, launches=launches, snr_db=snr)

        # (vi) 16 const channels, no resampler: the channel mixer alone
        outs, launches, split = _run_channels_slice(
            "config4-mix", tmp, cfg4c, io_args, raw4[:N_CH_MIX * 4], card)
        snr = _check_channels_slice(
            "config4-mix", outs, N_CH_MIX, N_CH_MIX, launches,
            _launches(mixer_channels=full(N_CH_MIX) + 1),
            [(c, "plan-word", i16(mixed4c[c])) for c in checked]
            + [(mid, "sequential", i16(seq["config 4 const", mid]))])
        res["config4-mix"] = dict(split, launches=launches, snr_db=snr)

        # (vii) config 5's rate and width on one card
        ms5 = MultiStageResampler(FS_SPLIT, OUT_RATE)
        outs, launches, split = _run_channels_slice(
            "config5", tmp, cfg5,
            ["-s", str(FS_SPLIT), "-i", "i16", "--resample-to", str(OUT_RATE)],
            raw5, card)
        snr = _check_channels_slice(
            "config5", outs, N_WIDE, ms5.out_count_for(N_WIDE), launches,
            _launches(cascade_channels=full(N_WIDE), mixer_channels=1),
            [(c, "plan-word", _golden(mixed5[c], ms5.stages)) for c in checked5]
            + [(mid5, "sequential", _golden(seq["config 5", mid5], ms5.stages))])
        res["config5"] = dict(split, launches=launches, snr_db=snr)
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


def _device_us(torch, fn, kernel_name, runs=10, tries=3):
    """Mean device time of the kernel whose name holds ``kernel_name`` over
    ``runs`` calls of ``fn``, from ``torch.profiler``; None when none of
    ``tries`` sessions holds such a kernel (a session can record none).
    ``kernel_name`` None: every device event of a call (kernels and
    copies), summed."""
    for _ in range(tries):
        us = _device_us_once(torch, fn, kernel_name, runs)
        if us is not None:
            return us
    return None


def _device_us_once(torch, fn, kernel_name, runs):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # an empty session first: records a previous session left behind land in
    # it, not in the one that is read (a kernel of the same name, timed just
    # before, would otherwise count here)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        on_device = getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
        # the port's kernels, not PyTorch's own (at::native::elementwise_kernel)
        ours = kernel_name is not None and kernel_name in ev.key and "at::native" not in ev.key
        if ours if kernel_name is not None else on_device:
            total += getattr(ev, "device_time_total", None) or getattr(
                ev, "cuda_time_total", 0.0)
            count += ev.count
    if kernel_name is None:
        return total / runs if total > 0 else None
    return total / count if count and total > 0 else None


def _device_text(dev_us, bound_ms):
    """A timing line's device-time clause, with the bound's share of it."""
    if dev_us is None:
        return "device not measured"
    return f"device {dev_us!r} us (the bound is {bound_ms * 1e3 / dev_us!r} of it)"


def _bound(C, B, L, stages, *, out_bytes=4, passes=0):
    """The least time the card could take: (ms, 'bytes' or 'operations').

    Bytes: the shared chunk (int32 words) and the plan words read once, each
    channel's output written once, banks and carries once.  Operations, in
    float32 outside the tensor cores: the mix (MIX_FLOP a sample) for every
    channel and 2 a sample to encode i16, each one instruction (the build's
    -fmad=false contracts none into an FMA) at F32_OPS_PER_S; and 4·T·P/Q per
    stage input sample (I and Q, an FMA counted as two) at F32_FLOP_PER_S.
    ``stages`` = () is the mixer.  ``passes`` (3: split3, 1: default): the
    dot is that many bf16 products a tap on the tensor cores instead, at
    their own rate, beside the float32 mix (the bank is read as its two bf16
    halves)."""
    n = B * L
    byts = 4 * n + 28 * C * B
    ops, fma, tensor = C * n * MIX_FLOP, 0, 0
    for P, Q, T in stages:
        dot = C * 4 * T * P * (n // Q)
        if passes:
            tensor += passes * dot
        else:
            fma += dot
        byts += 4 * P * T + 2 * C * 2 * 4 * (T - 1)
        n = n // Q * P
    byts += C * n * out_bytes
    if out_bytes == 4:
        ops += C * n * 2
    t_b = byts / HBM_BYTES_PER_S
    t_f = ops / F32_OPS_PER_S + fma / F32_FLOP_PER_S
    t_t = tensor / BF16_FLOP_PER_S
    return max(t_b, t_f, t_t) * 1e3, "bytes" if t_b >= max(t_f, t_t) else "operations"


def phase_timing_channels(torch, gen, card):
    """The channel-batched kernels at C = 16: events (plain, kernel, kernel,
    plain) and the profiler's device time.  (To time the other grid schedule,
    run the script once more on the same card with
    ``DOPPLER_NVCC_FLAGS=-DDOPPLER_CHANNEL_MAJOR`` and compare these lines.)"""
    from doppler_tpu_torch.ops.cuda import cascade, chain, mixer
    from doppler_tpu_torch.ops.resample import RationalResampler

    C, L = C_MAIN, 2048
    rs = RationalResampler(FS, OUT_RATE)
    chain_stage = ((rs.P, rs.Q, rs.T),)
    bank = torch.from_numpy(rs.bank).cuda()
    carry = torch.zeros(C, 2, rs.T - 1, device="cuda")
    _, c3, b3 = _cascade(torch, FS)
    z3 = tuple(torch.zeros(C, 2, T - 1, device="cuda") for _, _, T in c3)
    _, c5, b5 = _cascade(torch, FS_SPLIT)
    front = dict(stages=c5, outtype="f32", final_dense=True)
    ckw = dict(P=rs.P, Q=rs.Q, T=rs.T)
    res = {}
    for B in (B_MAIN, B_BIG):
        x = _data(torch, "i16", B, L, gen)
        p = _channel_plans(torch, C, B, L)
        # name -> (kernel, plain, kernel's name in a trace, stages)
        cases = {
            "mixer_channels": (
                lambda: mixer.mix_blocks_fmt_channels(x, p),
                lambda: mixer.mix_blocks_fmt_channels_plain(x, p),
                "mixer_kernel", ()),
            "chain_channels": (
                lambda: chain.mix_resample_chain_channels(x, p, bank, carry, **ckw),
                lambda: chain.mix_resample_chain_channels_plain(x, p, bank, carry, **ckw),
                "chain_kernel", chain_stage),
            "chain_channels_fast": (
                lambda: chain.mix_resample_chain_channels(x, p, bank, carry,
                                                          dot_precision="split3", **ckw),
                lambda: chain.mix_resample_chain_channels_plain(
                    x, p, bank, carry, dot_precision="split3", **ckw),
                "chain_fast_kernel", chain_stage),
            "chain_channels_fast_default": (
                lambda: chain.mix_resample_chain_channels(x, p, bank, carry,
                                                          dot_precision="default", **ckw),
                lambda: chain.mix_resample_chain_channels_plain(
                    x, p, bank, carry, dot_precision="default", **ckw),
                "chain_fast_kernel", chain_stage),
            "cascade_channels": (
                lambda: cascade.mix_cascade_channels(x, p, b3, z3, stages=c3),
                lambda: cascade.mix_cascade_channels_plain(x, p, b3, z3, stages=c3),
                "cascade_kernel", c3),
        }
        runs = 20 if B == B_MAIN else 3       # the big plain versions take seconds
        for name, (kern, plain, trace_name, stages) in cases.items():
            fast = "_fast" in name
            if fast and B == B_BIG:
                # its plain version takes ≈ 2 s a call: one call, no warm-up
                pl_a = pl_b = _median_ms(torch, plain, runs=1, warmup=0)
            else:
                pl_a = _median_ms(torch, plain, runs=runs, warmup=1)
            k_a = _median_ms(torch, kern)
            k_b = _median_ms(torch, kern)
            if not (fast and B == B_BIG):
                pl_b = _median_ms(torch, plain, runs=runs, warmup=1)
            dev_us = _device_us(torch, kern, trace_name)
            bound_ms, by = _bound(C, B, L, stages, passes=(
                1 if name.endswith("_default") else 3) if fast else 0)
            k_ms, pl_ms = min(k_a, k_b), min(pl_a, pl_b)
            n = C * B * L
            dev = "not measured" if dev_us is None else f"{dev_us!r} us"
            share = "" if dev_us is None else (
                f" = {bound_ms * 1e3 / dev_us!r} of the device time")
            print(f"timing: {name} i16->i16 C={C} B={B} ({n} channel-samples): "
                  f"kernel {k_a!r}/{k_b!r} ms, plain {pl_a!r}/{pl_b!r} ms; "
                  f"device {dev}; "
                  f"{n / k_ms / 1e6!r} G channel-samples/s; bound {bound_ms!r} ms "
                  f"({by}){share} [{card}]")
            res[(name, B)] = (k_ms, pl_ms, bound_ms, by)
    # the channel mixer over its channel groups G at C = 16, at the CLI's
    # chunk and at B = 16384, then at config 5's width, C = 256 (at B = 16384
    # its plan words are the C = 16 set 16 times over: the same work, and
    # 34 GB of output)
    from doppler_tpu_torch.ops.cuda import build
    from doppler_tpu_torch.runtime.timing import timed_dispatches

    for B in (B_MAIN, B_BIG):
        x = _data(torch, "i16", B, L, gen)
        p = _channel_plans(torch, C, B, L)
        sweep = {}
        for G in (16, 8, 4, 2, 1):  # 8 launches back to back, best of 3; device
            step = lambda G=G: mixer._launch(x, p, C, B, L, "i16", "i16", G=G)  # noqa: E731
            step()
            sweep[G] = (min(timed_dispatches(step, 8) for _ in range(3)) / 8 * 1e6,
                        _device_us(torch, step, "mixer_kernel"))
        print(f"timing: mixer_channels C={C} B={B} us a launch by channels a CTA G "
              f"(picked {build.load().doppler_mixer_group(C, B, L)}): (8 back to back "
              f"between CUDA events, device) {sweep} [{card}]")
        res[("mixer G sweep", B)] = sweep
    for B in (B_MAIN, B_BIG):
        x = _data(torch, "i16", B, L, gen)
        p = (_channel_plans(torch, C_WIDE, B, L, fs=FS_SPLIT) if B == B_MAIN
             else _channel_plans(torch, C, B, L).repeat(1, C_WIDE // C, 1))
        kern = lambda: mixer.mix_blocks_fmt_channels(x, p)  # noqa: E731
        k_ms = min(_median_ms(torch, kern, runs=10), _median_ms(torch, kern, runs=10))
        if B == B_MAIN:
            plain = lambda: mixer.mix_blocks_fmt_channels_plain(x, p)  # noqa: E731
            pl_ms = _median_ms(torch, plain, runs=1, warmup=0)
        else:
            pl_ms = None
        dev_us = _device_us(torch, kern, "mixer_kernel")
        bound_ms, by = _bound(C_WIDE, B, L, ())
        n = C_WIDE * B * L
        print(f"timing: mixer_channels i16->i16 C={C_WIDE} B={B} ({n} channel-samples): "
              f"kernel {k_ms!r} ms, plain {'not run' if pl_ms is None else repr(pl_ms) + ' ms'}; "
              f"{_device_text(dev_us, bound_ms)}; G={build.load().doppler_mixer_group(C_WIDE, B, L)}; "
              f"bound {bound_ms!r} ms ({by}) [{card}]")
        res[("mixer_channels_256", B)] = (k_ms, pl_ms, bound_ms, by, dev_us)
        del x, p
    torch.cuda.empty_cache()
    # the config-5 front at its own width: C = 256, B = 256, float32 planes
    x = _data(torch, "i16", B_MAIN, L, gen)
    p5 = _channel_plans(torch, C_WIDE, B_MAIN, L, fs=FS_SPLIT)
    z5 = tuple(torch.zeros(C_WIDE, 2, T - 1, device="cuda") for _, _, T in c5)
    wide = lambda: cascade.mix_cascade_channels(x, p5, b5, z5, **front)  # noqa: E731
    k_ms = min(_median_ms(torch, wide), _median_ms(torch, wide))
    dev_us = _device_us(torch, wide, "cascade_kernel")
    bound_ms, by = _bound(C_WIDE, B_MAIN, L, c5, out_bytes=8)
    n = C_WIDE * B_MAIN * L
    dev = "not measured" if dev_us is None else f"{dev_us!r} us"
    print(f"timing: split front i16->f32 C={C_WIDE} B={B_MAIN} ({n} "
          f"channel-samples, {B_MAIN * L / FS_SPLIT * 1e3!r} ms of capture): kernel "
          f"{k_ms!r} ms; device {dev}; {n / k_ms / 1e6!r} G channel-samples/s; "
          f"bound {bound_ms!r} ms ({by}) [{card}]")
    return res


def phase_timing(torch, gen, card):
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda.cascade import (
        launch_fast_part as cascade_part,
        mix_cascade_plain,
        mix_cascade_stream,
    )
    from doppler_tpu_torch.ops.cuda.chain import (
        launch_fast_part,
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
            "chain_fast": (lambda: mix_resample_chain_stream(
                               x, p, bank, carry, P=3, Q=64, T=rs.T, dot_precision="split3"),
                           lambda: mix_resample_chain_plain(
                               x, p, bank, carry, P=3, Q=64, T=rs.T, dot_precision="split3")),
            "cascade": (lambda: mix_cascade_stream(x, p, b3, z3, stages=c3),
                        lambda: mix_cascade_plain(x, p, b3, z3, stages=c3)),
            "chain_fast_default": (lambda: mix_resample_chain_stream(
                                       x, p, bank, carry, P=3, Q=64, T=rs.T,
                                       dot_precision="default"),
                                   lambda: mix_resample_chain_plain(
                                       x, p, bank, carry, P=3, Q=64, T=rs.T,
                                       dot_precision="default")),
            "cascade_fast": (lambda: mix_cascade_stream(x, p, b3, z3, stages=c3,
                                                        dot_precision="split3"),
                             lambda: mix_cascade_plain(x, p, b3, z3, stages=c3,
                                                       dot_precision="split3")),
            "cascade_fast_default": (
                lambda: mix_cascade_stream(x, p, b3, z3, stages=c3,
                                           dot_precision="default"),
                lambda: mix_cascade_plain(x, p, b3, z3, stages=c3,
                                          dot_precision="default")),
        }
        p5 = nco.plan_tensor(_plan(B, L, fs=FS_SPLIT), device="cuda")
        pairs["split front"] = (
            lambda: mix_cascade_stream(x, p5, b5, z5, **front),
            lambda: mix_cascade_plain(x, p5, b5, z5, **front))
        trace_names = {"mixer": "mixer_kernel", "chain": "chain_kernel",
                       "chain_fast": "chain_fast_kernel",
                       "chain_fast_default": "chain_fast_kernel",
                       "cascade": "cascade_kernel", "split front": "cascade_kernel",
                       "cascade_fast": "cascade_fast_kernel",
                       "cascade_fast_default": "cascade_fast_kernel"}
        passes = {"chain_fast": 3, "chain_fast_default": 1, "cascade_fast": 3,
                  "cascade_fast_default": 1}
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the first of each pair warms up
            runs = 5 if name in passes and B == B_BIG else 20
            pl_a = _median_ms(torch, plain, runs=runs)
            k_a = _median_ms(torch, kern)
            k_b = _median_ms(torch, kern)
            pl_b = _median_ms(torch, plain, runs=runs)
            k_ms, pl_ms = min(k_a, k_b), min(pl_a, pl_b)
            # HBM bytes per input sample: words in, words or planes out
            bpi = {"mixer": 8.0, "split front": 4.0 + 8.0 / 256}.get(
                name, 4.0 + 4.0 * 3 / 64)
            fmt = "i16->f32" if name == "split front" else "i16->i16"
            stages = {"mixer": (), "chain": ((3, 64, rs.T),),
                      "chain_fast": ((3, 64, rs.T),),
                      "chain_fast_default": ((3, 64, rs.T),), "cascade": c3,
                      "split front": c5, "cascade_fast": c3,
                      "cascade_fast_default": c3}[name]
            bound_ms, by = _bound(1, B, L, stages,
                                  out_bytes=8 if name == "split front" else 4,
                                  passes=passes.get(name, 0))
            dev_us = _device_us(torch, kern, trace_names[name])
            print(f"timing: {name} {fmt} B={B} ({n} samples): kernel "
                  f"{k_a!r}/{k_b!r} ms, plain {pl_a!r}/{pl_b!r} ms; "
                  f"{_device_text(dev_us, bound_ms)}; kernel "
                  f"{n / k_ms / 1e6!r} GS/s, {n * bpi / k_ms / 1e6!r} GB/s; "
                  f"bound {bound_ms!r} ms ({by}) [{card}]")
            res[(name, B)] = (k_ms, pl_ms, bound_ms, by)
        # the split kernel's halves alone: the dot cut, then the mix cut
        parts = {part: _device_us(torch, lambda part=part: launch_fast_part(
                     x, p, bank, carry, P=3, Q=64, T=rs.T, part=part), "chain_fast_kernel")
                 for part in ("mix", "dot")}
        whole = _device_us(torch, pairs["chain_fast"][0], "chain_fast_kernel")
        res[("chain_fast split", B)] = (whole, parts["mix"], parts["dot"])
        print(f"timing: chain_fast split B={B}: device whole {whole!r} us, mix only "
              f"(the dot cut) {parts['mix']!r} us, dot only (the mix cut: a span of "
              f"zeros) {parts['dot']!r} us [{card}]")
        # the same for the split3 cascade: the dots cut, then the mix cut
        parts = {part: _device_us(torch, lambda part=part: cascade_part(
                     x, p, b3, z3, stages=c3, part=part), "cascade_fast_kernel")
                 for part in ("mix", "dot")}
        whole = _device_us(torch, pairs["cascade_fast"][0], "cascade_fast_kernel")
        res[("cascade_fast split", B)] = (whole, parts["mix"], parts["dot"])
        print(f"timing: cascade_fast split B={B}: device whole {whole!r} us, mix only "
              f"(the dots cut) {parts['mix']!r} us, dots only (the mix cut: a stage-0 "
              f"span of zeros) {parts['dot']!r} us [{card}]")
    return res


def _bound_probe(n, bytes_moved, ops_per_sample):
    """:func:`_bound`'s rule for a probe over n samples (its operations are
    the mix's and the codec's, none of them an FMA)."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = n * ops_per_sample / F32_OPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def _dispatch_ms(torch, steps, K=16, iters=5):
    """Best ms a call of each of ``steps`` (name -> callable) over ``iters``
    rounds of K back-to-back calls between two CUDA events
    (``runtime/timing.py``), the steps in turns within each round."""
    from doppler_tpu_torch.runtime.timing import timed_dispatches

    for step in steps.values():
        step()
    torch.cuda.synchronize()
    best = dict.fromkeys(steps, float("inf"))
    for _ in range(iters):
        for name, step in steps.items():
            best[name] = min(best[name], timed_dispatches(step, K) / K * 1e3)
    return best


def phase_timing_probes(torch, gen, card):
    """The Q15 mixer and the probes: events (plain, kernel, kernel, plain),
    the profiler's device time, the bound, and the library's ``copy_`` beside
    the two copy probes (timed here, used nowhere in the package)."""
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda import mixer, probes

    P, Q, L = 3, 64, 2048
    res = {}
    for B in (B_MAIN, B_BIG):
        n = B * L
        x = _data(torch, "i16", B, L, gen)
        p = nco.plan_tensor(_plan(B, L), device="cuda")
        tile = probes.chain_tile(n, P, Q)
        keep, n_tiles = tile * P // Q, n // tile
        flat_out = torch.empty_like(x)
        tiles_out = torch.empty((n_tiles, keep), dtype=torch.int32, device="cuda")
        x_tiles = x.reshape(n_tiles, tile)
        shape_bytes = 4 * n + 4 * n_tiles * keep + 4 * n_tiles
        enc = MIX_FLOP + 2                      # every sample is encoded
        kw = dict(P=P, Q=Q)
        # name -> (kernel, plain, library call or None, trace name, bound)
        cases = {
            "mixer_q15": (lambda: mixer.mix_blocks_q15(x, p),
                          lambda: mixer.mix_blocks_q15_plain(x, p), None,
                          "mixer_q15_kernel", _bound(1, B, L, ())),
            "copy": (lambda: probes.probe_elementwise(x),
                     lambda: probes.probe_elementwise_plain(x),
                     lambda: flat_out.copy_(x), "elementwise_kernel",
                     _bound_probe(n, 8 * n, 0)),
            "copy-v4": (lambda: probes.probe_elementwise(x, vec=4),
                        lambda: probes.probe_elementwise_plain(x),
                        lambda: flat_out.copy_(x), "elementwise_kernel",
                        _bound_probe(n, 8 * n, 0)),
            "codec": (lambda: probes.probe_elementwise(x, body="codec"),
                      lambda: probes.probe_elementwise_plain(x, body="codec"),
                      None, "elementwise_kernel", _bound_probe(n, 8 * n, 6)),
            "codec-v4": (lambda: probes.probe_elementwise(x, body="codec", vec=4),
                         lambda: probes.probe_elementwise_plain(x, body="codec"),
                         None, "elementwise_kernel", _bound_probe(n, 8 * n, 6)),
            "chain-copy": (lambda: probes.chain_shape_run(x, p, do_mix=False, **kw),
                           lambda: probes.chain_shape_run_plain(x, p, do_mix=False, **kw),
                           lambda: tiles_out.copy_(x_tiles[:, :keep]),
                           "chain_shape_kernel", _bound_probe(n, shape_bytes, 0)),
            "chain-mix": (lambda: probes.chain_shape_run(x, p, do_mix=True, **kw),
                          lambda: probes.chain_shape_run_plain(x, p, do_mix=True, **kw),
                          None, "chain_shape_kernel",
                          _bound_probe(n, shape_bytes + 28 * B, enc)),
            "mix-fold": (lambda: probes.mix_shape_run(x, p, tone="fold", **kw),
                         lambda: probes.mix_shape_run_plain(x, p, tone="fold", **kw),
                         None, "chain_shape_kernel",
                         _bound_probe(n, shape_bytes + 28 * B, enc)),
            "mix-select": (lambda: probes.mix_shape_run(x, p, tone="select", **kw),
                           lambda: probes.mix_shape_run_plain(x, p, tone="select", **kw),
                           None, "chain_shape_kernel",
                           _bound_probe(n, shape_bytes + 28 * B, enc)),
        }
        for name, (kern, plain, library, trace_name, (bound_ms, by)) in cases.items():
            pl_a = _median_ms(torch, plain)
            k_a = _median_ms(torch, kern)
            k_b = _median_ms(torch, kern)
            pl_b = _median_ms(torch, plain)
            lib_ms = None if library is None else min(
                _median_ms(torch, library), _median_ms(torch, library))
            dev_us = _device_us(torch, kern, trace_name)
            lib_us = None if library is None else _device_us(torch, library, None)
            k_ms, pl_ms = min(k_a, k_b), min(pl_a, pl_b)
            lib = "none" if lib_ms is None else f"{lib_ms!r} ms (device {lib_us!r} us)"
            print(f"timing: {name} B={B} ({n} samples): kernel {k_a!r}/{k_b!r} ms, "
                  f"plain {pl_a!r}/{pl_b!r} ms, library call {lib}; "
                  f"{_device_text(dev_us, bound_ms)}; bound {bound_ms!r} ms ({by}) "
                  f"[{card}]")
            res[(name, B)] = (k_ms, pl_ms, bound_ms, by, lib_ms)
        # the elementwise probe and the library's copy by one timer: K calls
        # back to back into a buffer the caller owns, in turns
        steps = {"torch-copy": lambda: flat_out.copy_(x)}
        for name, body, vec in (("copy", "copy", 1), ("copy-v4", "copy", 4),
                                ("codec", "codec", 1), ("codec-v4", "codec", 4)):
            steps[name] = (lambda body=body, vec=vec: probes.probe_elementwise(
                x, body=body, vec=vec, out=flat_out))
        disp = _dispatch_ms(torch, steps, iters=10)
        bound_ms = _bound_probe(n, 8 * n, 0)[0]
        print(f"timing: dispatch B={B} ({n} words, 16 calls between two events, "
              f"best of 10): " + ", ".join(
                  f"{name} {ms!r} ms ({bound_ms / ms!r} of the byte bound)"
                  for name, ms in disp.items()) + f" [{card}]")
        res[("dispatch", B)] = disp
    return res


def phase_conformance():
    """The five BASELINE configs through ``python -m doppler_tpu_torch
    --device cuda`` subprocesses against the golden model."""
    from doppler_tpu_torch.tools import conformance

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = conformance.main(["--device", "cuda"])
    secs = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        print(f"conformance: {line}")
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    for cfg in res["configs"]:
        print(f"conformance: {cfg['name']}: SNR {cfg['snr_db']} dB ok={cfg['ok']}")
    print(f"conformance: {res['conformance']} in {secs:.1f} s")
    check(rc == 0 and res["conformance"] == "pass" and len(res["configs"]) == 5
          and all(c["ok"] for c in res["configs"]), "conformance failed")
    return res


def phase_roofline(card):
    """The measuring tools in process at the bench shape, with every launch
    count set to 0 just before and read just after."""
    from doppler_tpu_torch.tools import (
        probe_cascade_precision,
        probe_chain_precision,
        probe_split_tail,
        roofline,
    )

    counters = dict(_counters(), **_tool_counters())
    _zero_counts(counters)
    size = ["--samples", str(B_BIG * 2048), "--dispatches", "16", "--iters", "4"]
    names = roofline.MIXER_SHAPED + roofline.CHAIN_SHAPED
    results = {}
    for tool, argv in ((roofline, size + ["--variants", ",".join(names)]),
                       (probe_chain_precision, size), (probe_cascade_precision, size),
                       (probe_split_tail, size)):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tool.main(argv)
        tag = tool.__name__.rsplit(".", 1)[-1]
        for line in err.getvalue().splitlines():
            if not line.startswith("device:"):
                print(f"{tag}: {line}" + ("" if line.endswith("]") else f" [{card}]"))
        check(rc == 0, f"{tag} returned {rc}")
        results[tag] = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"{tag}: {json.dumps(results[tag])}")
    check(list(results["roofline"]) == list(names), "roofline left a variant out")
    check(list(results["probe_chain_precision"]) == list(probe_chain_precision.VARIANTS),
          "probe_chain_precision left a variant out")
    check(list(results["probe_cascade_precision"])
          == list(probe_cascade_precision.VARIANTS),
          "probe_cascade_precision left a variant out")
    tail = results["probe_split_tail"]
    check(0.0 < tail["tail_share"] < 1.0, f"probe_split_tail: {tail}")
    print(f"probe_split_tail: the 384/3125 tail takes {tail['tail_share']!r} of "
          f"the split route's chunk ({tail['full_ms'] / 16!r} against "
          f"{tail['front_ms'] / 16!r} ms a dispatch of {B_BIG * 2048} samples) "
          f"[{card}]")
    launches = _read_counts(counters)
    print(f"roofline: launches {launches}")
    for name in list(_tool_counters()) + ["mixer", "chain", "chain_fast", "cascade",
                                          "chain_fast_default", "cascade_fast",
                                          "cascade_fast_default"]:
        check(launches[name] >= 1, f"the tools did not launch the {name} kernel")
    check(launches["cascade_fast"] > launches["cascade_fast_default"],
          "the tools did not launch the split3 cascade")
    return results, launches


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
    def timed(phase, *args):
        t0 = time.perf_counter()
        res = phase(*args)
        print(f"phase {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return res

    try:
        card = phase_device(torch)
        timed(phase_build)
        gen = torch.Generator(device="cuda").manual_seed(0)
        mix_err = timed(phase_mixer, torch, gen)
        chain_err = timed(phase_chain, torch, gen)
        cascade_err = timed(phase_cascade, torch, gen)
        channel_err = timed(phase_channels, torch, gen)
        fast_err = timed(phase_chain_fast, torch, gen)
        cfast_err = timed(phase_cascade_fast, torch, gen)
        timed(phase_probes, torch, gen)
        slices = timed(phase_slices, torch, card)
        slices.update(timed(phase_channel_slices, torch, card))
        timed(phase_conformance)
        times = timed(phase_timing, torch, gen, card)
        times.update(timed(phase_timing_channels, torch, gen, card))
        probe_times = timed(phase_timing_probes, torch, gen, card)
        _, tool_launches = timed(phase_roofline, card)
        if "jax" in sys.modules:
            raise Failed("jax was imported")
    except Exception as e:      # every failure ends the run non-zero
        traceback.print_exc()
        print(f"FAIL: {e}")
        return 1
    def entry(name, source, replaces, launches, err, **more):
        # ms, plain_ms and bound_ms at B = 256 (C = 16 for the channel
        # kernels), i16 -> i16; no single PyTorch call computes any of these
        # functions, so there is no library time
        ms, plain_ms, bound_ms, by = times[(name, B_MAIN)]
        return dict({"name": name, "route": "cuda",
                     "source": f"doppler_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by, "library_ms": None},
                    **more)

    def probe_entry(name, source, replaces, variant, **others):
        # at B = 16384, the tools' shape; every comparison of phase 4d is
        # bitwise, so the error is 0; `others` are further variants of the
        # same kernel, by their tool names
        ms, plain_ms, bound_ms, by, lib_ms = probe_times[(variant, B_BIG)]
        return dict({"name": name, "route": "cuda",
                     "source": f"doppler_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": tool_launches[name],
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
                     "variant": variant},
                    **{key: probe_times[(v, B_BIG)][0] for key, v in others.items()})

    default, config4 = slices["default"]["launches"], slices["config4"]["launches"]
    dispatch = probe_times[("dispatch", B_BIG)]
    kernels = [
        entry("mixer", "mixer.cu", "doppler_tpu/ops/pallas/mixer.py:227",
              default["mixer"], mix_err,
              launches_channels=slices["config4-mix"]["launches"]["mixer_channels"]),
        entry("chain", "chain.cu", "doppler_tpu/ops/pallas/chain.py:404",
              slices["chain"]["launches"]["chain"], chain_err),
        entry("cascade", "cascade.cu", "doppler_tpu/ops/pallas/chain.py:960",
              default["cascade"], cascade_err),
        entry("chain_channels", "chain.cu", "doppler_tpu/ops/pallas/chain.py:556",
              slices["config4-chain"]["launches"]["chain_channels"],
              channel_err["chain"]),
        entry("chain_fast", "chain_fast.cu", "doppler_tpu/ops/pallas/chain.py:404",
              slices["chain-fast"]["launches"]["chain_fast"], fast_err["stream"],
              branch="dot_precision='split3'"),
        entry("chain_channels_fast", "chain_fast.cu",
              "doppler_tpu/ops/pallas/chain.py:556",
              slices["config4-chain-fast"]["launches"]["chain_channels_fast"],
              fast_err["channels"], branch="dot_precision='split3'"),
        entry("cascade_channels", "cascade.cu",
              "doppler_tpu/ops/pallas/chain.py:1078",
              config4["cascade_channels"], channel_err["cascade"]),
        # the branches no CLI path reaches (the JAX CLI's cascades pass
        # 'highest'): their launches are the tools' path's, phase 6b
        entry("chain_fast_default", "chain_fast.cu",
              "doppler_tpu/ops/pallas/chain.py:404",
              tool_launches["chain_fast_default"], cfast_err["chain default"],
              branch="dot_precision='default'"),
        entry("cascade_fast", "cascade_fast.cu",
              "doppler_tpu/ops/pallas/chain.py:960",
              tool_launches["cascade_fast"] - tool_launches["cascade_fast_default"],
              cfast_err["split3"], branch="dot_precision='split3'"),
        entry("cascade_fast_default", "cascade_fast.cu",
              "doppler_tpu/ops/pallas/chain.py:960",
              tool_launches["cascade_fast_default"], cfast_err["default"],
              branch="dot_precision='default'"),
        probe_entry("mixer_q15", "mixer_q15.cu",
                    "doppler_tpu/ops/pallas/mixer.py:357", "mixer_q15"),
        # its times and the library's copy by one timer (phase_timing_probes)
        dict(probe_entry("probe_elementwise", "probes.cu", "tools/roofline.py:130",
                         "copy"),
             ms=dispatch["copy"], library_ms=dispatch["torch-copy"],
             ms_copy_v4=dispatch["copy-v4"], ms_codec=dispatch["codec"],
             ms_codec_v4=dispatch["codec-v4"]),
        probe_entry("chain_shape", "probes.cu", "tools/roofline.py:262",
                    "chain-copy", ms_chain_mix="chain-mix"),
        probe_entry("mix_shape", "probes.cu",
                    "tools/probe_chain_precision.py:190", "mix-fold",
                    ms_mix_select="mix-select"),
    ]
    for k in kernels:
        if k["launches"] < 1:
            print(f"FAIL: kernel {k['name']} was not launched on its slice")
            return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
