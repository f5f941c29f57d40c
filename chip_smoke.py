#!/usr/bin/env python3
"""Smoke test of doppler_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (each prints one line or a few; any failure exits non-zero):

1. device  — ``nvidia-smi`` name and power limit, torch's CUDA version.
2. build   — compiles ``doppler_tpu_torch/csrc`` with nvcc (sm_90a); the
             mixer's SASS instructions a channel-sample (``cuobjdump``); the
             chain-shaped mix probe's (modes 1 and 2, the instance the
             tools' shape launches): its loop's static SASS a sample, its
             registers and its occupancy (``--dump-resource-usage``).
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
4g. conv  — the banded-matmul resampler kernel (``csrc/conv.cu``, the
             ``--resample-impl conv`` product) at config 3's chunk (P/Q =
             3/64, T = 370, 524288 inputs) mid-stream: against its plain
             version on the card (cuBLAS, TF32 off), its CPU twin and the
             window kernel, float32 within 1e-5 of the peak and ≤ 1 LSB in
             under 1% after encode; the stream bitwise at two chunk widths
             and one-shot (and whether the cuBLAS form is, printed); the
             refusal of TF32 matmuls; then the window kernel
             (``csrc/window.cu``, the window resampler on the card) against
             its plain version ``window_dot``, within 2^-20; then both
             kernels against their plain versions at the split tail (P/Q =
             384/3125, the rows paths) at C = 1 and 256, at the same
             tolerances; then both kernels' bytes at every resampler case of
             ``tools/kernel_digests.py`` (config 3 at the chunk, at 2^24,
             mid-stream, 16 strided channels, both edges; the cascade's
             stages; the split tail at C = 1 and 256) against the SHA-256
             digests pinned before their redesign.
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
             48 ksps, 0.1 s (the ÷256 front batched, the 384/3125 tail
             through the window kernel, all 256 channels in one launch a
             chunk).  Exact output lengths on every channel, launch
             counts, and SNR against the golden model (on the first, the
             middle and the last channel from the plan words, and on the
             middle channel from the reference's sequential mix as well).
             With ``--precision fast``: (i) again, whose bytes must be (i)'s
             (the cascade stays exact); (iii-fast) (iii) through the fast
             kernel, against (iii)'s golden and within 1 LSB of (iii)'s
             bytes; (v-fast) the first 5 s of (v) through the fast channel
             kernel, against (v)'s goldens and within 1 LSB of (v)'s bytes.
5c. distributed — the host split: in process, each route's seek at the
             CLI's chunk (the config-3 captures of slices (i), (iii),
             (iii-fast), the split route's of (ii), and the mixer route at
             8000-byte blocks, where nothing fuses), with the launch counts
             set to 0 before the seek and before the seeked run: the replay
             launches one kernel of its route (a 1-block chain, a
             zero-prepadded cascade, the mixer), its FIR state is bitwise the
             state the stream holds at the seek point, and the two halves'
             bytes are the whole run's.  Then ``python -m doppler_tpu_torch
             … --distributed coordinator=127.0.0.1:PORT,num_processes=2,
             process_id=K`` on this card: (i), (iii) and (ii) split by byte
             range, config 4's first 5 s split by channel; the concatenated
             parts (the channel files) against the one-process bytes, the
             walls of both and of (i) in one fresh process;
             ``--prefetch-chunks 2`` against (i)'s bytes.
5d. mesh  — ``--mesh`` on this card, every shard on cuda:0
             (``make_mesh(devices=[cuda:0] × n)``), the pipelines built as
             the CLI builds them, in process: config 3's default route
             (cascade) and ``--resample-stages single`` (chain) at time=4,
             config 1 (f32 → i16, mix only) at time=4, the 100 Msps split
             route at time=2, config 4 (16 track channels) and config 5's
             rate × 256 channels at time=2 × channel=2, on the captures of
             phase 5; each against the unsharded bytes (phase 5's CLI run
             where there is one, and an unsharded in-process run, whose
             wall is printed beside the mesh's), and each full chunk's
             launches: one a shard plus one replay for every time shard
             k > 0 (chain, cascade), one a shard (mixer).  Then the CLI
             with ``--mesh time=1`` (slice (i)'s bytes) and with one shard
             more than the machine has cards (exit 1, "need N devices,
             have M").
5e. unfused — slice (iii) with ``--impl xla``: (iii)'s bytes, the mixer
             once a chunk and no chain launch; with ``--impl xla
             --resample-impl conv``: the conv kernel once a chunk, > 70 dB
             against (iii)'s golden, ≤ 1 LSB in under 1% from (iii)'s bytes;
             then that route in process over ``--mesh time=2`` on
             ``[cuda:0] × 2``: the unsharded conv bytes.
5f. native — the native host library's build seconds; slices (i) and (iv)
             in process with the track predictors' ``use_native`` on and
             off: phase 5's bytes both ways, ``host_s`` and the schedulers'
             seconds (the SGP4 curve and the staircase) of each.
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
             at C = 16 and at C = 256; beside the chain-shaped mixes at
             B = 16384 phase 2's loop SASS a sample, registers, occupancy
             and issue floor (that count over the SMs × 128 instructions a
             clock at the card's highest SM clock).
6b. roofline — the launch counts set to 0, then
             ``doppler_tpu_torch.tools.roofline.main`` (all variants),
             ``…probe_chain_precision.main`` (its ``def`` variant included),
             ``…probe_cascade_precision.main`` (exact, fast, def) and
             ``…probe_split_tail.main`` (full, front: the tail's share) in
             process at 33,554,432 samples; every variant's line; then the
             counts are read.
6d. bench — ``doppler_tpu_torch.tools.bench.main`` in process for every
             mode of ``bench.py`` at 2^25 samples (``--iters 4
             --dispatches 16``; ``chain-pallas`` and ``channels-pallas``
             also with ``--precision fast``, ``channels-split`` also at
             ``--channels 256``), the launch counts set to 0 before each
             mode and read after it: exactly the kernels of the mode, once a
             step each (``conv`` three times in ``split-xla``); the JSON
             line's metric name, and its rate under the mode's bound (the
             fused function's, by ``_bound``); the profiler's device µs a
             dispatch (every device event of a call, the torch glue
             included; each kernel's mean a launch × its launches a step
             beside it) and the busy share K·device / best (from profiler
             sessions that recorded every call's once-launched kernel);
             then the step at the size it is timed, 2^25 samples and the
             same launch layouts, against itself with every kernel wrapper
             swapped for its plain version on the same card tensors (no
             kernel launched): bitwise for the mixer, ≤ 1 LSB in under 1%
             otherwise.

6c. resample_probe — ``doppler_tpu_torch.tools.resample_probe`` (conv
             block against window_dot at 2^24 inputs), then the conv kernel
             at the pipeline's chunk against its plain version and the
             library's strided ``conv1d`` by one timer, with its bound; then
             ``resample_probe.case_times``: both kernels' profiler device µs
             a launch and the wrapper's time a call at the chunk, at 2^24 and
             at the split tail (C = 1 and 256), with ``conv1d`` at the chunk
             and at 2^24.

The kernels' JSON record takes the mixer's and the cascade's launch counts
from slice (i) (their seek replays' as ``launches_seek``, with the
chain's and the fast chain's, from phase 5c; the mesh runs' of phase 5d
as ``launches_mesh``, with the chain's and the channel cascade's), the
chain's from slice
(iii), the channel cascade's from
(iv), the channel chain's from (v), the fast kernel's from (iii-fast) and
(v-fast), and the Q15 mixer's, the probes', the one-pass chain's and the
fast cascade's (split3 and default, which no CLI path reaches) from
phase 6b, the window kernel's from slice (i) (its EOF chunk, one a stage),
the conv kernel's from phase 5e's ``--impl xla --resample-impl conv`` slice
(both their times from 6c, with ``device_us``: the profiler's µs a launch at
the chunk, at 2^24 and at the split tail, and the conv entry's
``library_device_us``: ``conv1d``'s); the Q15 mixer's and the probes' times are at B = 16384, the
tools' shape (the elementwise probe's and its ``library_ms`` by phase 6's
one timer of 16 calls).  Each kernel of the bench's path also carries
``launches_bench``, its launches in phase 6d.  The line before the last is
that record; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
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
import socket
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


def phase_build_native(card):
    """Build the native host library (``runtime/native.py``, g++ from
    ``native/src``); returns its ``build_info``."""
    from doppler_tpu_torch.runtime import native

    info = native.build_info()
    print(f"build: native host library {info['seconds']!r} s "
          f"({'compiled' if info['built'] else 'cached'}) -> "
          f"{os.path.relpath(info['path'])} [{card}]")
    return info


def phase_build():
    """Build the library; returns the chain-shaped mix's SASS count
    (:func:`_probe_sass`) for phase 6."""
    from doppler_tpu_torch.ops.cuda import build, probes

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
    _print_conv_dot_sass(info["path"])
    g = probes.shape_geometry(B_BIG, 2048, build.sm_count(None))
    return _probe_sass(info["path"], 32 * g.warps, g.depth)


def _clock_max_hz():
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


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


def _print_conv_dot_sass(path):
    """The conv kernel's tile-path dot at config 3 (``conv_tile_kernel<3>``):
    its innermost loop that reads shared memory, with its loads, FMAs and
    the distinct registers its loads write (one set a step: each load waits
    for the FMAs before it), and the kernel's registers."""
    funcs, usage = _sass_instructions(path), _resource_usage(path)
    found = [n for n in funcs if "conv_tile_kernelILi3E" in n]
    check(len(found) == 1, f"sass: {len(found)} conv_tile_kernel<3> instances")
    name, ins = found[0], funcs[found[0]]
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if any(t.startswith("LDS") for t in body):
                loops.append(body)
    check(loops, f"sass: no loop reading shared memory in {name}")
    body = min(loops, key=len)
    lds = [t for t in body if t.startswith("LDS")]
    dst = {t.split()[1].rstrip(",") for t in lds}
    ffma = sum(1 for t in body if t.startswith("FFMA"))
    print(f"sass: conv tile dot ({name}): its loop {len(body)} instructions, "
          f"{len(lds)} LDS into {len(dst)} distinct registers, {ffma} FFMA; "
          f"{usage.get(name, ('?',))[0]} registers")


# the chain-shaped probe's mix instances whose loop is counted: mode 1 (the
# fold tone: chain-mix, mix-fold) and mode 2 (the select tone: mix-select)
SHAPE_MODES = {1: ("chain-mix", "mix-fold"), 2: ("mix-select",)}
SM_WARPS, SM_CTAS, SM_REGS = 64, 32, 65536   # an H100 SM's limits


def _resource_usage(path):
    """Registers and static shared bytes of every kernel in the library at
    ``path`` (``cuobjdump --dump-resource-usage``): name -> (regs, shared)."""
    from doppler_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "--dump-resource-usage", path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:400]}")
    # "Function <name>:" and, on its line or the next, "REG:n ... SHARED:n"
    return {m.group(1): (int(m.group(2)), int(m.group(3))) for m in re.finditer(
        r"Function (\S+?):?\s+REG:(\d+)\b[^\n]*?SHARED:(\d+)", res.stdout)}


def _occupancy(regs, threads, shared):
    """Resident warps an SM over its 64, from a kernel's registers (allocated
    256 a warp), its CTA's threads and its static shared bytes."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    ctas = min(SM_CTAS, SM_WARPS // warps, SM_REGS // per_warp // warps,
               232448 // (shared + 1024) if shared else SM_CTAS)
    return ctas * warps / SM_WARPS


def _probe_sass(path, threads, depth=None):
    """The chain-shaped probe's mix loop in the library at ``path``, a mode
    at a time: the instance the tools' shape launches (``chain_shape_kernel
    <mode, depth, true>``, the warp's own loop; where the library has one
    instance a mode, that one), the static SASS instructions of its
    innermost loop that loads 16 bytes, over the samples a trip (four a
    16-byte load in the loop; branches not taken count too), its registers
    and its occupancy at ``threads`` threads a CTA."""
    funcs, usage = _sass_instructions(path), _resource_usage(path)
    res = {}
    for mode in SHAPE_MODES:
        found = [n for n in funcs if f"chain_shape_kernelILi{mode}E" in n]
        if len(found) > 1:
            found = [n for n in found if f"ILi{mode}ELi{depth}ELb1E" in n]
        check(len(found) == 1, f"sass: {len(found)} chain_shape_kernel instances "
                               f"of mode {mode}")
        name = found[0]
        ins = funcs[name]
        # the innermost loop (backward branch) that holds a 16-byte load
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                loads = sum(1 for t in body if re.search(r"\bLDG\S*\.128\b", t))
                if loads:
                    loops.append((len(body), loads, body))
        check(loops, f"sass: no loop with a 16-byte load in {name}")
        _, loads, body = min(loops, key=lambda x: x[0])
        check(name in usage, f"sass: no resource usage for {name}")
        regs, shared = usage[name]
        res[mode] = dict(name=name, instructions=len(ins), loop=len(body),
                         samples=4 * loads, per_sample=len(body) / (4 * loads),
                         regs=regs, shared=shared, threads=threads,
                         occupancy=_occupancy(regs, threads, shared))
        print(f"sass: chain-shaped mix, mode {mode} ({name}): {len(ins)} instructions, "
              f"{len(body)} in its loop of {4 * loads} samples a trip: "
              f"{res[mode]['per_sample']!r} a sample; {regs} registers, {shared} B "
              f"static shared; {threads} threads a CTA: occupancy "
              f"{res[mode]['occupancy']!r} of the SM's warps")
    return res


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
    from doppler_tpu_torch.ops import resample
    from doppler_tpu_torch.ops.cuda import cascade, chain, conv, mixer

    return {"mixer": (mixer.mix_blocks_fmt, "launches"),
            "window": (resample.window_resample, "launches"),
            "conv": (conv.resample_conv_stream, "launches"),
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
    m = re.search(r"host plan\+stage ([0-9.]+) s, device wait ([0-9.]+) s", done[-1])
    host_s, wait_s = float(m.group(1)), float(m.group(2))
    n_in = len(raw) // 4
    msps = n_in / wall / 1e6
    print(f"slice {name}: launches {launches}")
    print(f"slice {name}: wall {wall!r} s, {msps!r} Msps in"
          + (f" x {channels} channels = {msps * channels!r} M channel-samples/s"
             if channels > 1 else "") + f" [{card}]")
    print(f"slice {name}: split host plan+stage {host_s!r} s, device wait "
          f"{wait_s!r} s (the host blocked on each chunk's device-to-host "
          f"copy), other host {wall - host_s!r} s [{card}]")
    return b"".join(sink.parts), launches, msgs, {
        "wall_s": wall, "msps_in": msps, "host_s": host_s, "wait_s": wait_s}


def _check_slice(name, out, n_in, want_n, launches, kernel, golden, window=0):
    """Length, launches (``kernel`` once a full chunk, the mixer on the EOF
    chunk, the window kernel ``window`` times: once a resampler stage the
    EOF chunk runs, plus a split cascade's tail) and SNR of one slice."""
    from doppler_tpu_torch import oracle

    n_out = len(out) // 4
    full = n_in // (B_MAIN * 2048)
    print(f"slice {name}: {n_in} samples in -> {n_out} out (want {want_n}); "
          f"{full} full chunks")
    check(n_out == want_n, f"{name}: output length {n_out} != {want_n}")
    check(launches[kernel] == full,
          f"{name}: {kernel} launched {launches[kernel]} times, {full} full chunks")
    check(launches["window"] == window,
          f"{name}: window launched {launches['window']} times, want {window}")
    for other, count in launches.items():
        if other not in (kernel, "mixer", "window"):
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
                           launches, "cascade", _golden(mixed, ms.stages),
                           window=len(ms.stages))
        res["default"] = dict(split, launches=launches, snr_db=snr, raw=raw,
                              out=out)
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
        # the tail stage once a full chunk, every stage on the EOF chunk
        snr = _check_slice("split", out, N_SPLIT, ms5.out_count_for(N_SPLIT),
                           launches, "cascade", _golden(mixed5, ms5.stages),
                           window=N_SPLIT // (B_MAIN * 2048) + len(ms5.stages))
        res["split"] = dict(split, launches=launches, snr_db=snr, raw=raw5,
                            out=out)

        # (iii) the single-stage chain, on the capture of (i)
        out, launches, _, split = _run_slice(
            "chain", track + ["--resample-stages", "single"], raw, card)
        rs = RationalResampler(FS, OUT_RATE)
        golden = _golden(mixed, [rs])
        snr = _check_slice("chain", out, N_SLICE, -(-N_SLICE * 3 // 64),
                           launches, "chain", golden, window=1)
        res["chain"] = dict(split, launches=launches, snr_db=snr, out=out,
                            golden=golden)

        # (iii-fast) the same with --precision fast: the fast kernel, held
        # to (iii)'s golden and within 1 LSB of (iii)'s bytes
        out_fast, launches, _, split = _run_slice(
            "chain-fast", track + ["--resample-stages", "single", "--precision",
                                   "fast"], raw, card)
        snr = _check_slice("chain-fast", out_fast, N_SLICE, -(-N_SLICE * 3 // 64),
                           launches, "chain_fast", golden, window=1)
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
            _launches(cascade_channels=full(N_SLICE), mixer_channels=1,
                      window=len(ms.stages)),
            [(c, "plan-word", _golden(mixed4[c], ms.stages)) for c in checked]
            + [(mid, "sequential", _golden(seq["config 4", mid], ms.stages))])
        res["config4"] = dict(split, launches=launches, snr_db=snr, raw=raw4,
                              outs=outs)

        # (v) its first 10 s through the single-stage chain
        rs = RationalResampler(FS, OUT_RATE)
        outs, launches, split = _run_channels_slice(
            "config4-chain", tmp, cfg4,
            io_args + ["--resample-to", str(OUT_RATE), "--resample-stages", "single"],
            raw4[:N_CH_CHAIN * 4], card, top)
        goldens_v = {c: _golden(mixed4[c], [rs]) for c in checked}
        snr = _check_channels_slice(
            "config4-chain", outs, N_CH_CHAIN, -(-N_CH_CHAIN * 3 // 64), launches,
            _launches(chain_channels=full(N_CH_CHAIN), mixer_channels=1, window=1),
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
            _launches(chain_channels_fast=full(N_CH_FAST), mixer_channels=1,
                      window=1),
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
            _launches(cascade_channels=full(N_WIDE), mixer_channels=1,
                      window=full(N_WIDE) + len(ms5.stages)),
            [(c, "plan-word", _golden(mixed5[c], ms5.stages)) for c in checked5]
            + [(mid5, "sequential", _golden(seq["config 5", mid5], ms5.stages))])
        res["config5"] = dict(split, launches=launches, snr_db=snr, raw=raw5,
                              outs=outs)
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


def phase_timing_probes(torch, gen, card, sass=None):
    """The Q15 mixer and the probes: events (plain, kernel, kernel, plain),
    the profiler's device time, the bound, and the library's ``copy_`` beside
    the two copy probes (timed here, used nowhere in the package); beside
    the chain-shaped mixes, ``sass`` (phase 2's count, by mode)."""
    from doppler_tpu_torch.ops import nco
    from doppler_tpu_torch.ops.cuda import build, mixer, probes

    P, Q, L = 3, 64, 2048
    res = {}
    # thread instructions an SM issues a second at most: four schedulers,
    # one warp instruction each a clock
    issue_rate = build.sm_count(None) * 4 * 32 * _clock_max_hz()
    loops = {name: sass[mode] for mode, names in SHAPE_MODES.items()
             for name in names if sass and mode in sass}
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
            loop = ""
            if name in loops and B == B_BIG:
                # the launched instance's static SASS a sample (phase 2) over
                # the card's issue rate
                c = loops[name]
                loop = (f"; loop {c['per_sample']!r} SASS instructions a sample, "
                        f"{c['regs']} registers, occupancy {c['occupancy']!r} at "
                        f"{c['threads']} threads: issue floor "
                        f"{c['per_sample'] * n / issue_rate * 1e3!r} ms")
            print(f"timing: {name} B={B} ({n} samples): kernel {k_a!r}/{k_b!r} ms, "
                  f"plain {pl_a!r}/{pl_b!r} ms, library call {lib}; "
                  f"{_device_text(dev_us, bound_ms)}; bound {bound_ms!r} ms ({by})"
                  f"{loop} [{card}]")
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


# -- the host split: seek and --distributed ---------------------------------

N_DIST_CH = 5_120_000 + 1000     # the channels split: config 4's first 5 s


def _seek_route(torch, name, raw, make, card):
    """One route's seek on the card, at the CLI's chunk: the whole capture,
    its first half (a chunk boundary) and a pipeline seeked there with the
    history before it; the seek and the seeked run with every launch count
    set to 0 just before and read just after each.  Checks the replay's
    state bitwise against the first half's and the halves' bytes against
    the whole run's; returns (replay launches, seeked-run launches)."""
    whole_p = make()
    bb, cb = whole_p.block_bytes, whole_p.chunk_blocks
    k = (len(raw) // bb // cb // 2) * cb
    n_hist = whole_p.seek_history_blocks()
    whole, prefix = _Sink(), _Sink()
    whole_p.run(io.BytesIO(raw), whole)
    prefix_p = make()
    prefix_p.run(io.BytesIO(raw[:k * bb]), prefix)
    seeked = make()
    _zero_counts(_counters())
    t0 = time.perf_counter()
    seeked.seek_to_block(k, history=raw[(k - n_hist) * bb:k * bb])
    torch.cuda.synchronize()
    seek_s = time.perf_counter() - t0
    replay = _read_counts(_counters())
    rs_a, rs_b = seeked.resampler, prefix_p.resampler
    for a, b in zip(getattr(rs_a, "stages", [rs_a]), getattr(rs_b, "stages", [rs_b]),
                    strict=True):
        check((a.m_next, a.in_consumed) == (b.m_next, b.in_consumed)
              and torch.equal(a._hist_i, b._hist_i)
              and torch.equal(a._hist_q, b._hist_q),
              f"seek {name}: the replay's state is not the stream's at block {k}")
    suffix = _Sink()
    _zero_counts(_counters())
    seeked.run(io.BytesIO(raw[k * bb:]), suffix)
    run_counts = _read_counts(_counters())
    same = b"".join(prefix.parts + suffix.parts) == b"".join(whole.parts)
    print(f"distributed: seek {name}: block {k} with {n_hist} history blocks "
          f"in {seek_s!r} s; replay launches {replay}; seeked run launches "
          f"{run_counts}; state bitwise, bytes equal to the whole run's={same} "
          f"[{card}]")
    check(same and whole.parts, f"seek {name}: the seeked bytes differ")
    return replay, run_counts


def _spawn_hosts(argv, tmp, n=2):
    """``python -m doppler_tpu_torch`` once per host of a ``--distributed``
    run on this card (``n = 1``: one process, no group).  Returns the wall
    from the first start to the last exit and a line of each host's times
    from its log: start (spawn to the card's name, which the CLI logs once
    the pipeline is on the card: the interpreter, torch, the rendezvous,
    the CUDA context) and run (that line to 'done': the seek and the
    stream), and the Msps in of its 'done' line.  Kills what is left on a
    failure."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    t0, spawned = time.perf_counter(), time.time()
    try:
        for pid in range(n):
            logs.append(open(os.path.join(tmp, f"host{pid}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "doppler_tpu_torch"] + argv
                + ["--device", "cuda", "--log-format", "json", "--distributed",
                   f"coordinator=127.0.0.1:{port},num_processes={n},process_id={pid}"],
                stdout=subprocess.DEVNULL, stderr=logs[-1], cwd=root))
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    times = []
    for pid, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        lines = f.read().splitlines()
        f.close()
        check(p.returncode == 0, f"host {pid} rc {p.returncode}: {lines[-5:]}")
        recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
        dev = [r["ts"] for r in recs if r["msg"].startswith("device ")]
        done = [r for r in recs if r["msg"].startswith("done:")]
        check(dev and done, f"host {pid} logged no device or 'done' line")
        msps = re.search(r"\(([0-9.]+) Msps in\)", done[-1]["msg"]).group(1)
        times.append(f"host {pid} start {dev[0] - spawned:.3f} s, run "
                     f"{done[-1]['ts'] - dev[0]:.3f} s, {msps} Msps in")
    return wall, "; ".join(times)


def phase_distributed(torch, card):
    """The host split on the card.  In process, at the CLI's chunk: each
    route's seek (a 1-block chain launch, exact and fast; a zero-prepadded
    cascade launch on config 3's default route and on the 100 Msps split
    route, whose front's planes then run the tail; the mixer where nothing
    fuses, at 8000-byte blocks) with its state bitwise the stream's and its
    bytes the whole run's.  Then ``--distributed`` over two processes on
    this card (gloo rendezvous, nothing sent between them): config 3's
    20 s track capture on the default route and with ``--resample-stages
    single``, the 0.5 s 100 Msps split route, and config 4's first 5 s split
    by channel; the concatenated parts (the channel files) against the one
    process's bytes, and (i) in one fresh process for its own times; and
    ``--prefetch-chunks 2`` against depth 0."""
    from doppler_tpu_torch.ops.resample import attach_resampler
    from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

    raw = _capture(torch, N_SLICE, seed=3)
    raw5 = _capture(torch, N_SPLIT, seed=5, fs=FS_SPLIT)
    raw4 = raw[:N_DIST_CH * 4]

    def make(fs, stages, precision="exact", block_bytes=8192):
        def build():
            sched = (_track_scheduler() if fs == FS else ConstScheduler(OFFSET))
            p = Pipeline(fs, "i16", "i16", sched, block_bytes=block_bytes,
                         precision=precision, device="cuda")
            attach_resampler(p, OUT_RATE, stages=stages)
            return p
        return build

    seek = {}
    # the split route's replay runs its front's planes through the tail
    # stage: one window launch beside its cascade's
    for name, data, build, kernel, window in (
            ("default", raw, make(FS, "auto"), "cascade", 0),
            ("chain", raw, make(FS, "single"), "chain", 0),
            ("chain-fast", raw, make(FS, "single", "fast"), "chain_fast", 0),
            ("split", raw5, make(FS_SPLIT, "auto"), "cascade", 1),
            ("mixer", raw, make(FS, "single", block_bytes=8000), "mixer", 0)):
        replay, run_counts = _seek_route(torch, name, data, build, card)
        check(replay[kernel] == 1 and replay["window"] == window
              and sum(replay.values()) == 1 + window,
              f"seek {name}: the replay launched {replay}, want one {kernel}")
        check(run_counts[kernel] >= 1, f"seek {name}: the seeked run launched {run_counts}")
        seek[name] = replay

    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        start = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX))
        track = ["track", "-s", str(FS), "-i", "i16", "--tlefile", tle_path,
                 "--tlename", "TEST SAT", "--location", LOCATION,
                 "--frequency", str(int(FREQ)), "--offset", str(int(OFFSET)),
                 "--time", start, "--resample-to", str(OUT_RATE)]
        const5 = ["const", "-s", str(FS_SPLIT), "-i", "i16", "--shift",
                  str(OFFSET), "--resample-to", str(OUT_RATE)]
        paths = {}
        for key, data in (("c3", raw), ("c5", raw5), ("c4", raw4)):
            paths[key] = os.path.join(tmp, f"{key}.iq")
            with open(paths[key], "wb") as f:
                f.write(data)

        # the one-process runs in process (launches counted) and through
        # --prefetch-chunks 2
        one = {}
        for name, argv, data in (("default", track, raw),
                                 ("chain", track + ["--resample-stages", "single"], raw),
                                 ("split", const5, raw5)):
            out, launches, _, split = _run_slice(f"one-process {name}", argv,
                                                 data, card)
            one[name] = (out, split["wall_s"])
        out, _, _, _ = _run_slice("prefetch", track + ["--prefetch-chunks", "2"],
                                  raw, card)
        print(f"distributed: --prefetch-chunks 2 bytes equal to depth 0's="
              f"{out == one['default'][0]}")
        check(out == one["default"][0], "--prefetch-chunks 2 changed the bytes")

        for name, argv, key in (("default", track, "c3"),
                                ("chain", track + ["--resample-stages", "single"], "c3"),
                                ("split", const5, "c5")):
            out_path = os.path.join(tmp, f"{name}.iq")
            io_paths = ["--input", paths[key], "--output", out_path]
            if name == "default":
                # one fresh process of the same run, for the hosts' times
                wall, times = _spawn_hosts(argv + io_paths, tmp, n=1)
                with open(out_path, "rb") as f:
                    same = f.read() == one[name][0]
                print(f"distributed: {name}: one fresh process, wall {wall!r} s; "
                      f"{times}; bytes equal to the in-process run's={same} "
                      f"[{card}]")
                check(same, f"distributed {name}: one fresh process differs")
            wall, times = _spawn_hosts(argv + io_paths, tmp)
            parts = b""
            for pid in range(2):
                with open(f"{out_path}.part{pid}", "rb") as f:
                    parts += f.read()
            same = parts == one[name][0]
            print(f"distributed: {name}: two processes on one card, wall "
                  f"{wall!r} s; {times}; one process in process "
                  f"{one[name][1]!r} s; parts equal to the one-process "
                  f"bytes={same} [{card}]")
            check(same, f"distributed {name}: the parts differ from one process")

        # config 4's 16 track channels, split by channel
        cfg = dict(tlefile=tle_path, location=LOCATION, time=start,
                   channels=_config4_channels())
        cfg_path = os.path.join(tmp, "config4.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        ch_args = ["-s", str(FS), "-i", "i16", "--resample-to", str(OUT_RATE)]
        one_outs, launches, split = _run_channels_slice(
            "one-process config4", tmp, cfg["channels"], ch_args, raw4, card,
            {k: cfg[k] for k in ("tlefile", "location", "time")})
        check(launches["cascade_channels"] == N_DIST_CH // (B_MAIN * 2048),
              f"one-process config4: launches {launches}")
        out_dir = os.path.join(tmp, "config4-dist")
        wall, times = _spawn_hosts(
            ["channels", "--config", cfg_path, "--output-dir", out_dir,
             "--input", paths["c4"]] + ch_args, tmp)
        same = True
        for ch, want in zip(cfg["channels"], one_outs):
            with open(os.path.join(out_dir, ch["name"] + ".iq"), "rb") as f:
                same = same and f.read() == want
        print(f"distributed: config4 channels: two processes of 8 channels "
              f"each, wall {wall!r} s; {times}; one process in process "
              f"{split['wall_s']!r} s; channel files equal={same} [{card}]")
        check(same, "distributed config4: a channel file differs")
    return seek


N_MESH_C1 = 1_280_000 + 300       # config 1 under the mesh: 5 s at 256 ksps f32
FS_C1 = 256000


def _mesh_run(torch, name, make, feed, mesh, card):
    """One in-process run of the pipeline ``make(mesh)`` builds over
    ``feed(pipe)``, with every launch count set to 0 just before and read
    just after; returns (bytes or per-channel bytes, launches, wall s)."""
    pipe = make(mesh)
    _zero_counts(_counters())
    t0 = time.perf_counter()
    out = feed(pipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_counts(_counters()).items() if v}
    what = "unsharded" if mesh is None else f"mesh {mesh.shape}"
    print(f"mesh: {name} {what}: wall {wall!r} s, device wait "
          f"{pipe.spans.seconds('wait')!r} s, launches {launches} [{card}]")
    return out, launches, wall


def phase_mesh(torch, card, slices):
    """``--mesh`` on this card: every shard of a mesh on cuda:0
    (``make_mesh(devices=[cuda:0] × n)``), the pipelines built as the CLI
    builds them, on the captures of the slice phases: config 3's
    default route (cascade) and ``--resample-stages single`` (chain) at
    time=4, config 1 (f32 → i16 at 256 ksps, mix only) at time=4, the
    100 Msps split route at time=2, config 4 (16 track channels, channel
    cascade) and config 5's rate × 256 channels at time=2 × channel=2.
    Each run's bytes against the unsharded bytes (the CLI's of phase 5 where
    it ran the route, and an unsharded in-process run timed beside it), and
    each full chunk's launches: one a shard plus one replay for every time
    shard k > 0 (chain, cascade), one a shard (mixer).  Then the CLI with
    ``--mesh time=1`` (the bytes of slice (i)) and with one shard more than
    the machine has cards (exit 1, the JAX message)."""
    import numpy as np

    from doppler_tpu_torch import cli
    from doppler_tpu_torch.ops.resample import attach_resampler
    from doppler_tpu_torch.orbit import make_track_scheduler
    from doppler_tpu_torch.parallel.mesh import make_mesh
    from doppler_tpu_torch.runtime.channels import (
        MultiChannelPipeline,
        load_channel_config,
    )
    from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

    on_card = lambda n: make_mesh(time=n, devices=["cuda:0"] * n)      # noqa: E731
    grid = make_mesh(time=2, channel=2, devices=["cuda:0"] * 4)
    raw, raw5 = slices["default"]["raw"], slices["split"]["raw"]
    rng = np.random.default_rng(12)
    raw1 = (0.3 * rng.standard_normal(2 * N_MESH_C1)).astype("<f4").tobytes()
    launches_mesh, walls = {}, {}

    def stream(fs, sched, stages=None, intype="i16"):
        def make(mesh):
            p = Pipeline(fs, intype, "i16", sched(), device="cuda", mesh=mesh)
            if stages:
                attach_resampler(p, OUT_RATE, stages=stages)
            return p
        return make

    def feed_stream(data):
        def feed(pipe):
            sink = _Sink()
            pipe.run(io.BytesIO(data), sink)
            return b"".join(sink.parts)
        return feed

    def check_run(name, make, feed, mesh, want, kernel, per_chunk, n_full, extra):
        plain, _, wall_plain = _mesh_run(torch, name, make, feed, None, card)
        got, launches, wall = _mesh_run(torch, name, make, feed, mesh, card)
        same = got == plain and (want is None or got == want)
        print(f"mesh: {name}: bytes equal to the unsharded run's={same}; wall "
              f"{wall!r} s against {wall_plain!r} s unsharded [{card}]")
        check(same and len(plain) > 0, f"mesh {name}: the bytes differ")
        want_launches = dict({kernel: per_chunk * n_full}, **extra)
        check(launches == want_launches,
              f"mesh {name}: launches {launches}, want {want_launches}")
        for k, v in launches.items():
            launches_mesh[k] = launches_mesh.get(k, 0) + v
        walls[name] = (wall, wall_plain)

    full = lambda n, L=2048: n // (B_MAIN * L)          # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        lat, lon, alt = cli.parse_location(LOCATION)

        def track():
            return make_track_scheduler(
                tlefile=tle_path, tlename="TEST SAT", lat=lat, lon=lon, alt=alt,
                frequency_hz=FREQ, offset_hz=OFFSET, samplerate=FS,
                start_time=START_UNIX)

        # the EOF chunk runs unsharded: the mixer, then the window kernel
        # once a stage (and a split cascade's tail once a full chunk)
        check_run("config 3 default route (cascade), time=4",
                  stream(FS, track, "auto"), feed_stream(raw), on_card(4),
                  slices["default"]["out"], "cascade", 4 + 3, full(N_SLICE),
                  {"mixer": 1, "window": 2})
        check_run("config 3 single-stage (chain), time=4",
                  stream(FS, track, "single"), feed_stream(raw), on_card(4),
                  slices["chain"]["out"], "chain", 4 + 3, full(N_SLICE),
                  {"mixer": 1, "window": 1})
        n_chunks1 = -(-N_MESH_C1 // (B_MAIN * 1024))
        check_run("config 1 mix only (f32 -> i16), time=4",
                  stream(FS_C1, lambda: ConstScheduler(-15000.0), intype="f32"),
                  feed_stream(raw1), on_card(4), None, "mixer", 4, n_chunks1, {})
        check_run("100 Msps split route, time=2",
                  stream(FS_SPLIT, lambda: ConstScheduler(OFFSET), "auto"),
                  feed_stream(raw5), on_card(2), slices["split"]["out"],
                  "cascade", 2 + 1, full(N_SPLIT),
                  {"mixer": 1, "window": full(N_SPLIT) + 3})

        def channels(fs, cfg):
            cfg_path = os.path.join(tmp, f"mesh{len(cfg['channels'])}.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)

            def make(mesh):
                specs, _ = load_channel_config(cfg_path, fs)
                return MultiChannelPipeline(fs, "i16", "i16", specs,
                                            out_rate=OUT_RATE,
                                            chunk_blocks=B_MAIN,
                                            resample_stages="auto",
                                            device="cuda", mesh=mesh)
            return make

        def feed_channels(data):
            def feed(mp):
                sinks = [_Sink() for _ in mp.channels]
                mp.run(io.BytesIO(data), sinks)
                return [b"".join(s.parts) for s in sinks]
            return feed

        start = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX))
        cfg4 = dict(tlefile=tle_path, location=LOCATION, time=start,
                    channels=_config4_channels())
        check_run("config 4, 16 channels (channel cascade), time=2 x channel=2",
                  channels(FS, cfg4), feed_channels(slices["config4"]["raw"]),
                  grid, slices["config4"]["outs"], "cascade_channels", 4 + 2,
                  full(N_SLICE), {"mixer_channels": 1, "window": 2})
        check_run("config 5 rate x 256 channels, time=2 x channel=2",
                  channels(FS_SPLIT, dict(channels=_config5_channels())),
                  feed_channels(slices["config5"]["raw"]), grid,
                  slices["config5"]["outs"], "cascade_channels", 4 + 2,
                  full(N_WIDE), {"mixer_channels": 1, "window": full(N_WIDE) + 3})

        # the CLI: --mesh time=1 on the card is slice (i); one shard more
        # than the machine's cards exits 1 with the JAX package's message
        argv = ["track", "-s", str(FS), "-i", "i16", "--tlefile", tle_path,
                "--tlename", "TEST SAT", "--location", LOCATION,
                "--frequency", str(int(FREQ)), "--offset", str(int(OFFSET)),
                "--time", start, "--resample-to", str(OUT_RATE)]
        out, launches, msgs, _ = _run_slice("mesh-cli", argv + ["--mesh", "time=1"],
                                            raw, card)
        check(out == slices["default"]["out"]
              and any(m == "device mesh: time=1 channel=1" for m in msgs),
              "mesh-cli: --mesh time=1 is not slice (i)")
        n = torch.cuda.device_count()
        logger = logging.getLogger("doppler_tpu_torch")
        for h in list(logger.handlers):
            logger.removeHandler(h)
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            rc = cli.main(argv + ["--mesh", f"time={n + 1}", "--device", "cuda"],
                          stdin=io.BytesIO(b""), stdout=_Sink())
        want_msg = f"need {n + 1} devices, have {n}"
        print(f"mesh: the CLI with --mesh time={n + 1} on {n} card(s): rc {rc}, "
              f"{want_msg!r} logged={want_msg in log.getvalue()}")
        check(rc == 1 and want_msg in log.getvalue(),
              f"--mesh time={n + 1}: rc {rc}, log {log.getvalue()[-300:]!r}")
    return launches_mesh, walls


# -- the conv resampler, --impl xla, the native host library ----------------------

N_CONV = B_MAIN * 2048             # the pipeline's chunk: the conv step's shape
CONV_REL = 1e-5                    # conv kernel vs another order, float32 out


def _conv_setup(torch, n, seed, in_consumed):
    """Config 3's single stage: ``T − 1 + n`` seeded float32 samples a plane
    on the card, its taps matrix, and the conv geometry of a chunk that
    starts at input ``in_consumed`` of a stream."""
    import numpy as np

    from doppler_tpu_torch.ops.resample import (
        RationalResampler,
        conv_stream_geometry,
        make_taps_matrix,
    )

    rs = RationalResampler(FS, OUT_RATE)
    P, Q, T = rs.P, rs.Q, rs.T
    rng = np.random.default_rng(seed)
    xi, xq = (torch.from_numpy((0.3 * rng.standard_normal(T - 1 + n)).astype(
        np.float32)).cuda() for _ in range(2))
    taps = torch.from_numpy(make_taps_matrix(rs.bank, P, Q)).cuda()
    m0 = -(-in_consumed * P // Q)
    M = n * P // Q + 2
    geo = conv_stream_geometry(m0, in_consumed, M, n, P=P, Q=Q, T=T)
    return rs, xi, xq, taps, m0, M, geo


def _conv_stream(torch, x, width):
    """``x`` (2, n) on the card through ``RationalResampler(impl='conv')``
    in chunks of ``width``, the last one zero padded."""
    from doppler_tpu_torch.ops.resample import RationalResampler

    r = RationalResampler(FS, OUT_RATE, impl="conv", device="cuda")
    n, parts = x.shape[1], []
    for lo in range(0, n, width):
        v = min(width, n - lo)
        c = torch.zeros(2, width, device="cuda")
        c[:, :v] = x[:, lo:lo + v]
        yi, yq, k = r.process(c[0], c[1], v, r.max_out_for(width))
        parts.append(torch.stack([yi[:k], yq[:k]]))
    return torch.cat(parts, dim=1)


def phase_conv(torch, card):
    """(a) The conv kernel (``csrc/conv.cu``) at config 3's chunk, mid-stream
    (p0 ≠ 0): against its plain version on the card (cuBLAS, TF32 off), its
    CPU twin and the window kernel, float32 within 1e-5 of the peak and ≤ 1
    LSB in under 1% after encode; the stream bitwise across two chunk widths
    and one-shot; the TF32 refusal.  Whether the plain version (cuBLAS) is
    itself bitwise across chunk widths is printed, not required.  Then the
    window kernel (``csrc/window.cu``) against its plain version
    (``window_dot``) on the same buffers, within 2^-20.  Returns the largest
    float32 errors by comparison."""
    from doppler_tpu_torch.ops import codec
    from doppler_tpu_torch.ops import resample as resample_mod
    from doppler_tpu_torch.ops.cuda import conv
    from doppler_tpu_torch.ops.resample import (
        RationalResampler,
        window_dot,
        window_resample,
    )

    in_consumed = 7 * N_CONV + 5
    rs, xi, xq, taps, m0, M, geo = _conv_setup(torch, N_CONV, 31, in_consumed)
    start0, p0, K, PADZ, TAIL = geo
    P, Q, T = rs.P, rs.Q, rs.T
    kw = dict(P=P, Q=Q, T=T, K=K, M=M, PADZ=PADZ, TAIL=TAIL)
    print(f"conv: P/Q = {P}/{Q}, T = {T}, chunk {N_CONV} inputs, M = {M}, "
          f"start0 = {start0}, p0 = {p0}, K = {K} [{card}]")
    got = torch.stack(conv.resample_conv_stream(xi, xq, taps, start0, p0, **kw))
    torch.cuda.synchronize()
    plain = torch.stack(conv.resample_conv_stream_plain(xi, xq, taps, start0, p0,
                                                        **kw))
    twin = torch.stack(conv.resample_conv_stream_plain(
        xi.cpu(), xq.cpu(), taps.cpu(), start0, p0, **kw)).cuda()
    bank_rev = torch.from_numpy(rs.bank[:, ::-1].copy()).cuda()
    window = torch.stack(window_resample(xi, xq, bank_rev, (m0 * Q) % P,
                                         (m0 * Q) // P - in_consumed, P=P, Q=Q,
                                         T=T, M=M))
    # the outputs whose newest input lies in the buffer (the rest read past
    # it, zeros for conv and a clipped index for window)
    n = -(-(in_consumed + N_CONV) * P // Q) - m0
    peak = plain.abs().max().item()
    errs = {}
    for name, want in (("plain (cuBLAS)", plain), ("CPU twin", twin),
                       ("window kernel", window)):
        errs[name] = (got[:, :n] - want[:, :n]).abs().max().item()
        d = _lsb_diff(torch, codec.iq_to_i16_words(got[0, :n], got[1, :n]),
                      codec.iq_to_i16_words(want[0, :n], want[1, :n]))
        lsb, frac = int(d.max()), float((d > 0).float().mean())
        print(f"conv: kernel vs {name}: max abs err {errs[name]!r} (peak "
              f"{peak!r}), encoded max LSB={lsb} frac={frac!r} [{card}]")
        check(errs[name] <= CONV_REL * peak and lsb <= 1 and frac < 0.01,
              f"conv: the kernel is not within tolerance of the {name}")

    gen = torch.Generator(device="cuda").manual_seed(33)
    x = 0.3 * torch.randn(2, 3 * N_CONV + 12345, device="cuda", generator=gen)
    one = _conv_stream(torch, x, x.shape[1])
    same = [torch.equal(_conv_stream(torch, x, w), one) for w in (N_CONV, 100_000)]
    print(f"conv: stream at {N_CONV} and 100000 a chunk bitwise one-shot: "
          f"{same} [{card}]")
    check(all(same), "conv: the kernel's bytes depend on the chunk width")
    kernel_stream = resample_mod.resample_conv_stream
    resample_mod.resample_conv_stream = conv.resample_conv_stream_plain
    try:
        one_p = _conv_stream(torch, x, x.shape[1])
        same_p = [torch.equal(_conv_stream(torch, x, w), one_p)
                  for w in (N_CONV, 100_000)]
    finally:
        resample_mod.resample_conv_stream = kernel_stream
    print(f"conv: the plain version on the card (R cuBLAS products) bitwise "
          f"one-shot at the same widths: {same_p} [{card}]")

    r = RationalResampler(FS, OUT_RATE, impl="conv", device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r.process(x[0, :4096], x[1, :4096], 4096, r.max_out_for(4096))
        refused = False
    except RuntimeError as e:
        refused = "TF32" in str(e)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"conv: refuses TF32 matmuls: {refused} [{card}]")
    check(refused and torch.get_float32_matmul_precision() == "highest",
          "conv: the TF32 refusal failed or the setting was left changed")

    # the window kernel against its plain version (window_dot's tree) on
    # the same buffers: 2^-20, as the chain kernel against its plain version
    plain_w = torch.stack(window_dot(xi, xq, bank_rev, (m0 * Q) % P,
                                     (m0 * Q) // P - in_consumed, P=P, Q=Q, T=T,
                                     M=M))
    errs["window plain"] = (window[:, :n] - plain_w[:, :n]).abs().max().item()
    d = _lsb_diff(torch, codec.iq_to_i16_words(window[0, :n], window[1, :n]),
                  codec.iq_to_i16_words(plain_w[0, :n], plain_w[1, :n]))
    lsb, frac = int(d.max()), float((d > 0).float().mean())
    print(f"window: kernel vs plain (window_dot): max abs err "
          f"{errs['window plain']!r}, encoded max LSB={lsb} frac={frac!r} "
          f"[{card}]")
    check(errs["window plain"] <= TOL_F32 and lsb <= 1 and frac < 0.01,
          "window: the kernel is not within tolerance of its plain version")

    # both kernels against their plain versions at the split tail (P/Q =
    # 384/3125, the rows paths) at C = 1 and 256, the shapes (ii) and
    # (vii) give them: window 2^-20, conv 1e-5 of the peak, ≤ 1 LSB in < 1%
    from doppler_tpu_torch.tools import kernel_digests

    for name in ("tail/C1", "tail/C256"):
        for kernel in kernel_digests.RESAMPLE_KERNELS:
            r = kernel_digests.resample_vs_plain(kernel, name, "cuda")
            print(f"{kernel}: kernel vs plain at the split tail {name}: max abs "
                  f"err {r['max_abs_err']!r} (tolerance {r['tol']!r}), encoded "
                  f"max LSB={r['lsb']} frac={r['frac']!r} [{card}]")
            check(r["ok"], f"{kernel}: the kernel is not within tolerance of its "
                           f"plain version at {name}")
            key = f"{kernel} tail"
            errs[key] = max(errs.get(key, 0.0), r["max_abs_err"])

    # both kernels' bytes against the digests taken before their redesign
    got = kernel_digests.compute_resample()
    bad = kernel_digests.mismatches(got)
    print(f"resample digests: {len(got) - len(bad)} of {len(got)} equal the "
          f"pinned (window and conv, {len(kernel_digests.RESAMPLE_CASES)} cases "
          f"each) [{card}]")
    check(not bad, f"resample digests differ: {bad}")
    return errs


def _track_argv(tle_path):
    return ["track", "-s", str(FS), "-i", "i16", "--tlefile", tle_path,
            "--tlename", "TEST SAT", "--location", LOCATION,
            "--frequency", str(int(FREQ)), "--offset", str(int(OFFSET)),
            "--time", time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX)),
            "--resample-to", str(OUT_RATE)]


def phase_unfused(torch, card, slices):
    """(b) slice (iii) with ``--impl xla``: the mixer kernel and the window
    resampler on every chunk, (iii)'s bytes, mixer once a chunk and no
    chain launch; (c) with ``--impl xla --resample-impl conv``: the conv
    kernel once a chunk, > 70 dB against (iii)'s golden, ≤ 1 LSB in under
    1% from (iii)'s bytes; then that route in process over ``--mesh
    time=2`` on ``[cuda:0] × 2``, the unsharded conv bytes."""
    from doppler_tpu_torch import oracle
    from doppler_tpu_torch.ops.resample import attach_resampler
    from doppler_tpu_torch.orbit import make_track_scheduler
    from doppler_tpu_torch.parallel.mesh import make_mesh
    from doppler_tpu_torch.runtime.pipeline import Pipeline

    raw = slices["default"]["raw"]
    chain_out, golden = slices["chain"]["out"], slices["chain"]["golden"]
    n_full = N_SLICE // (B_MAIN * 2048)
    n_chunks = -(-N_SLICE // (B_MAIN * 2048))
    want_n = -(-N_SLICE * 3 // 64)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        argv = _track_argv(tle_path) + ["--resample-stages", "single", "--impl", "xla"]

        out, launches, _, split = _run_slice("chain-xla", argv, raw, card)
        same = out == chain_out
        print(f"slice chain-xla: bytes equal to (iii)'s={same} [{card}]")
        check(same, "chain-xla: --impl xla is not (iii)'s bytes")
        check(launches == _launches(mixer=n_chunks, window=n_chunks),
              f"chain-xla: launches {launches}, want the mixer and the window "
              f"kernel {n_chunks} times each")
        res["chain-xla"] = dict(split, launches=launches)

        out, launches, _, split = _run_slice(
            "chain-xla-conv", argv + ["--resample-impl", "conv"], raw, card)
        check(len(out) // 4 == want_n,
              f"chain-xla-conv: output length {len(out) // 4} != {want_n}")
        check(launches == _launches(mixer=n_chunks, conv=n_chunks),
              f"chain-xla-conv: launches {launches}, want mixer and conv "
              f"{n_chunks} times each")
        snr = oracle.snr_db(golden, oracle.decode_i16_bytes(out[:len(golden) * 4]))
        d = _lsb_diff(torch, torch.frombuffer(bytearray(out), dtype=torch.int32),
                      torch.frombuffer(bytearray(chain_out), dtype=torch.int32))
        lsb, frac = int(d.max()), float((d > 0).float().mean())
        print(f"slice chain-xla-conv: first {len(golden)} outputs vs golden: SNR "
              f"{snr!r} dB; against (iii)'s bytes max LSB={lsb} frac={frac!r} "
              f"[{card}]")
        check(snr > 70.0 and lsb <= 1 and frac < 0.01,
              "chain-xla-conv: not within tolerance of the golden and (iii)")
        res["chain-xla-conv"] = dict(split, launches=launches, snr_db=snr)

        lat, lon, alt = (float(v.split("=")[1]) for v in LOCATION.split(","))

        def make(mesh):
            p = Pipeline(FS, "i16", "i16", make_track_scheduler(
                tlefile=tle_path, tlename="TEST SAT", lat=lat, lon=lon, alt=alt,
                frequency_hz=FREQ, offset_hz=OFFSET, samplerate=FS,
                start_time=START_UNIX), impl="xla", device="cuda", mesh=mesh)
            attach_resampler(p, OUT_RATE, stages="single", impl="conv")
            return p

        def feed(pipe):
            sink = _Sink()
            pipe.run(io.BytesIO(raw), sink)
            return b"".join(sink.parts)

        got, launches_m, wall = _mesh_run(torch, "chain-xla-conv", make, feed,
                                          make_mesh(time=2, devices=["cuda:0"] * 2),
                                          card)
        print(f"mesh: chain-xla-conv time=2: bytes equal to the CLI's unsharded "
              f"run's={got == out} [{card}]")
        check(got == out, "chain-xla-conv: --mesh time=2 is not the unsharded bytes")
        want_m = {"mixer": 2 * n_full + 1, "conv": 2 * n_full + 1}
        check(launches_m == want_m,
              f"chain-xla-conv mesh: launches {launches_m}, want {want_m}")
        res["chain-xla-conv"]["launches_mesh"] = launches_m
    return res


class _TimedScheduler:
    """A scheduler whose ``shifts`` calls are timed: ``seconds`` holds the
    time in the Doppler curve (SGP4) and the staircase."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0

    def shifts(self, counts):
        t0 = time.perf_counter()
        out = self.inner.shifts(counts)
        self.seconds += time.perf_counter() - t0
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def phase_native(torch, card, slices, native_info):
    """(d) The native host library: its build seconds, then slices (i) and
    (iv) in process, built as the CLI builds them, with the track
    predictors' ``use_native`` on and off: the bytes of phase 5's CLI runs
    both ways, and ``host_s`` with the schedulers' share beside it."""
    from doppler_tpu_torch.ops.resample import attach_resampler
    from doppler_tpu_torch.orbit import make_track_scheduler
    from doppler_tpu_torch.runtime.channels import (
        MultiChannelPipeline,
        load_channel_config,
    )
    from doppler_tpu_torch.runtime.pipeline import Pipeline

    print(f"native: libdoppler_native.so built in {native_info['seconds']!r} s "
          f"({'compiled' if native_info['built'] else 'cached'}) -> "
          f"{os.path.relpath(native_info['path'])} [{card}]")
    lat, lon, alt = (float(v.split("=")[1]) for v in LOCATION.split(","))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tle_path = os.path.join(tmp, "sat.txt")
        with open(tle_path, "w") as f:
            f.write("TEST SAT\n" + "\n".join(_tle_lines()) + "\n")
        cfg_path = os.path.join(tmp, "config4.json")
        with open(cfg_path, "w") as f:
            json.dump({"tlefile": tle_path, "location": LOCATION,
                       "time": time.strftime("%Y-%m-%dT%H:%M:%S",
                                             time.gmtime(START_UNIX)),
                       "channels": _config4_channels()}, f)
        for use_native in (True, False):
            sched = _TimedScheduler(make_track_scheduler(
                tlefile=tle_path, tlename="TEST SAT", lat=lat, lon=lon, alt=alt,
                frequency_hz=FREQ, offset_hz=OFFSET, samplerate=FS,
                start_time=START_UNIX, use_native=use_native))
            check(sched.predictor.native == use_native,
                  f"native: the predictor's C++ curve is not {use_native}")
            pipe = Pipeline(FS, "i16", "i16", sched, device="cuda")
            attach_resampler(pipe, OUT_RATE, stages="auto")
            sink = _Sink()
            t0 = time.perf_counter()
            pipe.run(io.BytesIO(slices["default"]["raw"]), sink)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            same = b"".join(sink.parts) == slices["default"]["out"]
            print(f"native: slice (i) use_native={use_native}: bytes equal to "
                  f"the CLI run's={same}; host_s {pipe.host_s!r} s, of which the "
                  f"scheduler (SGP4 + staircase) {sched.seconds!r} s "
                  f"({sched.seconds / pipe.host_s!r}); wall {wall!r} s [{card}]")
            check(same, f"native: slice (i) use_native={use_native} bytes differ")
            res["default", use_native] = dict(host_s=pipe.host_s,
                                              sched_s=sched.seconds, wall_s=wall)

            specs, _ = load_channel_config(cfg_path, FS, use_native=use_native)
            timed = [_TimedScheduler(s.scheduler) for s in specs]
            for s, t in zip(specs, timed):
                s.scheduler = t
            mp = MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=OUT_RATE,
                                      chunk_blocks=B_MAIN, resample_stages="auto",
                                      device="cuda")
            sinks = [_Sink() for _ in specs]
            t0 = time.perf_counter()
            mp.run(io.BytesIO(slices["config4"]["raw"]), sinks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sched_s = sum(t.seconds for t in timed)
            same = [b"".join(s.parts) for s in sinks] == slices["config4"]["outs"]
            print(f"native: slice (iv) use_native={use_native}: bytes equal to "
                  f"the CLI run's={same}; host_s {mp.host_s!r} s, of which the 16 "
                  f"schedulers {sched_s!r} s ({sched_s / mp.host_s!r}); wall "
                  f"{wall!r} s [{card}]")
            check(same, f"native: slice (iv) use_native={use_native} bytes differ")
            res["config4", use_native] = dict(host_s=mp.host_s, sched_s=sched_s,
                                              wall_s=wall)
    return res


def phase_resample_probe(torch, card):
    """(e) ``tools/resample_probe.py`` on the card (the conv block, the
    window kernel and the torch ``window_dot`` at N = 2^24), then the conv
    and the window kernel at the pipeline's chunk against their plain
    versions and the library's strided ``conv1d`` (one call computing the
    same resampler, both forms' function), by one timer
    (``timed_dispatches``, 16 calls, best of 5, in turns), with their
    bounds.  Returns the probe's JSON and ``{kernel: (ms, plain_ms,
    bound_ms, bound_by, library_ms)}``."""
    from doppler_tpu_torch.ops.cuda import conv
    from doppler_tpu_torch.ops.resample import window_dot, window_resample
    from doppler_tpu_torch.tools import common, resample_probe

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = resample_probe.main(["--device", "cuda"])
    for line in err.getvalue().splitlines():
        if not line.startswith("device:"):
            print(f"resample_probe: {line}" + ("" if line.endswith("]") else f" [{card}]"))
    check(rc == 0, f"resample_probe returned {rc}")
    probe = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"resample_probe: {json.dumps(probe)} [{card}]")

    rs, xi, xq, taps, m0, M, geo = _conv_setup(torch, N_CONV, 34, 7 * N_CONV + 5)
    start0, p0, K, PADZ, TAIL = geo
    P, Q, T = rs.P, rs.Q, rs.T
    w_len, R = conv.conv_bands(Q, T)
    kw = dict(P=P, Q=Q, T=T, K=K, M=M, PADZ=PADZ, TAIL=TAIL)
    x2 = torch.nn.functional.pad(torch.stack([xi, xq]), (PADZ, TAIL))
    lo = start0 + PADZ
    xs = x2[:, lo:lo + (K + R) * Q].unsqueeze(1).contiguous()      # (2, 1, n)
    weight = torch.nn.functional.pad(taps, (0, 0, 0, R * Q - w_len)).t()
    weight = weight.unsqueeze(1).contiguous()                      # (P, 1, R·Q)

    def library():
        return torch.nn.functional.conv1d(xs, weight, stride=Q)     # (2, P, K+1)

    lib_y = library()[:, :, :K].transpose(1, 2).reshape(2, K * P)[:, p0:p0 + M]
    ker_y = torch.stack(conv.resample_conv_stream(xi, xq, taps, start0, p0, **kw))
    lib_err = (lib_y - ker_y).abs().max().item()
    print(f"conv: the library's conv1d computes the same product: max abs err "
          f"{lib_err!r} against the kernel [{card}]")
    check(lib_err <= CONV_REL * ker_y.abs().max().item(),
          "conv: the library's conv1d is not the same function")
    bank_rev = torch.from_numpy(rs.bank[:, ::-1].copy()).cuda()
    win = dict(P=P, Q=Q, T=T, M=M)
    rem0, off0 = (m0 * Q) % P, (m0 * Q) // P - (7 * N_CONV + 5)
    steps = {
        "conv": lambda: conv.resample_conv_stream(xi, xq, taps, start0, p0, **kw),
        "conv plain": lambda: conv.resample_conv_stream_plain(
            xi, xq, taps, start0, p0, **kw),
        "window": lambda: window_resample(xi, xq, bank_rev, rem0, off0, **win),
        "window plain": lambda: window_dot(xi, xq, bank_rev, rem0, off0, **win),
        "library": library,
    }
    K_disp = 16
    best = common.best_of(steps, 5, K_disp, torch.device("cuda"))
    ms = {k: v / K_disp * 1e3 for k, v in best.items()}
    res = {}
    n_bytes = 2 * 4 * (xi.numel() + M)
    for name, fma in (("conv", R * Q), ("window", T)):
        flop = 2 * 2 * fma * M
        t_b, t_f = n_bytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
        bound_ms, by = max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"
        print(f"timing: {name} kernel {ms[name]!r} ms, plain "
              f"{ms[name + ' plain']!r} ms, library conv1d {ms['library']!r} ms "
              f"a chunk of {N_CONV} inputs ({M} outputs); bound {bound_ms!r} ms "
              f"by {by} ({n_bytes} B, {flop} FLOP) [{card}]")
        res[name] = (ms[name], ms[name + " plain"], bound_ms, by, ms["library"])

    # the device time a launch at the chunk, at 2^24 and at the split tail
    def line(row):
        dev = row["device_us"]
        share = (f"{row['bound_ms'] * 1e3 / dev:.1%}" if dev
                 else "not measured")
        print(f"timing: {row['kernel']} at {row['case']}: device "
              f"{dev!r} µs a launch, {row['ms']!r} ms a call (16 calls, best of "
              f"3); bound {row['bound_ms']!r} ms by {row['bound_by']}, "
              f"{share} of it [{card}]")

    rows = resample_probe.case_times(
        torch.device("cuda"), 3, ("c3-chunk/C1", "c3-2p24/C1", "tail/C1",
                                  "tail/C256"), line)
    cases = {}
    for row in rows:
        cases.setdefault(row["kernel"], {})[row["case"]] = row["device_us"]
    return probe, res, cases


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


# bench.py's modes as phase_bench runs them: (mode, further arguments, bench.py's
# metric, the kernels a step launches: counter -> launches a step)
BENCH_RUNS = (
    ("mix", [], "nco_mix_i16_samples_per_s_chip", {"mixer": 1}),
    ("mix-pallas", [], "nco_mix_pallas_i16_samples_per_s_chip", {"mixer": 1}),
    ("chain-pallas", [], "mix_resample_chain_pallas_i16_samples_per_s_chip",
     {"chain": 1}),
    ("chain-pallas", ["--precision", "fast"],
     "mix_resample_chain_fast_i16_samples_per_s_chip", {"chain_fast": 1}),
    ("cascade-pallas", [], "mix_cascade_pallas_i16_samples_per_s_chip",
     {"cascade": 1}),
    ("split-pallas", [], "mix_split_cascade_pallas_i16_samples_per_s_chip",
     {"cascade": 1, "conv": 1}),
    ("split-xla", [], "mix_split_cascade_xla_i16_samples_per_s_chip",
     {"mixer": 1, "conv": 3}),
    ("channels-split", [], "channels16_split_cascade_i16_ch_samples_per_s_chip",
     {"cascade_channels": 1, "conv": 1}),
    ("channels-split", ["--channels", "256"],
     "channels256_split_cascade_i16_ch_samples_per_s_chip",
     {"cascade_channels": 1, "conv": 1}),
    ("chain-mesh", [], "chain_mesh_i16_samples_per_s_aggregate", None),
    ("channels-pallas", [], "channels16_pallas_chain_i16_samples_per_s_chip",
     {"chain_channels": 1}),
    ("channels-pallas", ["--precision", "fast"],
     "channels16_pallas_chain_fast_i16_samples_per_s_chip",
     {"chain_channels_fast": 1}),
    ("channels", [], "channels16_mix_resample_i16_samples_per_s_chip",
     {"mixer_channels": 1, "conv": 1}),
    ("chain", [], "mix_resample_chain_i16_samples_per_s_chip",
     {"mixer": 1, "conv": 1}),
)


# a bench counter's kernel as the profiler names it
BENCH_KERNEL_NAMES = {"mixer": "mixer_kernel", "mixer_channels": "mixer_kernel",
                      "chain": "chain_kernel", "chain_channels": "chain_kernel",
                      "chain_fast": "chain_fast_kernel",
                      "chain_channels_fast": "chain_fast_kernel",
                      "cascade": "cascade_kernel", "cascade_channels": "cascade_kernel",
                      "conv": "conv_"}


def _bench_bound(mode, fs, C, B, fast):
    """:func:`_bound` of a bench mode's function (its unfused and sharded
    forms compute the same function as the fused one), over the stages
    ``bench.build`` designs at ``fs``."""
    from doppler_tpu_torch.ops.multistage import MultiStageResampler
    from doppler_tpu_torch.ops.resample import RationalResampler

    if mode in ("mix", "mix-pallas"):
        designed = []
    elif mode == "cascade-pallas" or "split" in mode:
        designed = MultiStageResampler(fs, OUT_RATE).stages
    else:
        designed = [RationalResampler(fs, OUT_RATE)]
    stages = tuple((st.P, st.Q, st.T) for st in designed)
    return _bound(C if mode.startswith("channels") else 1, B, 8192, stages,
                  passes=3 if fast else 0)


@contextlib.contextmanager
def _plain_wrappers():
    """Every kernel wrapper that a bench step calls through its module
    (``tools/bench.py`` and ``parallel/sharded.py`` call them so) swapped
    for its plain version, which runs on the same card tensors."""
    from doppler_tpu_torch.ops.cuda import cascade, chain, conv, mixer

    swaps = ((mixer, "mix_blocks_fmt", mixer.mix_blocks_fmt_plain),
             (mixer, "mix_blocks_fmt_channels", mixer.mix_blocks_fmt_channels_plain),
             (chain, "mix_resample_chain_stream", chain.mix_resample_chain_plain),
             (chain, "mix_resample_chain_channels",
              chain.mix_resample_chain_channels_plain),
             (cascade, "mix_cascade_stream", cascade.mix_cascade_plain),
             (cascade, "mix_cascade_channels", cascade.mix_cascade_channels_plain),
             (conv, "resample_conv_stream", conv.resample_conv_stream_plain))
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, wrapper in kept:
            setattr(mod, name, wrapper)


def phase_bench(torch, card):
    """``doppler_tpu_torch.tools.bench.main`` in process for every mode of
    ``bench.py`` at 2^25 samples, each with the launch counts set to 0 just
    before and read just after; its rate against the mode's bound, the
    profiler's device µs a dispatch and the busy share; then the step at
    the size it is timed (``bench.build`` of the same arguments: the same
    inputs, the same launch layouts) against itself with every kernel
    wrapper swapped for its plain version, on the card."""
    from doppler_tpu_torch.tools import bench, common

    counters = dict(_counters(), **_tool_counters())
    K, iters, samples = 16, 4, 1 << 25
    calls = 1 + iters * (K + 1)      # the warm-up, and one untimed launch a round
    n_cards = torch.cuda.device_count()
    results, launches_bench = [], dict.fromkeys(counters, 0)
    for mode, extra, metric, per_call in BENCH_RUNS:
        name = " ".join([mode] + extra)
        fast = "fast" in extra
        C = int(extra[-1]) if "--channels" in extra else 16
        argv = ["--mode", mode, "--samples", str(samples), "--iters", str(iters),
                "--dispatches", str(K)] + extra
        out, err = io.StringIO(), io.StringIO()
        _zero_counts(counters)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(argv)
        launches = _read_counts(counters)
        for line in err.getvalue().splitlines():
            if not line.startswith("bench device:"):
                print(f"bench {name}: {line}")
        check(rc == 0, f"bench {name} returned {rc}")
        lines = out.getvalue().strip().splitlines()
        check(len(lines) == 1, f"bench {name} printed {len(lines)} lines")
        res = json.loads(lines[0])
        if per_call is None:        # chain-mesh: one launch a shard, one replay
            per_call = {"chain": 2 * n_cards - 1}   # a shard k > 0
        want = {k: per_call.get(k, 0) * calls for k in counters}
        check(launches == want, f"bench {name}: launches {launches}, want {want}")
        for k, v in launches.items():
            launches_bench[k] += v
        check(res["metric"] == metric, f"bench {name}: metric {res['metric']}")
        fs = FS_SPLIT if "split" in mode else FS
        check(res["unit"] == "samples/s" and res["vs_baseline"] == res["value"] / fs,
              f"bench {name}: {res}")
        args = bench.parse_args(argv)
        with contextlib.redirect_stderr(io.StringIO()):    # main printed it
            step, total, _, _ = bench.build(mode, args, torch.device("cuda"))
        B = total // (C if mode.startswith("channels") else 1) // bench.L
        bound_ms, by = _bench_bound(mode, fs, C, B, fast)
        bound_rate = total / (bound_ms / 1e3)
        # device µs a dispatch: every device event of a call (the torch glue
        # included) from sessions that recorded each call's once-launched
        # kernel, and each kernel's mean a launch times its launches a step
        once = [BENCH_KERNEL_NAMES[k] for k, n in per_call.items() if n == 1]
        dev_us = common.device_us(step, None, tries=5,
                                  calls_by=once[0] if once else None)
        parts = {k: common.device_us(step, BENCH_KERNEL_NAMES[k]) for k in per_call}
        parts = {k: None if us is None else us * per_call[k] for k, us in parts.items()}
        busy = None if dev_us is None else dev_us * 1e-6 * res["value"] / total
        # the timed step against itself on the plain versions, at 2^25 samples
        got = step()
        _zero_counts(counters)
        with _plain_wrappers():
            want_out = step()
        check(not any(_read_counts(counters).values()),
              f"bench {name}: the plain step launched a kernel")
        del step
        if mode == "chain-mesh":        # the time shards in stream order
            got = torch.cat([o.cpu() for o in got])
            want_out = torch.cat([o.cpu() for o in want_out])
        check(got.shape == want_out.shape, f"bench {name}: shape {tuple(got.shape)}")
        d = _lsb_diff(torch, got, want_out)
        err_lsb, frac = float(d.max()), float((d > 0).float().mean())
        exact = torch.equal(got, want_out)
        del got, want_out, d
        check(exact if mode.startswith("mix") else err_lsb <= 1 and frac < 0.01,
              f"bench {name}: step against plain: max LSB {err_lsb}, frac {frac}")
        row = dict(mode=mode, extra=extra, metric=metric, gsps=res["value"] / 1e9,
                   vs_baseline=res["vs_baseline"], bound_gsps=bound_rate / 1e9,
                   bound_by=by, share=res["value"] / bound_rate, device_us=dev_us,
                   device_us_by_kernel=parts,
                   busy=busy, max_lsb=err_lsb, frac=frac, bitwise=exact,
                   **{k: res[k] for k in ("mesh_time", "efficiency_vs_time1")
                      if k in res})
        check(row["share"] <= 1.0, f"bench {name}: {row['gsps']!r} GS/s is above "
              f"its bound {row['bound_gsps']!r} GS/s")
        print(f"bench {name}: {row['gsps']!r} GS/s, vs_baseline "
              f"{row['vs_baseline']!r}; bound {row['bound_gsps']!r} GS/s ({by}), "
              f"share {row['share']!r}; device {dev_us!r} us a dispatch of {total} "
              f"samples (kernels {parts}), busy {busy!r}; "
              f"{sum(launches.values())} launches; the step at {total} samples "
              f"against its plain versions on the card: max LSB {err_lsb:g} frac "
              f"{frac!r} bitwise {exact} [{card}]")
        results.append(row)
    print(f"bench: launches {({k: v for k, v in launches_bench.items() if v})}")
    return results, launches_bench


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
        sass = timed(phase_build)
        native_info = timed(phase_build_native, card)
        gen = torch.Generator(device="cuda").manual_seed(0)
        mix_err = timed(phase_mixer, torch, gen)
        chain_err = timed(phase_chain, torch, gen)
        cascade_err = timed(phase_cascade, torch, gen)
        channel_err = timed(phase_channels, torch, gen)
        fast_err = timed(phase_chain_fast, torch, gen)
        cfast_err = timed(phase_cascade_fast, torch, gen)
        timed(phase_probes, torch, gen)
        conv_err = timed(phase_conv, torch, card)
        slices = timed(phase_slices, torch, card)
        slices.update(timed(phase_channel_slices, torch, card))
        unfused = timed(phase_unfused, torch, card, slices)
        timed(phase_native, torch, card, slices, native_info)
        seek = timed(phase_distributed, torch, card)
        mesh_launches, _ = timed(phase_mesh, torch, card, slices)
        timed(phase_conformance)
        times = timed(phase_timing, torch, gen, card)
        times.update(timed(phase_timing_channels, torch, gen, card))
        probe_times = timed(phase_timing_probes, torch, gen, card, sass)
        _, tool_launches = timed(phase_roofline, card)
        _, bench_launches = timed(phase_bench, torch, card)
        _, resampler_times, resampler_us = timed(phase_resample_probe, torch, card)
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
              launches_channels=slices["config4-mix"]["launches"]["mixer_channels"],
              launches_seek=seek["mixer"]["mixer"],
              launches_mesh=mesh_launches["mixer"],
              launches_bench=bench_launches["mixer"],
              launches_bench_channels=bench_launches["mixer_channels"]),
        entry("chain", "chain.cu", "doppler_tpu/ops/pallas/chain.py:404",
              slices["chain"]["launches"]["chain"], chain_err,
              launches_seek=seek["chain"]["chain"],
              launches_mesh=mesh_launches["chain"],
              launches_bench=bench_launches["chain"]),
        entry("cascade", "cascade.cu", "doppler_tpu/ops/pallas/chain.py:960",
              default["cascade"], cascade_err,
              launches_seek=seek["default"]["cascade"] + seek["split"]["cascade"],
              launches_mesh=mesh_launches["cascade"],
              launches_bench=bench_launches["cascade"]),
        entry("chain_channels", "chain.cu", "doppler_tpu/ops/pallas/chain.py:556",
              slices["config4-chain"]["launches"]["chain_channels"],
              channel_err["chain"],
              launches_bench=bench_launches["chain_channels"]),
        entry("chain_fast", "chain_fast.cu", "doppler_tpu/ops/pallas/chain.py:404",
              slices["chain-fast"]["launches"]["chain_fast"], fast_err["stream"],
              branch="dot_precision='split3'",
              launches_seek=seek["chain-fast"]["chain_fast"],
              launches_bench=bench_launches["chain_fast"]),
        entry("chain_channels_fast", "chain_fast.cu",
              "doppler_tpu/ops/pallas/chain.py:556",
              slices["config4-chain-fast"]["launches"]["chain_channels_fast"],
              fast_err["channels"], branch="dot_precision='split3'",
              launches_bench=bench_launches["chain_channels_fast"]),
        entry("cascade_channels", "cascade.cu",
              "doppler_tpu/ops/pallas/chain.py:1078",
              config4["cascade_channels"], channel_err["cascade"],
              launches_mesh=mesh_launches["cascade_channels"],
              launches_bench=bench_launches["cascade_channels"]),
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
        # the resampler's two forms, XLA functions in the JAX package (no
        # Pallas kernel); times at the pipeline's chunk, the library's
        # strided conv1d beside them (phase_resample_probe).  The window
        # kernel's launches are slice (i)'s EOF chunk (one a stage), its
        # error the largest against its plain version on phase 4g's chunk
        # and split tails;
        # device_us: the profiler's µs a launch by case (phase 6c)
        dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                 resampler_times["window"]),
             name="window", route="cuda", source="doppler_tpu_torch/csrc/window.cu",
             replaces="doppler_tpu/ops/resample.py:61", launches=default["window"],
             max_abs_err=max(conv_err["window plain"], conv_err["window tail"]),
             launches_unfused=unfused["chain-xla"]["launches"]["window"],
             device_us=resampler_us["window"]),
        dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                 resampler_times["conv"]),
             name="conv", route="cuda", source="doppler_tpu_torch/csrc/conv.cu",
             replaces="doppler_tpu/ops/resample.py:96",
             launches=unfused["chain-xla-conv"]["launches"]["conv"],
             max_abs_err=max(conv_err["plain (cuBLAS)"], conv_err["conv tail"]),
             launches_mesh=unfused["chain-xla-conv"]["launches_mesh"]["conv"],
             launches_bench=bench_launches["conv"],
             device_us=resampler_us["conv"],
             library_device_us=resampler_us["conv1d"]),
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
