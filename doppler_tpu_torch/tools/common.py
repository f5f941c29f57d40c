"""What the timing tools share: the bench inputs and the timing loop."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.runtime.pipeline import resolve_device
from doppler_tpu_torch.runtime.timing import card_label, timed_dispatches

__all__ = ["FS", "OUT_RATE", "L", "add_common_args", "bench_inputs",
           "channel_plans", "open_device", "best_of", "device_us", "card_label"]

FS = 1_024_000      # config 3's input rate
OUT_RATE = 48_000
L = 2048            # the reference block of i16 input (8192 bytes)


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--samples", type=int, default=1 << 25)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--dispatches", type=int, default=64)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) fails without a card; cpu runs the "
                         "kernels' plain versions, which measures no card")


def bench_inputs(samples: int, device: torch.device, fs: int = FS, L: int = L):
    """The JAX tools' data and plan (``tools/roofline.py:86-96``,
    ``bench.py:128-132``): ``(B, L)`` int32 words from NumPy seed ``0xBE``,
    ``B = max(1, samples // L)``, and the plan words of shifts
    ``9000 − 0.01·k`` Hz at ``fs`` (1.024 Msps unless given).  ``L`` is the
    port tools' 2048 unless given (``bench.py`` takes 8192).  Returns
    ``(words, plans, B)`` on ``device``."""
    B = max(1, samples // L)
    rng = np.random.default_rng(0xBE)
    words = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                         dtype=np.int64).astype(np.int32)
    plans = channel_plans(lambda c, k: 9000.0 - 0.01 * k, 1, B, fs, device, L)
    return torch.from_numpy(words).to(device), plans[:, 0], B


def channel_plans(shift, C: int, B: int, fs: int, device: torch.device,
                  L: int = L) -> torch.Tensor:
    """``(7, C, B)`` plan words: block k of channel c shifted by
    ``shift(c, k)`` Hz, every channel from a fresh ``NCOState``."""
    return torch.stack([
        nco.plan_tensor(plan_blocks([shift(c, k) for k in range(B)], [L] * B,
                                    fs, NCOState(), L))
        for c in range(C)], dim=1).to(device)


def open_device(name: str) -> tuple[torch.device, str]:
    """The device a tool was asked for (raises without a card unless it is
    ``cpu``) and the label its lines carry."""
    device = resolve_device(name)
    label = card_label(device)
    print(f"device: {label}", file=sys.stderr)
    return device, label


def best_of(steps: dict, iters: int, K: int, device: torch.device,
            on_time=None) -> dict:
    """Warm every step once, then ``iters`` rounds over all steps in turn
    (interleaved, so a drift of the card's clocks falls on all alike);
    returns each step's least seconds for K dispatches."""
    for step in steps.values():
        step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    best = {name: float("inf") for name in steps}
    for it in range(iters):
        for name, step in steps.items():
            dt = timed_dispatches(step, K, device)
            best[name] = min(best[name], dt)
            if on_time is not None:
                on_time(it, name, dt)
    return best


_SPIN = "spin_kernel"    # torch.cuda._sleep's kernel
_SPINS = 32              # spin kernels that open a profiler session


def device_us(step, match: str | None, runs: int = 10, tries: int = 3,
              calls_by: str | None = None):
    """Mean device µs of ``step()``'s kernels whose name holds ``match`` (a
    launch), or of all its device work summed (a call) where ``match`` is
    None, over ``runs`` calls, from ``torch.profiler``; None when none of
    ``tries`` sessions recorded a complete set (a session can record none).
    A session can also lose records: the first 1–3 of it once other
    sessions have run in the process (seen on the H100), and now and then
    whole calls'.  Spin kernels, left out of the sums, take the first
    places; with ``calls_by``, the name of a kernel that ``step`` launches
    once, a session whose records hold another count of it than ``runs``
    is taken as incomplete and tried again."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    for _ in range(tries):
        # an empty session first: what a previous session left behind lands
        # there, not in the one that is read
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(_SPINS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(runs):
                step()
            torch.cuda.synchronize()
        total, count, seen = 0.0, 0, 0
        for ev in prof.key_averages():
            if (getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA
                    or _SPIN in ev.key):
                continue
            ours = "at::native" not in ev.key
            if calls_by is not None and calls_by in ev.key and ours:
                seen += ev.count
            if match is not None and (match not in ev.key or not ours):
                continue
            total += (getattr(ev, "device_time_total", None)
                      or getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
        complete = calls_by is None or seen == runs
        if total > 0 and complete:
            return total / (runs if match is None else count)
    return None
