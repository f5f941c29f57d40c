"""Steady-state dispatch timing: the one scaffold of the measuring tools.

Counterpart of ``doppler_tpu/runtime/timing.py``.  Each timed iteration
issues K back-to-back launches on the current CUDA stream between two CUDA
events and synchronizes ONCE, so the host's enqueue of launch k + 1 hides
behind the device's run of launch k, as it does in the production pipeline,
and the events read device time on the stream's own clock.  The JAX file
adds a value-dependent scalar readback after the K dispatches because its
rig's completion signal could not be trusted; CUDA events need no such
readback, so it has no counterpart here.

On the CPU (``device.type == 'cpu'``, the tests) the same K calls are timed
with the wall clock; that number says nothing about a card.
"""

from __future__ import annotations

import subprocess
import time

import torch

__all__ = ["timed_dispatches", "card_label"]


def timed_dispatches(step, K: int, device="cuda") -> float:
    """Seconds for K back-to-back calls of ``step()``.

    ``step`` is a zero-argument callable that enqueues its work on the
    current stream of ``device`` (callers bind their inputs in the closure).
    """
    device = torch.device(device)
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(K):
            step()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        for _ in range(K):
            step()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3


def card_label(device) -> str:
    """What a measurement ran on: the card's name and power limit as
    ``nvidia-smi`` prints them (the name alone where ``nvidia-smi`` does not
    answer), or ``cpu``."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return name
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else name
