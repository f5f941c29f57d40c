"""A configuration's recorded capture, made from the seed.

The capture is what the receiver would have recorded: each channel's
downlink as tones a little off the channel's frequency, over white noise,
quantized to the interleaved i16 pairs that ``rtl_fm -M raw`` writes.  The
tones sit on the capture's frequency grid (``fs / samples``), so the
capture repeats seamlessly when it is replayed in a loop.  The seed picks
the tones' offsets and phases and the noise; the sizes, the channels and
every amount of work are the configuration's and the same for every seed.

Made on the device in a few calls (one inverse FFT, one draw of noise) with
a ``torch.Generator`` on that device, then copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.schedule import expand_channels

__all__ = ["make_capture"]


def _tone_center(channel: dict) -> float:
    """Where a channel's downlink sits in the capture (Hz): a constant
    channel at its shift, a tracked one at its offset (the Doppler swing
    moves it by a few kHz around that), plus its center offset."""
    base = channel["shift"] if "shift" in channel else \
        channel["track"].get("offset", 0.0)
    return float(base) + float(channel.get("center_offset", 0.0))


def make_capture(config: dict, seed: int, device) -> torch.Tensor:
    """``(samples, 2)`` int16 capture (I, Q) on ``device``."""
    cap = config["capture"]
    n = int(cap["samples"])
    fs = float(config["samplerate"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    freqs = []
    for ch in expand_channels(config):
        freqs += [_tone_center(ch)] * int(cap["tones_per_channel"])
    f0 = torch.tensor(freqs, dtype=torch.float64, device=dev)
    lo, hi = cap["tone_band_hz"]
    u = torch.rand(f0.shape, generator=gen, device=dev, dtype=torch.float64)
    bins = torch.remainder(torch.round((f0 + lo + (hi - lo) * u) / fs * n),
                           n).to(torch.int64)
    phase = 2.0 * np.pi * torch.rand(f0.shape, generator=gen, device=dev,
                                     dtype=torch.float64)
    spec = torch.zeros(n, dtype=torch.complex128, device=dev)
    spec.index_put_((bins,), cap["tone_amplitude"] * n * torch.exp(1j * phase),
                    accumulate=True)
    x = torch.fft.ifft(spec.to(torch.complex64))
    del spec
    noise = torch.randn((2, n), generator=gen, device=dev) * cap["noise_rms"]
    planes = torch.stack([x.real + noise[0], x.imag + noise[1]], dim=1)
    return torch.round(planes * 32767.0).clamp(-32768, 32767).to(torch.int16)
