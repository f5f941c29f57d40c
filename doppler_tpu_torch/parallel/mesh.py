"""Device meshes for time × channel sharding.

The torch statement of ``doppler_tpu/parallel/mesh.py``.  The stream maps
onto a 2-D logical grid of devices:

- ``'time'``    — shards the blocks of a chunk.  Exact for the mixer (the
  phase is per-block plan words); the FIR stages rebuild their history at
  a shard's left edge by replaying the neighbour's last raw blocks
  (``parallel.sharded``).
- ``'channel'`` — shards independent satellite channels (channels mode).

The JAX mesh is process-local and driven by one process (``shard_map``):
each host runs its own mesh over its own chips, and hosts split by stream
range (``parallel.distributed``).  The counterpart here is one process that
holds a ``(channel, time)`` grid of torch devices and launches each shard's
kernels on its device; it is not a process group, and nothing moves between
shards but the carry a chunk hands to the next.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Mesh", "make_mesh", "shard_slices"]


@dataclass(frozen=True)
class Mesh:
    """A ``(channel, time)`` grid of torch devices."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        """``{"channel": c, "time": t}``, as JAX's ``mesh.shape``."""
        return {"channel": len(self.devices), "time": len(self.devices[0])}

    def device(self, channel: int = 0, time: int = 0) -> torch.device:
        return self.devices[channel][time]

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        seen: list[torch.device] = []
        for row in self.devices:
            for dev in row:
                if dev not in seen:
                    seen.append(dev)
        return seen


def _normalise(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(time: int = 1, channel: int = 1, devices=None, *,
              device="cuda") -> Mesh:
    """Build a ``(channel, time)`` mesh.

    ``devices`` defaults to the distinct local cards ``cuda:0 … cuda:n−1``
    when ``device`` is ``'cuda'``, and to the CPU for every shard when it
    is ``'cpu'``.  An explicit ``devices`` list may name one device more
    than once: several shards then share it, which is how the tests and
    ``chip_smoke.py`` run a mesh on one card (as the JAX tests run one on
    fake CPU devices); it gives the same bytes and no speed.
    """
    if time < 1 or channel < 1:
        raise ValueError("mesh axes must be >= 1")
    need = time * channel
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(count)]
        elif kind == "cpu":
            devices = [torch.device("cpu")] * need
        else:
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    devices = [_normalise(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = tuple(tuple(devices[c * time:(c + 1) * time]) for c in range(channel))
    return Mesh(grid)


def shard_slices(mesh: Mesh, C: int, B: int):
    """Each shard's ``(device, channel slice, block slice)`` for ``C``
    channels of a ``B``-block chunk, channel shards outer, time shards in
    stream order inner.  ``C`` and ``B`` must divide over the mesh."""
    n_chan, n_time = mesh.shape["channel"], mesh.shape["time"]
    if C % n_chan or B % n_time:
        raise ValueError(f"{C} channels × {B} blocks do not divide over mesh "
                         f"channel={n_chan} time={n_time}")
    c_loc, b_loc = C // n_chan, B // n_time
    return [(mesh.device(c, t), slice(c * c_loc, (c + 1) * c_loc),
             slice(t * b_loc, (t + 1) * b_loc))
            for c in range(n_chan) for t in range(n_time)]
