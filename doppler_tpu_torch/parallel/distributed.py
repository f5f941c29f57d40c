"""Multi-process stream partitioning: hosts split the capture, zero traffic.

The torch statement of ``doppler_tpu/parallel/distributed.py``.  Every
per-sample quantity of the pipeline is a pure function of absolute stream
position (the NCO phase through the host-emulated counter, the resampler's
output alignment through absolute indices, the FIR history through the
samples before), so "resume = seek" also means "distribute = seek": hosts
split the capture by chunk-aligned byte ranges, each seeds its state
exactly at its boundary (``Pipeline.seek_to_block``) from history blocks it
reads straight from the file, and no data moves between hosts.

- every host calls :func:`init`, which joins a ``torch.distributed`` gloo
  group.  The group is a rendezvous only: nothing is sent through it, and
  gloo works on the CPU and beside any number of ranks on one card, where
  NCCL refuses two ranks on one device;
- :func:`host_slice` computes which (channel, time-block) range this host
  owns, channel-major first (channels are embarrassingly parallel), then
  time blocks;
- ``HostShard.byte_range`` turns the block range into input-file offsets,
  so per-host readers are independent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["init", "shutdown", "resolve_spec", "host_slice", "HostShard",
           "parse_distributed_spec"]


def parse_distributed_spec(text: str) -> dict:
    """Parse ``--distributed coordinator=H:P,num_processes=N,process_id=K``.

    Any key may be omitted and falls back to the environment
    (:func:`resolve_spec`).
    """
    out: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"{part!r} isn't a valid --distributed entry "
                "(want coordinator=HOST:PORT,num_processes=N,process_id=K)"
            )
        key, val = part.split("=", 1)
        key = key.strip()
        if key == "coordinator":
            out["coordinator_address"] = val.strip()
        elif key in ("num_processes", "process_id"):
            try:
                out[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"--distributed {key} must be an integer"
                ) from None
        else:
            raise ValueError(f"unknown --distributed key {key!r}")
    return out


def resolve_spec(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None) -> dict:
    """Fill the keys a spec left out from ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (the variables ``torchrun`` sets); a run of
    one process needs none.  Raises ``ValueError`` for a spec that cannot
    form a group."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"--distributed process_id {process_id} must lie in "
            f"[0, num_processes={num_processes})")
    if num_processes > 1 and not coordinator_address:
        raise ValueError("--distributed needs coordinator=HOST:PORT (or "
                         "MASTER_ADDR and MASTER_PORT)")
    return {"coordinator_address": coordinator_address,
            "num_processes": num_processes, "process_id": process_id}


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Join the process group (no-op when single-process).  Blocks until
    all ``num_processes`` have joined."""
    spec = resolve_spec(coordinator_address, num_processes, process_id)
    if spec["num_processes"] <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{spec['coordinator_address']}",
        world_size=spec["num_processes"], rank=spec["process_id"])


def shutdown() -> None:
    """Leave the process group :func:`init` joined, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _group() -> tuple[int, int]:
    """(process index, process count) of the joined group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class HostShard:
    """This host's slice of a (C channels × B blocks) capture."""

    channel_lo: int
    channel_hi: int
    block_lo: int
    block_hi: int

    def byte_range(self, block_bytes: int) -> tuple[int, int]:
        return self.block_lo * block_bytes, self.block_hi * block_bytes


def host_slice(
    n_channels: int,
    n_blocks: int,
    *,
    process_index: int | None = None,
    process_count: int | None = None,
    channel_parallel_hosts: int | None = None,
) -> HostShard:
    """Partition (channels × blocks) across hosts, channel-major.

    With H hosts and ``channel_parallel_hosts = Hc`` (default: as many as
    divide the channel count), hosts form an (Hc × Ht) grid: channels split
    over Hc (zero communication), time blocks over Ht = H/Hc (history read
    straight from the shared capture — still zero communication).  The
    process index and count default to the joined group's, else 0 and 1.
    """
    gi, gc = _group()
    pi = gi if process_index is None else process_index
    pc = gc if process_count is None else process_count
    hc = channel_parallel_hosts
    if hc is None:
        hc = 1
        for cand in range(min(pc, n_channels), 0, -1):
            if pc % cand == 0 and n_channels % cand == 0:
                hc = cand
                break
    if pc % hc:
        raise ValueError(f"channel_parallel_hosts={hc} must divide host count {pc}")
    ht = pc // hc
    ci, ti = pi % hc, pi // hc
    cs = n_channels // hc
    bs = n_blocks // ht
    return HostShard(
        channel_lo=ci * cs,
        channel_hi=(ci + 1) * cs if ci < hc - 1 else n_channels,
        block_lo=ti * bs,
        block_hi=(ti + 1) * bs if ti < ht - 1 else n_blocks,
    )
