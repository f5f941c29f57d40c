"""Checkpoint / resume — "resume = seek" made concrete.

The format of ``doppler_tpu/runtime/checkpoint.py``, key for key, so a file
written by either package loads in the other: a single ``.npz`` holding a
``meta`` JSON byte array and the resampler state arrays.  The filter bank is
designed, not stored (``ops.filters``), so what makes a run resumable is

- the NCO counter + absolute stream offset (``ops.phase_plan.NCOState``),
- the scheduler's staircase state (track mode: sample_count/dt/last_time),
- each resampler stage's next-output index and T−1-sample FIR history
  (``rs_*`` for a stream, ``g{k}_*`` per rate group of a channels run, with
  ``s{j}_`` per cascade stage; ``(C, T−1)`` histories for channels),
- the input sample at which to resume feeding the stream.

The fused kernels' carries are NOT stored: they reseed from the resampler
histories on the next chunk, which is what makes the fused and unfused
routes, and the two packages, checkpoint-interoperable.  Restarting a
recorded stream at a chunk boundary reproduces the uninterrupted output
bitwise (``tests/test_torch_checkpoint.py``).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np

from doppler_tpu_torch.ops.phase_plan import NCOState

__all__ = ["save", "restore", "save_channels", "restore_channels"]

_VERSION = 1
_RS_KEYS = ("samplerate", "intype", "outtype", "block_bytes")


def _savez_exact(path, arrays: dict) -> None:
    """np.savez at the EXACT path: given a filename, np.savez appends
    '.npz' unless it already ends with it — write through a file object
    instead.  File-like objects pass straight through."""
    if isinstance(path, (str, bytes, os.PathLike)):
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    else:
        np.savez(path, **arrays)


def _arrays(src) -> tuple[dict, dict]:
    """A checkpoint (path, binary file object, or the mapping of its
    arrays) → (arrays, metadata)."""
    if isinstance(src, Mapping):
        z = {k: np.asarray(v) for k, v in src.items()}
    elif isinstance(src, (str, bytes, os.PathLike)) or hasattr(src, "read"):
        if hasattr(src, "seek"):
            src.seek(0)
        with np.load(src) as f:
            z = {k: f[k] for k in f.files}
    else:
        raise TypeError(f"cannot read a checkpoint from {type(src).__name__}")
    return z, json.loads(bytes(z["meta"].tobytes()).decode())


def _scheduler_state(s) -> dict:
    return {key: getattr(s, key)
            for key in ("sample_count", "dt", "last_time") if hasattr(s, key)}


def _scheduler_sig(s) -> dict:
    """Identity of the DSP configuration the counters belong to (the
    shift/mode/track parameters): resuming a ``--shift -15000`` checkpoint
    with another shift would match no uninterrupted run."""
    sig: dict = {"kind": type(s).__name__}
    for key in ("shift_hz", "frequency_hz", "offset_hz", "start_time"):
        if hasattr(s, key):
            sig[key] = float(getattr(s, key))
    tle = getattr(getattr(s, "predictor", None), "tle", None)
    if tle is not None:
        sig["tlename"] = getattr(tle, "name", None)
    return sig


def _resampler_sig(rs):
    """``[P, Q, T]`` per stage (one for a single-stage resampler), None
    without one — pins the --resample-to/--resample-stages configuration."""
    if rs is None:
        return None
    return [[st.P, st.Q, st.T] for st in getattr(rs, "stages", [rs])]


def _check_sig(meta: dict, key: str, current, what: str) -> None:
    if key in meta and meta[key] != current:
        raise ValueError(
            f"checkpoint {what} {meta[key]!r} does not match the "
            f"pipeline's {current!r} — resuming with a different "
            "configuration would produce output matching no "
            "uninterrupted run")


def _check_stream_keys(meta: dict, pipe) -> None:
    for key in _RS_KEYS:
        if meta[key] != getattr(pipe, key):
            raise ValueError(
                f"checkpoint {key}={meta[key]!r} does not match "
                f"pipeline {getattr(pipe, key)!r}")


def _load_scheduler_state(s, state: dict) -> None:
    for key, val in state.items():
        if hasattr(s, key):
            setattr(s, key, type(getattr(s, key))(val))


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save(path, pipe) -> None:
    """Snapshot a Pipeline's resumable state to ``path`` (.npz; a path or
    a binary file object)."""
    meta = {
        "version": _VERSION,
        "samplerate": pipe.samplerate,
        "intype": pipe.intype,
        "outtype": pipe.outtype,
        "block_bytes": pipe.block_bytes,
        "nco_samplenum": pipe.nco_state.samplenum,
        "nco_abs_offset": pipe.nco_state.abs_offset,
        "sample_offset": pipe._sample_offset,
        "scheduler": _scheduler_state(pipe.scheduler),
        "scheduler_sig": _scheduler_sig(pipe.scheduler),
        "has_resampler": pipe.resampler is not None,
        "resampler_sig": _resampler_sig(pipe.resampler),
        # True when the checkpointed run reached EOF and flushed the FIR
        # tail: a restart must not run (and drain) again
        "drained": bool(pipe._drained),
    }
    arrays = {"meta": _meta_array(meta)}
    if pipe.resampler is not None:
        # generic over state_dict keys so single- and multi-stage resamplers
        # both round-trip; integers become 0-d arrays
        for key, val in pipe.resampler.state_dict().items():
            arrays[f"rs_{key}"] = np.asarray(val)
    _savez_exact(path, arrays)


def restore(src, pipe) -> dict:
    """Load a stream snapshot into a compatibly-configured Pipeline.

    ``src``: a path or binary file object holding the ``.npz``, or the
    mapping of its arrays.  Returns the metadata dict; its ``sample_offset``
    is the absolute input sample at which to resume feeding the stream.
    Raises ``ValueError`` when the checkpoint belongs to another
    configuration (rates, formats, scheduler, resampler stages) or is not a
    single-stream checkpoint.
    """
    z, meta = _arrays(src)
    if meta.get("version") != _VERSION or meta.get("kind") == "channels":
        raise ValueError("not a single-stream checkpoint "
                         f"(version {meta.get('version')!r})")
    _check_stream_keys(meta, pipe)
    _check_sig(meta, "scheduler_sig", _scheduler_sig(pipe.scheduler),
               "scheduler config")
    if meta.get("resampler_sig") is not None:
        # (a resampler-less checkpoint restoring into a pipeline with a
        # FRESH resampler stays allowed; a recorded resampler must match)
        _check_sig(meta, "resampler_sig", _resampler_sig(pipe.resampler),
                   "resampler config")
    pipe.nco_state = NCOState(
        samplenum=int(meta["nco_samplenum"]),
        abs_offset=int(meta["nco_abs_offset"]),
    )
    pipe._sample_offset = int(meta["sample_offset"])
    _load_scheduler_state(pipe.scheduler, meta["scheduler"])
    if meta["has_resampler"]:
        if pipe.resampler is None:
            raise ValueError("checkpoint has resampler state but pipeline has none")
        pipe.resampler.load_state(
            {name[len("rs_"):]: z[name] for name in z if name.startswith("rs_")})
        # the fused kernels reseed their carries from the loaded histories
        pipe.drop_carries()
    return meta


def save_channels(path, mpipe) -> None:
    """Snapshot a MultiChannelPipeline.

    Per channel: the NCO counter pair and the scheduler staircase.  Per
    rate group: the batched resampler's (m_next, in_consumed, FIR
    histories).
    """
    meta = {
        "version": _VERSION,
        "kind": "channels",
        "samplerate": mpipe.samplerate,
        "intype": mpipe.intype,
        "outtype": mpipe.outtype,
        "block_bytes": mpipe.block_bytes,
        "samples_in": mpipe.samples_in,
        "channels": [
            {
                "name": ch.name,
                "nco_samplenum": ch.state.samplenum,
                "nco_abs_offset": ch.state.abs_offset,
                "scheduler": _scheduler_state(ch.scheduler),
                "scheduler_sig": _scheduler_sig(ch.scheduler),
                "center_offset_hz": float(ch.center_offset_hz),
            }
            for ch in mpipe.channels
        ],
        "groups": [list(idxs) for idxs, _ in mpipe._groups],
        "group_sigs": [_resampler_sig(rs) for _, rs in mpipe._groups],
        # True when the run reached EOF and flushed the per-channel FIR
        # tails — a restart must not run (and drain) again
        "drained": bool(mpipe._drained),
    }
    arrays = {"meta": _meta_array(meta)}
    for g, (_, rs) in enumerate(mpipe._groups):
        if rs is None:
            continue
        for key, val in rs.state_dict().items():
            arrays[f"g{g}_{key}"] = np.asarray(val)
    _savez_exact(path, arrays)


def restore_channels(src, mpipe) -> dict:
    """Load a channels-mode snapshot into a compatibly-configured pipeline.

    ``src`` as in :func:`restore`.  Returns the metadata dict
    (``samples_in`` is the absolute input sample at which the caller should
    resume feeding the wideband stream).
    """
    z, meta = _arrays(src)
    if meta.get("version") != _VERSION or meta.get("kind") != "channels":
        raise ValueError("not a channels-mode checkpoint")
    _check_stream_keys(meta, mpipe)
    names_ckpt = [c["name"] for c in meta["channels"]]
    names_pipe = [ch.name for ch in mpipe.channels]
    if names_ckpt != names_pipe:
        raise ValueError(
            f"channel set changed: checkpoint {names_ckpt} vs "
            f"config {names_pipe}")
    if meta["groups"] != [list(idxs) for idxs, _ in mpipe._groups]:
        raise ValueError("rate grouping changed since checkpoint")
    if "group_sigs" in meta:
        cur = [_resampler_sig(rs) for _, rs in mpipe._groups]
        if meta["group_sigs"] != cur:
            raise ValueError(
                "resampler configuration changed since checkpoint "
                f"({meta['group_sigs']!r} vs {cur!r})")
    for ch, st in zip(mpipe.channels, meta["channels"]):
        _check_sig(st, "scheduler_sig", _scheduler_sig(ch.scheduler),
                   f"channel {ch.name!r} scheduler config")
        if ("center_offset_hz" in st
                and st["center_offset_hz"] != float(ch.center_offset_hz)):
            raise ValueError(
                f"channel {ch.name!r} center offset changed since "
                "checkpoint")
    # every check passed: only now touch the pipeline
    for ch, st in zip(mpipe.channels, meta["channels"]):
        ch.state.samplenum = int(st["nco_samplenum"])
        ch.state.abs_offset = int(st["nco_abs_offset"])
        _load_scheduler_state(ch.scheduler, st["scheduler"])
    mpipe.samples_in = int(meta["samples_in"])
    for g, (_, rs) in enumerate(mpipe._groups):
        prefix = f"g{g}_"
        rstate = {name[len(prefix):]: z[name]
                  for name in z if name.startswith(prefix)}
        if rs is None:
            if rstate:
                raise ValueError(f"checkpoint group {g} has resampler "
                                 "state but pipeline group has none")
            continue
        if not rstate:
            raise ValueError(f"checkpoint group {g} missing resampler state")
        rs.load_state(rstate)
    mpipe.drop_carries()    # reseed from the restored histories
    return meta
