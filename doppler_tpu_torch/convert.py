"""Carry a stream's state across from the JAX package.

The filter bank is designed, not stored (``ops.filters``), so the state that
makes a run resumable is all there is to convert: the NCO counter and stream
offset, the scheduler's staircase counters, and each resampler stage's next
output index and T−1-sample FIR history.  :func:`load_jax_checkpoint` reads
the single-stream checkpoint ``doppler_tpu.runtime.checkpoint.save`` writes
(``doppler_tpu/runtime/checkpoint.py:94-120``: a ``meta`` JSON array plus
``rs_m_next``, ``rs_in_consumed``, ``rs_hist_i``, ``rs_hist_q`` for a
single-stage resampler, or ``rs_s{k}_m_next`` … ``rs_s{k}_hist_q`` per stage
of a cascade) into this package's
:class:`~doppler_tpu_torch.runtime.pipeline.Pipeline`, with the signature
checks ``checkpoint.restore`` applies.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np

from doppler_tpu_torch.ops.phase_plan import NCOState

__all__ = ["load_jax_checkpoint"]

_VERSION = 1


def _scheduler_sig(s) -> dict:
    """Identity of the DSP configuration the counters belong to — the same
    fields the JAX checkpoint records (shift/mode/track parameters)."""
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


def _arrays(src) -> dict:
    if isinstance(src, Mapping):
        return {k: np.asarray(v) for k, v in src.items()}
    if isinstance(src, (str, bytes, os.PathLike)) or hasattr(src, "read"):
        if hasattr(src, "seek"):
            src.seek(0)
        with np.load(src) as z:
            return {k: z[k] for k in z.files}
    raise TypeError(f"cannot read a checkpoint from {type(src).__name__}")


def load_jax_checkpoint(arrays_or_path, pipe) -> dict:
    """Load a ``doppler_tpu`` stream checkpoint into ``pipe``.

    ``arrays_or_path``: a path or binary file object holding the ``.npz``,
    or the mapping of its arrays.  Returns the metadata dict; its
    ``sample_offset`` is the absolute input sample at which to resume
    feeding the stream.  Raises ``ValueError`` when the checkpoint belongs
    to another configuration (scheduler, resampler stages) or is not a
    single-stream checkpoint.
    """
    z = _arrays(arrays_or_path)
    meta = json.loads(bytes(z["meta"].tobytes()).decode())
    if meta.get("version") != _VERSION or meta.get("kind") == "channels":
        raise ValueError("not a doppler_tpu single-stream checkpoint "
                         f"(version {meta.get('version')!r})")
    for key in ("samplerate", "intype", "outtype", "block_bytes"):
        if meta[key] != getattr(pipe, key):
            raise ValueError(
                f"checkpoint {key}={meta[key]!r} does not match "
                f"pipeline {getattr(pipe, key)!r}"
            )
    _check_sig(meta, "scheduler_sig", _scheduler_sig(pipe.scheduler),
               "scheduler config")
    if meta.get("resampler_sig") is not None:
        _check_sig(meta, "resampler_sig", _resampler_sig(pipe.resampler),
                   "resampler config")
    pipe.nco_state = NCOState(
        samplenum=int(meta["nco_samplenum"]),
        abs_offset=int(meta["nco_abs_offset"]),
    )
    pipe._sample_offset = int(meta["sample_offset"])
    for key, val in meta["scheduler"].items():
        if hasattr(pipe.scheduler, key):
            setattr(pipe.scheduler, key, type(getattr(pipe.scheduler, key))(val))
    if meta["has_resampler"]:
        if pipe.resampler is None:
            raise ValueError("checkpoint has resampler state but pipeline has none")
        pipe.resampler.load_state(
            {name[len("rs_"):]: z[name] for name in z if name.startswith("rs_")})
        # the fused kernels reseed their carries from the loaded histories
        pipe._chain_carry = None
        pipe._cascade_carries = None
    return meta
