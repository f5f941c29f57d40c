"""Carry a run's state across from the JAX package.

Both packages write the same checkpoint format
(``doppler_tpu/runtime/checkpoint.py`` and
:mod:`doppler_tpu_torch.runtime.checkpoint`, key for key), and the filter
bank is designed, not stored, so converting a checkpoint is loading it:
:func:`load_jax_checkpoint` reads a single-stream checkpoint written by
``doppler_tpu.runtime.checkpoint.save`` into this package's
:class:`~doppler_tpu_torch.runtime.pipeline.Pipeline`, and
:func:`load_jax_channels_checkpoint` one written by ``save_channels`` into a
:class:`~doppler_tpu_torch.runtime.channels.MultiChannelPipeline`, each with
the signature checks the JAX ``restore`` applies.  The other direction needs
nothing here: the JAX package's ``restore`` / ``restore_channels`` load what
this package's ``save`` / ``save_channels`` write.
"""

from __future__ import annotations

from doppler_tpu_torch.runtime import checkpoint

__all__ = ["load_jax_checkpoint", "load_jax_channels_checkpoint"]


def load_jax_checkpoint(arrays_or_path, pipe) -> dict:
    """Load a ``doppler_tpu`` stream checkpoint into ``pipe``.

    ``arrays_or_path``: a path or binary file object holding the ``.npz``,
    or the mapping of its arrays.  Returns the metadata dict; its
    ``sample_offset`` is the absolute input sample at which to resume
    feeding the stream.  Raises ``ValueError`` when the checkpoint belongs
    to another configuration (scheduler, resampler stages) or is not a
    single-stream checkpoint.
    """
    return checkpoint.restore(arrays_or_path, pipe)


def load_jax_channels_checkpoint(arrays_or_path, mpipe) -> dict:
    """Load a ``doppler_tpu`` channels checkpoint into ``mpipe``; its
    ``samples_in`` is the wideband input sample at which to resume."""
    return checkpoint.restore_channels(arrays_or_path, mpipe)
