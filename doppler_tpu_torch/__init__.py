"""doppler_tpu_torch — the PyTorch + CUDA port of ``doppler_tpu``.

Corrects Doppler shift in IQ sample streams on one NVIDIA GPU (written for
the H100, ``sm_90a``).  The host compiles the reference's samplenum counter
into per-block plan words ``(D, C1, C2, t)``; the device decodes, computes
an exact Q0.64 phase, builds the tone, rotates, optionally runs a
polyphase FIR resampler (single-stage or a multi-stage cascade), and
encodes — in three hand-written CUDA kernels (mixer, chain, cascade), each
with a channel axis for N channels out of one wideband capture.

Subpackages
-----------
- ``doppler_tpu_torch.ops``      — codecs, the NCO and resampler in plain
                                   torch, and the CUDA kernel wrappers
                                   (``ops.cuda``; sources in ``csrc/``).
- ``doppler_tpu_torch.orbit``    — TLE parsing, SGP4/SDP4, Doppler schedules.
- ``doppler_tpu_torch.runtime``  — stream framing, the single-stream and the
                                   multi-channel pipeline, checkpoints,
                                   telemetry.
- ``doppler_tpu_torch.oracle``   — NumPy golden model of the reference binary.
- ``doppler_tpu_torch.convert``  — load a ``doppler_tpu`` checkpoint.
- ``doppler_tpu_torch.cli``      — ``const`` / ``track`` / ``channels`` command
                                   line.

The package imports torch and NumPy only; it never imports jax or
``doppler_tpu``.  The host layers it shares with ``doppler_tpu`` are copies.
"""

__version__ = "0.1.0"
