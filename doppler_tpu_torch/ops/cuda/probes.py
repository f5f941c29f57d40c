"""Roofline probes: the mixer's and the chain's traffic with their work taken
away step by step.  ``tools/roofline.py`` and
``tools/probe_chain_precision.py`` time them beside the product kernels.

Each wrapper launches ``csrc/probes.cu`` on a CUDA tensor and runs its
``_plain`` twin on a CPU tensor; any other device raises.

- :func:`probe_elementwise` (port of ``tools/roofline.py:130``
  ``pallas_elementwise(...).run``): ``out = body(words)`` over int32 words,
  8 B/sample.  ``body='copy'`` is the identity; ``body='codec'`` decodes
  (×1/32768) and encodes (×32767, truncate, clip, pack) with no NaN guard,
  as the TPU body has it — a decoded i16 is never NaN, so the bytes equal
  ``ops.codec``'s.  ``vec`` is the int32 words per thread access, 1 or 4
  (4- or 16-byte loads and stores): the card's counterpart of the TPU tool's
  tile-size sweep.
- :func:`chain_shape_run` (port of ``tools/roofline.py:262``
  ``chain_shape_run(...).run``): the chunk is cut into tiles of ``tile``
  input samples; the output ``(n_tiles, keep)``, ``keep = tile·P/Q``, holds
  the first ``keep`` words of every tile, raw (``do_mix=False``) or mixed
  and encoded (``do_mix=True``).  So a launch moves the chain's
  ``4 + 4·P/Q`` B/sample.
- :func:`mix_shape_run` (port of ``tools/probe_chain_precision.py:190``
  ``mix_shape_run(...).run``): the same with ``do_mix=True`` and the tone a
  parameter, ``'fold'`` (the product tone) or ``'select'``
  (``ops.sincos.sincos_q24_neg_select``); the two give the same words.

The chain-shaped probes return ``(out, side)``.  ``side`` is ``(n_tiles,)``
int32: the XOR of the tile's words that ``out`` does not hold.  The kernel
writes it so that every sample's load and mix stays live code (the compiler
would otherwise drop the work whose result is never stored); the plain
version computes the same XOR, so ``side`` equal on the card shows that the
kernel did all of the tile's work.

The TPU tiling of the originals (``W``, ``S``, 128 lanes, ``Wc``, ``A``,
``G``) is not carried over: :func:`chain_tile` takes a tile of about
``128·Q/P`` inputs, what 128 outputs of the chain span.  The mix is the
product kernels' own front, ``csrc/nco.cuh``'s ``mix_span`` (the strided
walker over 16-byte loads), so ``chain-mix`` times what the chain pays.
"""

from __future__ import annotations

import torch

from doppler_tpu_torch.ops import codec, nco
from doppler_tpu_torch.ops.cuda import build
from doppler_tpu_torch.ops.cuda.mixer import check_fmt
from doppler_tpu_torch.ops.sincos import sincos_q24_neg, sincos_q24_neg_select

__all__ = ["probe_elementwise", "probe_elementwise_plain", "chain_shape_run",
           "chain_shape_run_plain", "mix_shape_run", "mix_shape_run_plain",
           "chain_tile"]

_BODIES = ("copy", "codec")
_TILE_M = 128     # a chain-shaped tile holds about this many kept words
_TONES = {"fold": sincos_q24_neg, "select": sincos_q24_neg_select}
_MODE = {None: 0, "fold": 1, "select": 2}     # csrc/probes.cu kMode


def chain_tile(n: int, P: int, Q: int) -> int:
    """Input samples a tile: the largest multiple of Q that divides ``n``
    and is at most ``128·Q/P``, the inputs under 128 outputs of the chain."""
    for tile in range(_TILE_M * Q // P // Q * Q, 0, -Q):
        if n % tile == 0:
            return tile
    raise ValueError(f"no multiple of Q={Q} divides the chunk of {n} samples")


def _check_words(words: torch.Tensor, body: str, vec: int) -> None:
    if body not in _BODIES:
        raise ValueError(f"body must be one of {_BODIES}, got {body!r}")
    if vec not in (1, 4):
        raise ValueError(f"vec must be 1 or 4 words an access, got {vec!r}")
    if words.dtype != torch.int32:
        raise ValueError(f"words must be int32, got {words.dtype}")
    if vec == 4 and words.numel() % 4:
        raise ValueError(f"vec=4 needs a multiple of 4 words, got {words.numel()}")


def probe_elementwise_plain(words: torch.Tensor, *, body: str = "copy",
                            vec: int = 1) -> torch.Tensor:
    """Plain torch version: a copy, or ``ops.codec``'s decode and encode
    without the NaN guard.  ``vec`` changes no value."""
    _check_words(words, body, vec)
    if body == "copy":
        return words.clone()
    i, q = codec.i16_words_to_iq(words)

    def enc(v):
        return torch.clamp(torch.trunc(v * 32767.0), -32768.0, 32767.0).to(torch.int32)

    return codec.pack_i16_words(enc(i), enc(q))


def probe_elementwise(words: torch.Tensor, *, body: str = "copy",
                      vec: int = 1, out: torch.Tensor | None = None) -> torch.Tensor:
    """``out = body(words)`` over int32 words of any shape.

    ``out``: where to write, a contiguous int32 tensor of the words' shape on
    their device that the caller owns (so that a timing compares the kernel
    with ``out.copy_(words)`` and not with an allocation as well); None: a
    new tensor.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises.
    """
    if out is not None and (out.dtype != torch.int32 or out.shape != words.shape
                            or out.device != words.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous int32 tensor of the words' "
                         "shape on their device")
    if words.device.type == "cpu":
        res = probe_elementwise_plain(words, body=body, vec=vec)
        return res if out is None else out.copy_(res)
    if words.device.type != "cuda":
        raise ValueError(f"no probe for device {words.device}")
    _check_words(words, body, vec)
    words = words.contiguous()
    if out is None:
        out = torch.empty_like(words)
    if vec == 4 and (words.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("vec=4 needs 16-byte aligned tensors")
    rc = build.load().doppler_probe_elementwise(
        words.data_ptr(), out.data_ptr(), words.numel(), int(body == "codec"),
        vec, torch.cuda.current_stream(words.device).cuda_stream)
    build.check(rc, "elementwise probe")
    probe_elementwise.launches += 1
    return out


def _shape_geometry(words, plans, P: int, Q: int, tile: int | None):
    B, L = check_fmt(words, plans, "i16", "i16")
    if tile is None:
        tile = chain_tile(B * L, P, Q)
    if tile <= 0 or tile % Q or (B * L) % tile:
        raise ValueError(f"tile {tile} must be a multiple of Q={Q} that divides "
                         f"the chunk of {B * L} samples")
    return B, L, tile, tile // Q * P


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of the last axis of an int32 tensor, by halving."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _shape_plain(words, plans, P, Q, tile, tone):
    B, L, tile, keep = _shape_geometry(words, plans, P, Q, tile)
    if tone is not None:
        i, q = codec.i16_words_to_iq(words)
        words = codec.iq_to_i16_words(
            *nco.mix_blocks(i, q, plans, tone=_TONES[tone]))
    tiles = words.reshape(-1, tile)
    side = (_xor_fold(tiles[:, keep:]) if keep < tile
            else torch.zeros_like(tiles[:, 0]))
    return tiles[:, :keep].contiguous(), side


def _shape_launch(words, plans, P, Q, tile, tone):
    B, L, tile, keep = _shape_geometry(words, plans, P, Q, tile)
    words, plans = words.contiguous(), plans.contiguous()
    n_tiles = B * L // tile
    out = torch.empty((n_tiles, keep), dtype=torch.int32, device=words.device)
    side = torch.empty((n_tiles,), dtype=torch.int32, device=words.device)
    rc = build.load().doppler_chain_shape(
        words.data_ptr(), out.data_ptr(), side.data_ptr(), plans.data_ptr(),
        B, L, tile, keep, _MODE[tone],
        torch.cuda.current_stream(words.device).cuda_stream)
    build.check(rc, "chain-shape probe")
    return out, side


def _check_tone(tone: str) -> None:
    if tone not in _TONES:
        raise ValueError(f"tone must be one of {tuple(_TONES)}, got {tone!r}")


def chain_shape_run_plain(words, plans, *, P: int, Q: int, do_mix: bool,
                          tile: int | None = None):
    """Plain torch version: the first ``tile·P/Q`` words of every tile of
    the raw words, or of the mixer's plain output, and the XOR of the rest."""
    return _shape_plain(words, plans, P, Q, tile, "fold" if do_mix else None)


def chain_shape_run(words, plans, *, P: int, Q: int, do_mix: bool,
                    tile: int | None = None):
    """Chain-shaped copy (``do_mix=False``) or mix + encode probe.

    ``words``: int32 ``(B, L)``; ``plans``: ``(7, B)`` plan words (not read
    by the copy); ``tile``: input samples a tile, default :func:`chain_tile`.
    Returns ``(out, side)``: int32 ``(n_tiles, tile·P/Q)`` and ``(n_tiles,)``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if words.device.type == "cpu":
        return chain_shape_run_plain(words, plans, P=P, Q=Q, do_mix=do_mix,
                                     tile=tile)
    if words.device.type != "cuda":
        raise ValueError(f"no probe for device {words.device}")
    res = _shape_launch(words, plans, P, Q, tile, "fold" if do_mix else None)
    chain_shape_run.launches += 1
    return res


def mix_shape_run_plain(words, plans, *, P: int, Q: int, tone: str,
                        tile: int | None = None):
    """Plain torch version: :func:`chain_shape_run_plain` with
    ``do_mix=True`` and the tone of ``ops.sincos`` that ``tone`` names."""
    _check_tone(tone)
    return _shape_plain(words, plans, P, Q, tile, tone)


def mix_shape_run(words, plans, *, P: int, Q: int, tone: str,
                  tile: int | None = None):
    """Chain-shaped mix + encode probe with the tone a parameter:
    ``'fold'`` or ``'select'``.  Arguments and result as
    :func:`chain_shape_run`.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if words.device.type == "cpu":
        return mix_shape_run_plain(words, plans, P=P, Q=Q, tone=tone, tile=tile)
    if words.device.type != "cuda":
        raise ValueError(f"no probe for device {words.device}")
    _check_tone(tone)
    res = _shape_launch(words, plans, P, Q, tile, tone)
    mix_shape_run.launches += 1
    return res


probe_elementwise.launches = 0     # kernel launches (CUDA path only)
chain_shape_run.launches = 0
mix_shape_run.launches = 0
