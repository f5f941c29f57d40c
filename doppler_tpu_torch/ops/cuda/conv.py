"""The banded-matmul resampler product (the ``'conv'`` form).

:func:`resample_conv_stream` launches ``csrc/conv.cu`` on a CUDA tensor (the
port of the XLA product of ``doppler_tpu/ops/resample.py:96``
``resample_conv_stream``; the JAX package has no Pallas kernel for it) and
runs :func:`resample_conv_stream_plain`, the JAX form in torch, on a CPU
tensor.

The plain version sums R terms ``(rows, K, Q) @ (Q, P)`` in JAX's order,
each a ``torch.matmul``.  A library product chooses its kernel, and with it
its summation order, by shape; on the CPU (MKL) the bytes of an output were
found not to depend on K once K ≥ 64 (the floor of
``ops.resample.conv_stream_geometry``), which the CPU tests hold.  On the
card the kernel sums every output in one fixed order (see the source), so
an output's bits do not depend on the chunk around it.  The kernel is held
to the plain version within a tolerance, and bitwise only to itself.

Neither form may use TF32: :func:`check_no_tf32` raises when float32
matrix products may (``torch.backends.cuda.matmul.allow_tf32``, or a
``torch.get_float32_matmul_precision()`` other than ``'highest'``); it
never changes the setting.
"""

from __future__ import annotations

import ctypes
import math

import torch

from doppler_tpu_torch.ops.cuda import build, geometry

__all__ = ["check_no_tf32", "conv_bands", "resample_conv_stream",
           "resample_conv_stream_plain", "row_layout"]

# input samples a slab of the plain version's rows may hold: each of its R
# terms copies its (rows, K, Q) operand; results do not depend on it
_SLAB = 1 << 24


def check_no_tf32() -> None:
    """Raise if a float32 matrix product may run in TF32."""
    prec = torch.get_float32_matmul_precision()
    if torch.backends.cuda.matmul.allow_tf32 or prec != "highest":
        raise RuntimeError(
            "the conv resampler refuses to run where float32 matrix products "
            "may use TF32: torch.backends.cuda.matmul.allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32} and the float32 matmul "
            f"precision is {prec!r} (want False and 'highest')")


def conv_bands(Q: int, T: int) -> tuple[int, int]:
    """``(w_len, R)``: the window row's length Q−1+T and the R = ⌈w_len/Q⌉
    stride-Q row slices that cover it."""
    w_len = (Q - 1) + T
    return w_len, -(-w_len // Q)


def resample_conv_stream_plain(xi, xq, taps_mat, start0: int, p0: int, *,
                               P: int, Q: int, T: int, K: int, M: int,
                               PADZ: int, TAIL: int):
    """Plain torch version: the JAX function as written.

    ``xi/xq`` ``(..., H + N)`` buffers with the T−1 history prefix,
    ``taps_mat`` ``(Q−1+T, P)`` (``ops.resample.make_taps_matrix``), and the
    host ints of ``ops.resample.conv_stream_geometry``.  Returns ``(..., M)``
    planes.  Rows (a channel's I or Q plane) are independent; they run in
    slabs of about ``_SLAB`` input samples.
    """
    w_len, R = conv_bands(Q, T)
    lead = tuple(xi.shape[:-1])
    x2 = torch.stack([xi, xq], dim=-2).reshape(-1, xi.shape[-1])
    taps_pad = torch.nn.functional.pad(taps_mat, (0, 0, 0, R * Q - w_len))
    lo = start0 + PADZ
    y = torch.empty((x2.shape[0], M), dtype=torch.float32, device=xi.device)
    slab = max(1, _SLAB // ((K + R) * Q))
    for r0 in range(0, x2.shape[0], slab):
        xs = torch.nn.functional.pad(x2[r0:r0 + slab], (PADZ, TAIL))
        G = xs[:, lo:lo + (K + R) * Q].reshape(-1, K + R, Q)
        acc = None
        for r in range(R):
            term = torch.matmul(G[:, r:r + K, :], taps_pad[r * Q:(r + 1) * Q])
            acc = term if acc is None else acc + term          # (rows, K, P)
        y[r0:r0 + slab] = acc.reshape(-1, K * P)[:, p0:p0 + M]
    y = y.reshape(*lead, 2, M)
    return y[..., 0, :], y[..., 1, :]


def _rows(x: torch.Tensor):
    """``(x, row stride)`` with unit stride along the samples: a ``(n,)``
    or ``(C, n)`` view is used as it lies, anything else is copied."""
    if x.dim() == 1:
        x = x.contiguous()
        return x, x.shape[-1]
    if x.stride(-1) != 1 or x.stride(0) < x.shape[-1]:
        x = x.contiguous()
    return x, x.stride(0)


def row_layout(xi: torch.Tensor, xq: torch.Tensor):
    """``(xi, xq, row stride)`` for a kernel that reads C rows of n samples
    at one stride from two float32 planes, ``(n,)`` or ``(C, n)`` of one
    shape on one device (raises otherwise; copies only what does not fit)."""
    if (xi.dtype != torch.float32 or xq.dtype != torch.float32
            or xi.shape != xq.shape or xi.dim() not in (1, 2)
            or xq.device != xi.device):
        raise ValueError(f"xi/xq must be float32 (n,) or (C, n) of one shape "
                         f"on one device, got {xi.dtype} {tuple(xi.shape)} on "
                         f"{xi.device} and {xq.dtype} {tuple(xq.shape)} on "
                         f"{xq.device}")
    xi_r, stride = _rows(xi)
    xq_r, stride_q = _rows(xq)
    if stride_q != stride:
        n = xi.shape[-1]
        xi_r, xq_r, stride = xi.contiguous(), xq.contiguous(), n
    return xi_r, xq_r, stride


def resample_conv_stream(xi, xq, taps_mat, start0: int, p0: int, *,
                         P: int, Q: int, T: int, K: int, M: int, PADZ: int,
                         TAIL: int):
    """Streaming banded-matmul resampler over one chunk's buffers.

    The arguments of :func:`resample_conv_stream_plain`.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (which needs only
    ``start0``, ``p0`` and ``M``: it reads zeros outside the buffer, where
    the plain version pads ``PADZ``/``TAIL`` zeros) or raises.
    """
    check_no_tf32()
    if xi.device.type == "cpu":
        return resample_conv_stream_plain(xi, xq, taps_mat, start0, p0, P=P,
                                          Q=Q, T=T, K=K, M=M, PADZ=PADZ,
                                          TAIL=TAIL)
    return _launch(xi, xq, taps_mat, start0, p0, P=P, Q=Q, T=T, M=M)


def _launch(xi, xq, taps_mat, start0: int, p0: int, *, P: int, Q: int, T: int,
            M: int, layout=None):
    """:func:`resample_conv_stream` on the card.  ``layout`` (a
    ``geometry.ConvLayout``) overrides the picked path and sizes (the card
    tests and the sweep walk several: the bytes do not depend on it)."""
    if xi.device.type != "cuda":
        raise ValueError(f"no conv resampler for device {xi.device}")
    w_len, R = conv_bands(Q, T)
    xi_r, xq_r, stride = row_layout(xi, xq)
    if (taps_mat.dtype != torch.float32 or tuple(taps_mat.shape) != (w_len, P)
            or taps_mat.device != xi.device):
        raise ValueError(f"taps_mat must be float32 ({w_len}, {P}) on "
                         f"{xi.device}, got {taps_mat.dtype} "
                         f"{tuple(taps_mat.shape)} on {taps_mat.device}")
    if not 0 <= p0 < P:
        raise ValueError(f"p0 must lie in [0, {P}), got {p0}")
    lead = tuple(xi.shape[:-1])
    yi = torch.empty(lead + (M,), dtype=torch.float32, device=xi.device)
    yq = torch.empty_like(yi)
    if M <= 0:
        return yi, yq
    taps = taps_mat.contiguous()
    C = math.prod(lead)
    lay = layout or geometry.pick_conv(
        P, Q, R, C, M, p0, build.shared_memory_limit(xi.device.index),
        build.sm_count(xi.device.index))
    rc = build.load().doppler_conv(
        xi_r.data_ptr(), xq_r.data_ptr(), taps.data_ptr(), yi.data_ptr(),
        yq.data_ptr(), C, xi.shape[-1], stride, M, start0, p0, P, Q, R, w_len,
        (ctypes.c_int * 7)(*lay.args), lay.threads, lay.smem_bytes,
        torch.cuda.current_stream(xi.device).cuda_stream)
    build.check(rc, "conv")
    resample_conv_stream.launches += 1
    return yi, yq


resample_conv_stream.launches = 0      # kernel launches (CUDA path only)
