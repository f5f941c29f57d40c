"""The resampler's two kernels (``csrc/window.cu``, ``csrc/conv.cu``) on the
CPU: their pickers in ``ops/cuda/geometry.py`` and their device functions.

- ``pick_window`` / ``pick_conv`` at every geometry the pipeline hands the
  kernels (the digest cases of ``tools/kernel_digests.py``: config 3's
  single stage at the chunk, at 2^24 inputs, mid-stream, at 16 channels and
  past both ends of a small buffer; the config-3 cascade's ÷8 / 65 and
  3/8 / 51 stages; the 100 Msps split tail, 384/3125 / 163, at C = 1 and
  256): every CTA stages every input index its outputs read (the window
  form's after the clamp), its shared memory fits 232,448 bytes, its
  offsets fit 32 bits, and P = 384 takes the rows path (all 384 rows of
  taps would not fit a CTA).
- The kernels' own device functions, built with the host compiler through
  ``csrc/host_shim.cuh`` and run a CTA's threads one after the other
  (``csrc/host/kernel_emulation.cpp``): bitwise the kernels they replaced
  (one output-plane at a time, ``ref_window`` / ``ref_conv``) at those
  geometries (cut to a few thousand inputs) and across tiles, threads and
  register tiles of both paths, a NaN input included; within the card
  tests' tolerances of the plain versions and of the JAX package's
  functions (window 2^-20, conv 1e-5 of the peak).  Skipped without ``g++``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppler_tpu.ops import resample as jax_resample
from doppler_tpu_torch.ops.cuda import geometry
from doppler_tpu_torch.ops.cuda.conv import conv_bands, resample_conv_stream_plain
from doppler_tpu_torch.ops.resample import make_taps_matrix, window_dot
from doppler_tpu_torch.tools import kernel_digests as kd

CSRC = Path(__file__).resolve().parents[1] / "doppler_tpu_torch" / "csrc"
LIMIT = 232448                    # an H100 CTA's shared memory (opt-in)
CASES = tuple(kd.RESAMPLE_CASES)


# tile-path geometries (P ≤ 4) whose Q is not a multiple of 4: the conv
# kernel's four-step loads and the steps after them (2/5, 3/7, 4/7 → 48 ksps)
ODD_Q = {
    "q5/C1": kd.ResampleCase((120_000, None), 1, 3000, 1001),
    "q7/C3": kd.ResampleCase((112_000, None), 3, 2000, 70, strided=True),
    "q7p4/C1": kd.ResampleCase((84_000, None), 1, 2500, 0),
}


def _geometry(name, N=None, C=None):
    case = kd.RESAMPLE_CASES.get(name) or ODD_Q[name]
    case = dataclasses.replace(case, N=N or case.N, C=C or case.C)
    P, Q, T, bank = kd.resample_stage(case)
    return case, P, Q, T, bank, kd.resample_args(case, P, Q, T)


# -- (a) the pickers --------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_window_pick_stages_every_index_it_reads(name):
    case, P, Q, T, _, a = _geometry(name)
    C, M, rem0, off0 = case.C, a["M"], a["rem0"], a["off0"]
    lay = geometry.pick_window(P, Q, T, C, M, LIMIT)
    assert lay.smem_bytes <= LIMIT and geometry.window_offsets_fit(lay, P, Q)
    assert lay.rows == (P > geometry.WINDOW_FIR_MAX_P)
    assert lay.threads <= 256 and lay.tile >= 1
    spans = geometry.window_cta_spans(lay, P, Q, T, C, M, rem0, off0)
    assert sum(cnt * len(ch) for ch, _, cnt, _, _ in spans) == M * C
    for chans, j0, cnt, b_lo, n in spans:
        # output j reads buffer indices base_j .. base_j + T − 1 (then the
        # clamp): the span's values are x[clamp(b)], b over b_lo .. b_lo+n−1
        first = off0 + (j0 * Q + rem0) // P
        last = off0 + ((j0 + cnt - 1) * Q + rem0) // P + T - 1
        assert b_lo <= first and last <= b_lo + n - 1
        if lay.rows:
            assert n <= lay.span_stride and cnt <= lay.tile
        else:
            js, d = geometry.window_shift(P, Q, T, rem0, off0)
            (_, _, lo, n_lo, origin, top), = geometry.cta_spans(
                ((P, Q, T),), (lay.R,), 1, j0 + js, cnt).values()
            assert (lo + d, n_lo) == (b_lo, n) and top < lay.words


@pytest.mark.parametrize("name", CASES)
def test_conv_pick_stages_every_index_it_reads(name):
    case, P, Q, T, _, a = _geometry(name)
    C, M, p0, start0 = case.C, a["M"], a["p0"], a["start0"]
    _, R = conv_bands(Q, T)
    lay = geometry.pick_conv(P, Q, R, C, M, p0, LIMIT)
    assert lay.smem_bytes <= LIMIT and geometry.conv_offsets_fit(lay, Q)
    assert lay.rows == (P > geometry.CONV_TILE_MAX_P)
    spans = geometry.conv_cta_spans(lay, P, Q, R, C, M, p0, start0)
    assert sum(len(ch) * len(outs) for ch, outs, _, _ in spans) == M * C
    for chans, outs, b_lo, n in spans:
        for m in (outs[0], outs[-1]):
            k = (p0 + m) // P
            assert b_lo <= start0 + k * Q and start0 + (k + R) * Q <= b_lo + n
        if not lay.rows:
            assert n + (n - 1) // Q + 1 <= lay.words
            assert lay.words * Q < 2 ** 32
    if lay.rows:
        nb = (lay.tile + P - 2) // P + 1 + lay.rg - 1
        assert lay.cg * nb * lay.qc == lay.words


def test_the_split_tail_takes_the_rows_paths():
    """At P = 384 every row of taps would take 384 · tap_stride(163) floats,
    over a CTA's limit: both kernels hold only their own outputs' rows."""
    assert 384 * geometry.tap_stride(163) * 4 > LIMIT
    for C in (1, 256):
        assert geometry.pick_window(384, 3125, 163, C, 253, LIMIT).rows
        assert geometry.pick_conv(384, 3125, 2, C, 253, 100, LIMIT).rows
    assert not geometry.pick_window(3, 64, 370, 1, 24578, LIMIT).rows
    assert not geometry.pick_conv(3, 64, 7, 1, 24578, 0, LIMIT).rows


# -- (b) the kernels' device functions on the CPU ----------------------------------

@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device functions for the host")
    lib = tmp_path_factory.mktemp("emu") / "kernel_emulation.so"
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-std=c++17", "-I", str(CSRC), "-o", str(lib),
                    str(CSRC / "host" / "kernel_emulation.cpp")], check=True)
    return ctypes.CDLL(str(lib))


_P = ctypes.c_void_p
_LL = ctypes.c_longlong


class _Inputs:
    """A case's seeded float32 rows, strided and one float in where the case
    is (``x`` is ``(2, C, stride + 1)``, row c of plane k at
    ``x[k, c, off:off+n]``)."""

    def __init__(self, name, N=None, C=None, nan_at=None):
        case, P, Q, T, bank, a = _geometry(name, N, C)
        self.case, self.P, self.Q, self.T, self.bank, self.a = case, P, Q, T, bank, a
        self.C, self.M = case.C, a["M"]
        self.n = T - 1 + case.N
        self.off = 1 if case.strided else 0
        self.stride = self.n + 13 if case.strided else self.n + 1
        rng = np.random.default_rng([self.n, self.C, P])
        self.x = (rng.standard_normal((2, self.C, self.stride), dtype=np.float32)
                  * np.float32(0.3))
        if nan_at is not None:
            self.x[0, 0, self.off + nan_at] = np.nan
        self.bank_rev = np.ascontiguousarray(bank[:, ::-1], dtype=np.float32)
        self.taps = make_taps_matrix(bank, P, Q)
        self.w_len, self.R = conv_bands(Q, T)

    def rows(self):
        """``(xi, xq)`` as torch ``(C, n)`` views (the plain versions)."""
        t = torch.from_numpy(self.x)[:, :, self.off:self.off + self.n]
        return t[0], t[1]

    def _ptrs(self):
        base = self.x.ctypes.data + 4 * self.off
        return _P(base), _P(base + 4 * self.C * self.stride)

    def window(self, lib, fn, lay=None):
        y = np.full((2, self.C, self.M), np.nan, dtype=np.float32)
        a = self.a
        args = [*self._ptrs(), self.bank_rev.ctypes.data_as(_P),
                _P(y.ctypes.data), _P(y[1].ctypes.data), self.C, _LL(self.n),
                _LL(self.stride), _LL(self.M), a["rem0"], _LL(a["off0"]), self.P,
                self.Q, self.T]
        if fn == "emu":
            lay = lay or geometry.pick_window(self.P, self.Q, self.T, self.C,
                                              self.M, LIMIT)
            rc = lib.emu_window(*args, (ctypes.c_int * 9)(*lay.args),
                                lay.threads, _LL(lay.smem_bytes))
        else:
            rc = lib.ref_window(*args)
        assert rc == 0
        return y

    def conv(self, lib, fn, lay=None):
        y = np.full((2, self.C, self.M), np.nan, dtype=np.float32)
        a = self.a
        args = [*self._ptrs(), self.taps.ctypes.data_as(_P), _P(y.ctypes.data),
                _P(y[1].ctypes.data), self.C, _LL(self.n), _LL(self.stride),
                _LL(self.M), _LL(a["start0"]), a["p0"], self.P, self.Q, self.R,
                self.w_len]
        if fn == "emu":
            lay = lay or geometry.pick_conv(self.P, self.Q, self.R, self.C,
                                            self.M, a["p0"], LIMIT)
            rc = lib.emu_conv(*args, (ctypes.c_int * 7)(*lay.args), lay.threads,
                              _LL(lay.smem_bytes))
        else:
            rc = lib.ref_conv(*args)
        assert rc == 0
        return y


# each case cut to a few thousand inputs; (name, N, C)
EMULATED = (
    ("c3-chunk/C1", 6000, None),
    ("c3-mid/C1", 6000, None),
    ("c3-mid/C16", 1200, 5),
    ("c3-edge/C1", None, None),
    ("c38-s0/C1", 4000, None),
    ("c38-s1/C1", 3000, None),
    ("tail/C1", None, None),
    ("tail/C256", None, 40),
)


def _window_layouts(inp):
    P, Q, T, C, M = inp.P, inp.Q, inp.T, inp.C, inp.M
    lays = [geometry.window_layout(P, Q, T, C, M, rows=True, threads=t)
            for t in (256, 64, 8) if t >= min(C, 32)]
    if P <= geometry.WINDOW_FIR_MAX_P:
        lays += [geometry.window_layout(P, Q, T, C, M, rows=False, threads=t, R=R)
                 for t in (256, 32) for R in (1, 2) if t >= P]
    return [lay for lay in lays if lay.smem_bytes <= LIMIT]


def _conv_layouts(inp):
    P, Q, R, C, M, p0 = inp.P, inp.Q, inp.R, inp.C, inp.M, inp.a["p0"]
    lays = [geometry.conv_layout(P, Q, R, C, M, p0, rows=True, threads=t, qc=qc)
            for t in (128, 32) for qc in (8, None)]
    if P <= geometry.CONV_TILE_MAX_P:
        lays += [geometry.conv_layout(P, Q, R, C, M, p0, rows=False, threads=t)
                 for t in (256, 128, 32)]
    return [lay for lay in lays if lay.smem_bytes <= LIMIT]


@pytest.mark.parametrize("name,N,C", EMULATED)
def test_emulated_window_kernel_bitwise_the_kernel_it_replaced(emu, name, N, C):
    inp = _Inputs(name, N, C)
    want = inp.window(emu, "ref")
    assert not np.isnan(want).any()
    for lay in [None] + _window_layouts(inp):
        assert inp.window(emu, "emu", lay).tobytes() == want.tobytes(), lay


@pytest.mark.parametrize("name,N,C", EMULATED)
def test_emulated_conv_kernel_bitwise_the_kernel_it_replaced(emu, name, N, C):
    inp = _Inputs(name, N, C)
    want = inp.conv(emu, "ref")
    assert not np.isnan(want).any()
    for lay in [None] + _conv_layouts(inp):
        assert inp.conv(emu, "emu", lay).tobytes() == want.tobytes(), lay


@pytest.mark.parametrize("name", ODD_Q)
def test_emulated_kernels_bitwise_at_a_q_not_a_multiple_of_four(emu, name):
    inp = _Inputs(name)
    assert inp.Q % 4 and inp.P <= geometry.CONV_TILE_MAX_P
    for fn, lays in ((inp.conv, _conv_layouts(inp)),
                     (inp.window, _window_layouts(inp))):
        want = fn(emu, "ref")
        assert not np.isnan(want).any()
        for lay in [None] + lays:
            assert fn(emu, "emu", lay).tobytes() == want.tobytes(), lay


@pytest.mark.parametrize("name,N,C", EMULATED[1:2] + EMULATED[5:7])
def test_emulated_kernels_within_tolerance_of_plain_and_jax(emu, name, N, C):
    """The window kernel within 2^-20 of ``window_dot`` (the plain version)
    and of the JAX package's ``window_dot``; the conv kernel within 1e-5 of
    the peak of its plain version and of the JAX ``resample_conv_stream``
    (each another summation order)."""
    inp = _Inputs(name, N, C)
    a, P, Q, T, M = inp.a, inp.P, inp.Q, inp.T, inp.M
    xi, xq = inp.rows()
    got = inp.window(emu, "emu")
    n = -(-(inp.case.in_consumed + inp.case.N) * P // Q) - (
        -(-inp.case.in_consumed * P // Q))          # outputs inside the buffer
    plain = np.stack([y.numpy() for y in window_dot(
        xi, xq, torch.from_numpy(inp.bank_rev), a["rem0"], a["off0"], P=P, Q=Q,
        T=T, M=M)])
    jx = np.stack([np.asarray(y) for y in jax_resample.window_dot(
        jnp.asarray(xi.numpy()), jnp.asarray(xq.numpy()),
        jnp.asarray(inp.bank_rev), jnp.int32(a["rem0"]), jnp.int32(a["off0"]),
        P=P, Q=Q, T=T, M=M)])
    for want in (plain, jx):
        assert np.abs(got[..., :n] - want[..., :n]).max() <= 2.0 ** -20
    got = inp.conv(emu, "emu")
    kw = {k: a[k] for k in ("K", "M", "PADZ", "TAIL")}
    plain = np.stack([y.numpy() for y in resample_conv_stream_plain(
        xi, xq, torch.from_numpy(inp.taps), a["start0"], a["p0"], P=P, Q=Q, T=T,
        **kw)])
    jx = np.stack([np.asarray(y) for y in jax_resample.resample_conv_stream(
        jnp.asarray(xi.numpy()), jnp.asarray(xq.numpy()), jnp.asarray(inp.taps),
        jnp.int32(a["start0"]), jnp.int32(a["p0"]), P=P, Q=Q, T=T, **kw)])
    for want in (plain, jx):
        peak = np.abs(want[..., :n]).max()
        assert np.abs(got[..., :n] - want[..., :n]).max() <= 1e-5 * peak


@pytest.mark.parametrize("name,N,C", (EMULATED[1], EMULATED[5], EMULATED[6]))
def test_emulated_nan_reach(emu, name, N, C):
    """A NaN input reaches exactly the window outputs whose T-sample window
    (after the clamp) holds it and the conv outputs whose row does: its
    R·Q samples, the Q−1+T of the window row and the zero taps' rows after
    it (every product is computed, as the kernel it replaced and the JAX
    form do); the rest are the kernel's bytes without the NaN."""
    at = 1000
    inp = _Inputs(name, N, C, nan_at=at)
    clean = _Inputs(name, N, C)
    a, P, Q, T, M = inp.a, inp.P, inp.Q, inp.T, inp.M
    j = np.arange(M)
    base = a["off0"] + (j * Q + a["rem0"]) // P
    idx = np.clip(base[:, None] + np.arange(T)[None, :], 0, inp.n - 1)
    reach = (idx == at).any(axis=1)
    for got, ok in ((inp.window(emu, "emu"), clean.window(emu, "emu")),):
        assert (np.isnan(got[0, 0]) == reach).all() and not np.isnan(got[1]).any()
        assert got[0, 0][~reach].tobytes() == ok[0, 0][~reach].tobytes()
    k = (a["p0"] + j) // P
    row0 = a["start0"] + k * Q
    reach = (row0 <= at) & (at < row0 + inp.R * Q)
    got, ok = inp.conv(emu, "emu"), clean.conv(emu, "emu")
    assert (np.isnan(got[0, 0]) == reach).all() and not np.isnan(got[1]).any()
    assert got[0, 0][~reach].tobytes() == ok[0, 0][~reach].tobytes()
    assert got.tobytes() == inp.conv(emu, "ref").tobytes()


# -- (c) the cases and the tools' arithmetic ----------------------------------------

@pytest.mark.parametrize(
    "name", [n for n in CASES if kd.RESAMPLE_CASES[n].m0 is None])
def test_digest_cases_are_the_resamplers_own_arguments(name):
    """A case's host ints are what ``RationalResampler.process`` hands the
    kernels at that stream position (the edge case sets its m0 by hand)."""
    from doppler_tpu_torch.ops.resample import conv_stream_geometry

    case, P, Q, T, _, a = _geometry(name)
    fs, index = case.stage
    rs = (kd.RationalResampler(fs, kd.OUT_RATE) if index is None
          else kd.MultiStageResampler(fs, kd.OUT_RATE).stages[index])
    # the stream after in_consumed inputs: every output they make is made
    rs.m_next = rs.out_count_for(case.in_consumed)
    rs.in_consumed = case.in_consumed
    assert rs.out_count_for(0) == 0
    m0 = rs.m_next
    assert a["M"] == rs.max_out_for(case.N)
    assert (a["rem0"], a["off0"]) == ((m0 * Q) % P, (m0 * Q) // P - case.in_consumed)
    assert (a["start0"], a["p0"]) == conv_stream_geometry(
        m0, case.in_consumed, a["M"], case.N, P=P, Q=Q, T=T)[:2]


def test_probe_bounds_and_sweep_layouts():
    """``resample_probe.case_bound``: 8 B a channel-sample in and out at
    3.35 TB/s, or the FMAs at 67 TFLOP/s; ``kernel_sweep`` offers only
    layouts that fit, the picked one first."""
    from doppler_tpu_torch.tools import kernel_sweep, resample_probe

    ms, by = resample_probe.case_bound("window", "c3-2p24/C1")
    assert by == "bytes"
    assert ms == pytest.approx(8 * (369 + (1 << 24) + 786434) / 3.35e12 * 1e3)
    ms, by = resample_probe.case_bound("conv", "tail/C256")
    assert by == "operations"
    assert ms == pytest.approx(4 * 2 * 3125 * 256 * 253 / 67e12 * 1e3)
    for kernel in kd.RESAMPLE_KERNELS:
        for name in kernel_sweep.RESAMPLE_CASES:
            lays = kernel_sweep.resample_layouts(kernel, name, LIMIT)
            assert lays and all(lay.smem_bytes <= LIMIT for lay in lays)
            case, P, Q, T, _, a = _geometry(name)
            R = conv_bands(Q, T)[1]
            picked = (geometry.pick_window(P, Q, T, case.C, a["M"], LIMIT)
                      if kernel == "window" else
                      geometry.pick_conv(P, Q, R, case.C, a["M"], a["p0"], LIMIT))
            assert lays[0] == picked


@pytest.mark.parametrize("kernel", kd.RESAMPLE_KERNELS)
def test_vs_plain_check_and_launches_stay_off_the_cpu(kernel):
    """``kernel_digests.resample_vs_plain`` (the card tests' and
    ``chip_smoke.py``'s check at the split tail) on CPU tensors, where the
    wrapper runs the plain version: no error, over the outputs in the
    buffer.  The kernels' launches refuse CPU tensors: no fallback."""
    r = kd.resample_vs_plain(kernel, "tail/C1", "cpu")
    assert r["ok"] and r["max_abs_err"] == 0.0 and r["lsb"] == 0
    assert r["tol"] == (2.0 ** -20 if kernel == "window" else pytest.approx(
        1e-5 * torch.stack(kd.resample_step(kernel, "tail/C1", "cpu", plain=True)())
        .abs().max().item()))
    lay = geometry.window_layout(3, 64, 370, 1, 8, rows=True, threads=32)
    with pytest.raises(ValueError, match="no .* resampler for device cpu"):
        kd.resample_step(kernel, "c38-s1/C1", "cpu", layout=lay)()
