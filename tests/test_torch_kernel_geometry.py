"""The geometry of the redesigned chain and cascade kernels, on the CPU.

What runs here without a card:

- the incremental phase of ``csrc/nco.cuh``'s walker, as an integer model:
  equal to ``doppler_tpu_torch.ops.nco.phase_q24`` and, through it, to
  ``doppler_tpu.ops.pallas.mixer.phase_q24``, bitwise;
- ``ops/cuda/geometry.py``: the picked tiles fit 227 KB, the CTAs cover every
  output and every carry entry once, every span fits its buffer;
- a walk of ``csrc/fir.cuh``'s register tile in Python: each output meets
  its taps in ascending order, each once;
- the kernels' own device functions, built with the host compiler through
  ``csrc/host_shim.cuh`` and run a thread at a time
  (``csrc/host/kernel_emulation.cpp``): bytes equal to a one-output-at-a-time
  reference for every tile, thread count and register tile tried, and within
  the card tests' tolerance of the plain torch versions (≤ 1 LSB in under 1%
  of i16 samples, 2^-20 on float32).  Skipped where there is no ``g++``.
- the kernel of ``--precision fast`` (``csrc/chain_fast.cu``) the same way,
  a warp's 32 lanes at once where it calls ``mma.sync`` (the host stand-in
  computes the 16×8×16 product from the lanes' fragments in the PTX
  layout): the same bytes for every CTA size and thread count, carries
  bitwise the exact kernel's, and within 1 LSB in under 1% of i16 samples,
  1e-5 of the largest float32 output, of the plain version of its dot
  precision (three passes: split3; one: default), at config 3's stage and
  at stages that take two N-tiles, no plane pad, or Q = 1 (16-bit fragment
  loads);
- the cascade of the bf16 dots (``csrc/cascade_fast.cu``) the same way:
  its CTAs cover every output and carry entry once, every M-tile starts at
  a multiple of 16 windows and every span fits its planes; the same bytes
  and carries for every tile and thread count and across a chunk cut,
  stage-0 carries bitwise the exact kernel's, within the same tolerance of
  its plain version (carries too), in CTAs whose shared memory starts as
  NaN, so every band entry a fragment reads is written;
- the mixer (``csrc/mixer.cu``) the same way, a CTA's threads one after the
  other: bitwise the plain torch version at C = 1, 3 and 16 in the four
  wire formats, for every channel group G (one that does not divide C too),
  on the 16-byte path and on the one-sample path (an odd L, a misaligned
  input);
- the chain-shaped mix probe (``csrc/probes.cu``) the same way, a warp's
  lanes one after the other, the side word folded on the host: ``(out,
  side)`` bitwise the plain versions of both tones for a tile of L, L/2 and
  1.5·L (across blocks), an odd B, keep % 4 ≠ 0 (the ragged group), kept
  words over several trips of a lane, a
  segment switch inside a group, a misaligned input and a misaligned row,
  over launch geometries (warps, split, depth); and the launch the
  wrapper picks at B = 256 and 16384.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppler_tpu.ops.pallas import mixer as jax_mixer
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda import cascade, chain, geometry, mixer, probes
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.precision import split3_bank
from doppler_tpu_torch.ops.resample import RationalResampler

torch.set_num_threads(1)   # leave the other test workers their cores

CSRC = Path(geometry.__file__).resolve().parents[2] / "csrc"
H100_SMEM = 232448         # shared memory one CTA may take on an H100 (227 KB)
M64 = (1 << 64) - 1


# -- (a) the walker's incremental phase --------------------------------------

def _random_plans(rng, B, L):
    words = rng.integers(0, 1 << 32, size=(7, B), dtype=np.uint64).astype(np.uint32)
    kind = rng.integers(0, 3, size=B)
    words[6] = np.where(kind == 0, rng.integers(1, L, size=B),
                        np.where(kind == 1, L, 0))
    return words


def _walker_q24(words, L, g, step, count):
    """``csrc/nco.cuh``: walker_seek at chunk index g, then walker_advance by
    ``step``, ``count`` samples in all; Python ints masked to 64 bits."""
    def load(b):
        w = [int(v) for v in words[:, b]]
        return (w[0] << 32 | w[1], w[2] << 32 | w[3], w[4] << 32 | w[5], w[6])

    b, j = divmod(g, L)
    d, c1, c2, t = load(b)
    prod, step_d = j * d & M64, step * d & M64
    out = []
    for _ in range(count):
        out.append(((prod + (c1 if j < t else c2)) & M64) >> 40)
        j += step
        if j < L:
            prod = prod + step_d & M64
            continue
        while j >= L:
            j -= L
            b += 1
        if b >= words.shape[1]:
            break
        d, c1, c2, t = load(b)
        prod, step_d = j * d & M64, step * d & M64
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("L", [96, 2048, 65536])
@pytest.mark.parametrize("step", [128, 384, 1024, 4 * 512])
def test_walker_phase_equals_phase_q24(seed, L, step):
    rng = np.random.default_rng([seed, L, step])
    B = max(4, 3 * step // L + 2)
    words = _random_plans(rng, B, L)
    want = nco.phase_q24(torch.from_numpy(words.view(np.int32)), L).numpy().reshape(-1)
    if seed == 0 and step == 128:
        j = jnp.arange(L, dtype=jnp.uint32)[None, :]
        ref = np.asarray(jax_mixer.phase_q24(
            j, *(jnp.asarray(words[k])[:, None] for k in range(7)),
            small_j=L <= 65536)).reshape(-1)
        assert np.array_equal(want, ref)
    for g in (0, int(rng.integers(1, L)), int(rng.integers(L, 2 * L))):
        count = (B * L - g + step - 1) // step
        got = _walker_q24(words, L, g, step, count)
        assert len(got) == count
        assert np.array_equal(np.asarray(got), want[g::step])


# -- (b) the tile pickers ------------------------------------------------------

def _stages(fs, fused_only=True):
    ms = MultiStageResampler(fs, 48000)
    k = cascade.split_point(ms.stages) if fused_only else len(ms.stages)
    return tuple((st.P, st.Q, st.T) for st in ms.stages[:k])


PICKED = {
    "config 3 cascade": (_stages(1_024_000), 256 * 2048),
    "config 3 chain": (((3, 64, 370),), 256 * 2048),
    "config 4 chain, a short chunk": (((3, 64, 370),), 2 * 2048),
    "config 5 / split front": (_stages(100_000_000), 256 * 2048),
    "2.048 Msps, three stages": (_stages(2_048_000), 64 * 2048),
    "250 ksps front": (_stages(250_000), 16 * 2048),
}


@pytest.mark.parametrize("name", PICKED)
def test_picked_geometry_fits_and_covers(name):
    stages, n0 = PICKED[name]
    lay = geometry.pick_cascade(stages, H100_SMEM)
    assert 0 < lay.smem_bytes <= H100_SMEM
    assert lay.threads % 32 == 0 and lay.threads <= geometry.MAX_THREADS
    assert all(R in geometry.r_choices(P) for (P, _, _), R in zip(stages, lay.regs))
    _check_cover(stages, n0, lay)


@pytest.mark.parametrize("tile,threads,regs", [
    (16, 64, (1, 1)), (100, 96, (2, 2)), (128, 512, (2, 1)), (7, 32, (1, 2))])
def test_any_geometry_covers(tile, threads, regs):
    stages = _stages(1_024_000)
    _check_cover(stages, 8 * 2048, geometry.layout(stages, tile, threads, regs))


def _check_cover(stages, n0, lay):
    """Every output and every carry entry is some CTA's target exactly once;
    every span a CTA fills and every index it reads lies inside its buffer."""
    n_in = [n0]
    for P, Q, _ in stages:
        n_in.append(n_in[-1] // Q * P)
    S = len(stages)
    seen = [np.zeros(n_in[S], dtype=np.int32)] + [
        np.zeros(T - 1, dtype=np.int32) for _, _, T in stages]
    for t, a, c in geometry.cta_units(stages, n0, lay.tile):
        assert c >= 1
        if t == S:
            seen[0][a:a + c] += 1
        else:
            first = n_in[t] - (stages[t][2] - 1)
            seen[1 + t][a - first:a - first + c] += 1
        for s, (j0, n_j, lo, cnt, origin, top) in geometry.cta_spans(
                stages, lay.regs, t, a, c).items():
            assert top < lay.words[s]
            if n_j:
                assert lo - origin >= geometry.SLACK and lo + cnt - 1 < n_in[s]
    assert all((v == 1).all() for v in seen)
    # the buffers do not overlap and end inside the CTA's shared memory
    end = 0
    for (P, _, T, _, stride, tap_off, _) in lay.rows:
        assert tap_off == end and stride >= T + 10 and stride % 4 == 0
        end += P * stride
    for (_, _, _, _, _, _, buf_off), w in zip(lay.rows, lay.words):
        assert buf_off >= end and buf_off % 4 == 0
        end = buf_off + 2 * w
    assert 4 * end <= lay.smem_bytes


# -- (c) the register tile's walk ---------------------------------------------

def _tile_visits(P, Q, T, R, j0, cnt, threads):
    """``csrc/fir.cuh fir_tile`` without the arithmetic: for each output the
    list of ``(tap, x index)`` in the order the thread meets them."""
    NP = geometry.n_phases(P)
    i_lo = j0 // P
    W = (j0 + cnt - 1) // P - i_lo + 1
    G = -(-W // R)
    visits = {}
    for item in range(G * (P if NP == 1 else 1)):
        p0 = item // G if NP == 1 else 0
        grp = item - p0 * G
        off = [((p0 + p) * Q) // P for p in range(NP)]
        n_top = Q * (i_lo + grp * R + R - 1) + off[-1]
        n_steps = T + Q * (R - 1) + off[-1] - off[0]
        for t4 in range(0, n_steps, 4):
            for p in range(NP):
                for r in range(R):
                    j = (i_lo + grp * R + r) * P + p0 + p
                    l4 = t4 - (Q * (R - 1 - r) + off[-1] - off[p])
                    for u in range(4):
                        if 0 <= l4 + u < T:
                            visits.setdefault(j, []).append((l4 + u, n_top - t4 - u))
    return {j: v for j, v in visits.items() if j0 <= j < j0 + cnt}


@pytest.mark.parametrize("P,Q,T,R", [
    (3, 64, 370, 1), (3, 64, 370, 2), (3, 8, 51, 2), (1, 8, 65, 2),
    (1, 16, 95, 1), (1, 2, 15, 2), (5, 16, 41, 2), (2, 6, 17, 1)])
def test_register_tile_visits_taps_in_ascending_order(P, Q, T, R):
    j0, cnt = 37, 101
    visits = _tile_visits(P, Q, T, R, j0, cnt, threads=64)
    assert sorted(visits) == list(range(j0, j0 + cnt))
    for j, seq in visits.items():
        assert [l for l, _ in seq] == list(range(T))
        assert [n for _, n in seq] == [j * Q // P - l for l in range(T)]


# -- (d) the kernels' device functions on the CPU -----------------------------

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


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _case(seed, stages, C, B, L, fmt, misalign=False):
    rng = np.random.default_rng(seed)
    if fmt == "i16":
        raw = rng.integers(-(1 << 31), 1 << 31, size=B * L + 1,
                           dtype=np.int64).astype(np.int32)
        data = raw[1:] if misalign else raw[:-1]
        data = data.reshape(B, L)
    else:
        data = (rng.standard_normal((2, B, L), dtype=np.float32) * np.float32(0.3))
    plans = np.stack([_random_plans(rng, B, L) for _ in range(C)], axis=1)
    banks = [_bank(rng, st) for st in stages]
    carries = [(rng.standard_normal((C, 2, T - 1), dtype=np.float32)
                * np.float32(0.3)) for _, _, T in stages]
    return data, np.ascontiguousarray(plans), banks, carries


def _designed_banks():
    """The banks the pipelines would use, by ``(P, Q, T)``."""
    found = {}
    for fs in (1_024_000, 100_000_000, 2_048_000, 250_000):
        for st in MultiStageResampler(fs, 48000).stages:
            found[st.P, st.Q, st.T] = np.ascontiguousarray(st.bank, dtype=np.float32)
    rs = RationalResampler(1_024_000, 48000)
    found[rs.P, rs.Q, rs.T] = np.ascontiguousarray(rs.bank, dtype=np.float32)
    return found


BANKS = _designed_banks()


def _bank(rng, stage):
    """The designed bank of a stage the pipelines know, else random taps."""
    P, _, T = stage
    if stage in BANKS:
        return BANKS[stage]
    return (rng.standard_normal((P, T)) / np.sqrt(T)).astype(np.float32)


def _outputs(stages, C, B, L, outtype):
    n = B * L
    for P, Q, _ in stages:
        n = n // Q * P
    out = (np.zeros((C, n), dtype=np.int32) if outtype == "i16"
           else np.zeros((2, C, n), dtype=np.float32))
    return out, [np.zeros((C, 2, T - 1), dtype=np.float32) for _, _, T in stages]


def _reference(emu, case, stages, C, B, L, fmt, outtype):
    data, plans, banks, carries = case
    out, c_out = _outputs(stages, C, B, L, outtype)
    emu.ref_cascade(ctypes.c_void_p(data.ctypes.data), ctypes.c_void_p(out.ctypes.data),
                    ctypes.c_void_p(plans.ctypes.data), _ptrs(banks), _ptrs(carries),
                    _ptrs(c_out), _ints([v for st in stages for v in st]),
                    len(stages), C, B, L, int(fmt == "f32"), int(outtype == "f32"))
    return out, c_out


def _emulate_cascade(emu, case, stages, C, B, L, fmt, outtype, lay):
    data, plans, banks, carries = case
    out, c_out = _outputs(stages, C, B, L, outtype)
    rc = emu.emu_cascade(ctypes.c_void_p(data.ctypes.data), ctypes.c_void_p(out.ctypes.data),
                    ctypes.c_void_p(plans.ctypes.data), _ptrs(banks), _ptrs(carries),
                    _ptrs(c_out), _ints([v for row in lay.rows for v in row]),
                    len(stages), C, B, L, lay.tile, lay.threads,
                    ctypes.c_longlong(lay.smem_bytes), int(fmt == "f32"),
                    int(outtype == "f32"))
    assert rc == 0, "the entry point's checks refuse these arguments"
    return out, c_out


def _emulate_chain(emu, case, stage, C, B, L, fmt, outtype, lay):
    data, plans, banks, carries = case
    out, c_out = _outputs((stage,), C, B, L, outtype)
    P, Q, T, R, stride, tap_off, buf_off = lay.rows[0]
    rc = emu.emu_chain(ctypes.c_void_p(data.ctypes.data), ctypes.c_void_p(out.ctypes.data),
                  ctypes.c_void_p(plans.ctypes.data),
                  ctypes.c_void_p(banks[0].ctypes.data),
                  ctypes.c_void_p(carries[0].ctypes.data),
                  ctypes.c_void_p(c_out[0].ctypes.data), C, B, L, P, Q, T,
                  lay.tile, lay.threads, R, stride, tap_off, buf_off,
                  ctypes.c_longlong(lay.smem_bytes), int(fmt == "f32"),
                  int(outtype == "f32"))
    assert rc == 0, "the entry point's checks refuse these arguments"
    return out, c_out


def _same(got, want):
    return (got[0].tobytes() == want[0].tobytes()
            and all(a.tobytes() == b.tobytes() for a, b in zip(got[1], want[1])))


def _close_to_plain(out, stages, case, B, L, fmt, outtype, chain_stage=None):
    """Channel 0 of the reference against the port's plain torch version."""
    data, plans, banks, carries = case
    t = torch.from_numpy
    if chain_stage:
        P, Q, T = chain_stage
        want, _ = chain.mix_resample_chain_plain(
            t(data.copy()), t(plans[:, 0].copy().view(np.int32)), t(banks[0]),
            t(carries[0][0]), P=P, Q=Q, T=T, intype=fmt, outtype=outtype)
    else:
        want, _ = cascade.mix_cascade_plain(
            t(data.copy()), t(plans[:, 0].copy().view(np.int32)),
            [t(b) for b in banks], [t(c[0]) for c in carries], stages=stages,
            intype=fmt, outtype=outtype)
    if outtype == "i16":
        d = np.abs(out[0].view(np.int16).astype(np.int32)
                   - want.numpy().reshape(-1).view(np.int16).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    else:
        assert np.abs(out[:, 0].reshape(-1) - want.numpy().reshape(-1)).max() <= 2.0 ** -20


CHAIN = (3, 64, 370)


@pytest.mark.parametrize("fmt", ["i16", "f32"])
@pytest.mark.parametrize("tile,threads,R", [
    (128, 128, 1), (96, 64, 2), (384, 256, 2), (33, 32, 1)])
def test_emulated_chain_kernel_bytes(emu, fmt, tile, threads, R):
    C, B, L = 2, 5, 2048
    case = _case(1, (CHAIN,), C, B, L, fmt)
    want = _reference(emu, case, (CHAIN,), C, B, L, fmt, fmt)
    lay = geometry.layout((CHAIN,), tile, threads, (R,))
    assert _same(_emulate_chain(emu, case, CHAIN, C, B, L, fmt, fmt, lay), want)
    assert _same(_emulate_cascade(emu, case, (CHAIN,), C, B, L, fmt, fmt, lay), want)
    if (tile, R) == (128, 1):
        _close_to_plain(want[0], (CHAIN,), case, B, L, fmt, fmt, chain_stage=CHAIN)


@pytest.mark.parametrize("stages,B,L,geoms", [
    (_stages(1_024_000), 3, 2048, [(128, 128, (1, 1)), (256, 256, (2, 1)),
                                   (96, 64, (2, 2)), (50, 32, (1, 2))]),
    (_stages(100_000_000), 8, 2048, [(64, 512, (2, 1)), (16, 128, (2, 2)),
                                     (32, 256, (1, 2))]),
    (_stages(2_048_000), 2, 2048, [(128, 128, (2, 2, 1)), (40, 64, (1, 1, 2))]),
    (_stages(250_000), 3, 96, [(64, 64, (2,)), (24, 32, (1,))]),
    (((5, 16, 41), (2, 4, 9)), 4, 160, [(48, 64, (2, 1)), (20, 32, (1, 2))]),
], ids=["config3", "front100M", "three", "L96", "odd"])
@pytest.mark.parametrize("fmt", ["i16", "f32"])
def test_emulated_cascade_kernel_bytes(emu, stages, B, L, geoms, fmt):
    C = 2
    dense = all(Q % P == 0 for P, Q, _ in stages)
    outtype = "f32" if dense else fmt
    case = _case(2, stages, C, B, L, fmt)
    want = _reference(emu, case, stages, C, B, L, fmt, outtype)
    for tile, threads, regs in geoms:
        lay = geometry.layout(stages, tile, threads, regs)
        got = _emulate_cascade(emu, case, stages, C, B, L, fmt, outtype, lay)
        assert _same(got, want), (tile, threads, regs)
    if L == 2048:
        _close_to_plain(want[0], stages, case, B, L, fmt, outtype)


def test_emulated_kernel_scalar_loads_on_a_misaligned_input(emu):
    """An input that is not 16-byte aligned takes the walker's one-sample
    path; the bytes are the same."""
    stages, C, B, L = _stages(1_024_000), 1, 2, 2048
    case = _case(3, stages, C, B, L, "i16", misalign=True)
    assert case[0].ctypes.data % 16 != 0
    want = _reference(emu, case, stages, C, B, L, "i16", "i16")
    lay = geometry.layout(stages, 64, 96, (2, 1))
    assert _same(_emulate_cascade(emu, case, stages, C, B, L, "i16", "i16", lay), want)


def test_emulated_kernel_short_chunk_takes_carries_through(emu):
    """A chunk shorter than a stage's history: carry entries that come from
    the carry in, spans that start before the chunk."""
    stages, C, B, L = _stages(1_024_000), 2, 1, 64
    case = _case(4, stages, C, B, L, "f32")
    want = _reference(emu, case, stages, C, B, L, "f32", "f32")
    lay = geometry.layout(stages, 16, 32, (2, 1))
    assert _same(_emulate_cascade(emu, case, stages, C, B, L, "f32", "f32", lay), want)


# -- (e) the kernel of --precision fast ---------------------------------------

# (stage, chunk blocks, block length L); D = 2 at config 3 (L = 2048), 1 at
# its f32 blocks (L = 1024, odd chunks) and at its short chunk, 4 at "Q = 1"
FAST_STAGES = {
    "config3": ((3, 64, 370), 5, 2048),
    "config3 f32 blocks": ((3, 64, 370), 3, 1024),
    "short chunk": ((3, 64, 370), 1, 128),
    "two N-tiles": ((11, 32, 45), 3, 512),
    "Q = 8, no pad": ((5, 8, 30), 3, 256),
    "Q = 1": ((2, 1, 23), 2, 128),
    "Q = 1, odd row step": ((5, 1, 23), 2, 64),
}
# (M-tiles of 16·D windows, threads)
FAST_GEOMS = [(6, 192), (1, 32), (4, 96), (3, 128)]


def _fast_geoms(P, Q, L):
    D = geometry.fast_columns(P, Q, L)
    return [(16 * D * m, t) for m, t in FAST_GEOMS]


def test_fast_columns_follow_the_block_length():
    """D: the largest power of two with D·P ≤ 8 and 16·D·Q | L, so every
    chunk of whole blocks tiles; the stage's f32 blocks take D = 1."""
    for (P, Q, _), _, L in FAST_STAGES.values():
        D = geometry.fast_columns(P, Q, L)
        assert D & (D - 1) == 0 and (D * P <= 8 or D == 1)
        assert D == 1 or L % (16 * D * Q) == 0
        assert 2 * D * P > 8 or L % (32 * D * Q) != 0
    assert [geometry.fast_columns(*s[0][:2], s[2]) for s in FAST_STAGES.values()] \
        == [2, 1, 1, 1, 1, 4, 1]
    assert geometry.fast_columns(3, 64, 2048) == 2 and geometry.fast_columns(3, 128, 2048) == 1


@pytest.mark.parametrize("stage,L", [(v[0], v[2]) for v in FAST_STAGES.values()],
                         ids=list(FAST_STAGES))
def test_fast_layout_fits_and_holds_every_fragment(stage, L):
    P, Q, T = stage
    D = geometry.fast_columns(P, Q, L)
    for passes in (3, 1):
        lay = geometry.pick_chain_fast(P, Q, T, L, H100_SMEM, passes)
        assert lay.smem_bytes <= H100_SMEM and lay.threads % 32 == 0
        for windows, threads in _fast_geoms(P, Q, L) + [(lay.windows, lay.threads)]:
            lay = geometry.fast_layout(P, Q, T, L, windows, threads, passes)
            # every tap of every column lies in the k-steps; the last entry a
            # fragment reads lies in its plane; fragments and planes apart
            assert lay.D == D and windows % (16 * D) == 0
            assert 16 * lay.ks >= T + geometry.fast_lead(T) + (P - 1) * Q // P + Q * (D - 1)
            assert lay.nt * 8 >= D * P and (T - 1 + geometry.fast_lead(T)) % 4 == 0
            last = Q * (windows - D) + 16 * lay.ks - 1
            assert last + geometry.fast_pad(D * Q) * (last // (D * Q)) < lay.plane
            assert (lay.bw, lay.planes) == ((4, 4) if passes == 3 else (2, 2))
            assert lay.plane % 8 == 0 and lay.x_off == 32 * lay.bw * lay.ks * lay.nt
            assert lay.smem_bytes == 4 * (lay.x_off + lay.planes * lay.plane // 2)
    with pytest.raises(ValueError, match="power of two"):
        geometry.fast_layout(3, 48, 100, 3072, 16, 32)
    with pytest.raises(ValueError, match="16·D"):
        geometry.fast_layout(P, Q, T, L, 16 * D + 16, 32) if D > 1 else \
            geometry.fast_layout(P, Q, T, L, 24, 32)


# the fast cascade's stages at their input count a block: D = 8, 2 and 8
CASCADE_TAPS = {"÷8 T=65": ((1, 8, 65), 2048), "3/8 T=51": ((3, 8, 51), 256),
                "÷16 T=85": ((1, 16, 85), 2048)}


@pytest.mark.parametrize("stage,L",
                         [(v[0], v[2]) for v in FAST_STAGES.values()]
                         + list(CASCADE_TAPS.values()),
                         ids=list(FAST_STAGES) + list(CASCADE_TAPS))
def test_fast_taps_columns_are_neighbouring_windows(stage, L):
    """The B fragments as dense G (K × 8 per N-tile): row r of the banded
    product with A[r, k] = x[S·r − (T−1) − lead + k] gives, in column
    (d, p) = d·P + p, phase p of window D·r + d exactly (float64), and
    nothing in the columns past D·P."""
    P, Q, T = stage
    rng = np.random.default_rng(11)
    bank = rng.standard_normal((P, T))
    D = geometry.fast_columns(P, Q, L)
    ks, nt = geometry.fast_dims(P, Q, T, D)
    for passes in (3, 1):
        idx = geometry.fast_taps_index(P, Q, T, D, passes).reshape(ks, nt, 32, -1, 2)
        src = np.concatenate([bank.reshape(-1), 10 * bank.reshape(-1), [0.0]])
        G = np.zeros((16 * ks, 8 * nt))
        for s in range(ks):
            for n in range(nt):
                for lane in range(32):
                    for w in range(2):          # the t_h words
                        for h in range(2):
                            k = 16 * s + 2 * (lane % 4) + 8 * w + h
                            G[k, 8 * n + lane // 4] = src[idx[s, n, lane, w, h]]
        if passes == 3:                         # the t_l words: the same taps
            assert np.array_equal(idx[..., 2:, :],
                                  np.where(idx[..., :2, :] == 2 * P * T, 2 * P * T,
                                           idx[..., :2, :] + P * T))
        lead, S, rows = geometry.fast_lead(T), D * Q, 5
        x = rng.standard_normal(S * rows + 16 * ks + T)
        org = T - 1 + lead                       # window 0 sits this far into x
        A = np.stack([x[S * r:S * r + 16 * ks] for r in range(rows)])
        Y = A @ G
        for r in range(rows):
            for c in range(8 * nt):
                d, p = divmod(c, P)
                if d >= D:
                    assert Y[r, c] == 0.0
                    continue
                i = D * r + d
                want = sum(bank[p * Q % P, l] * x[org + Q * i + p * Q // P - l]
                           for l in range(T))
                assert abs(Y[r, c] - want) <= 1e-9 * (1 + abs(want))


def _emulate_chain_fast(emu, case, stage, C, B, L, fmt, lay, passes=3):
    """``emu_chain_fast`` at ``lay``: ``(out, carries_out)``, or 0 where its
    checks refuse the arguments."""
    data, plans, banks, carries = case
    out, c_out = _outputs((stage,), C, B, L, fmt)
    P, Q, T = stage
    taps = chain.fast_taps(torch.from_numpy(banks[0]), P, Q, T, lay.D, passes).numpy()
    rc = emu.emu_chain_fast(
        ctypes.c_void_p(data.ctypes.data), ctypes.c_void_p(out.ctypes.data),
        ctypes.c_void_p(plans.ctypes.data), ctypes.c_void_p(taps.ctypes.data),
        ctypes.c_void_p(carries[0].ctypes.data),
        ctypes.c_void_p(c_out[0].ctypes.data), C, B, L, P, Q, T, lay.D,
        lay.windows, lay.threads, lay.plane, lay.g_off, lay.x_off,
        ctypes.c_longlong(lay.smem_bytes), int(fmt == "f32"), int(fmt == "f32"),
        passes)
    return 0 if rc else (out, c_out)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("fmt", ["i16", "f32"])
@pytest.mark.parametrize("name", list(FAST_STAGES))
def test_emulated_fast_chain_kernel(emu, name, fmt, passes):
    """Three passes (split3) or one (default, the compact layout) against the
    plain version of that dot precision, the same bytes for every geometry."""
    stage, B, L = FAST_STAGES[name]
    P, Q, T = stage
    C = 2
    case = _case(5, (stage,), C, B, L, fmt)
    outs = [_emulate_chain_fast(emu, case, stage, C, B, L, fmt,
                                geometry.fast_layout(P, Q, T, L, *g, passes), passes)
            for g in _fast_geoms(P, Q, L)]
    assert all(o != 0 and _same(o, outs[0]) for o in outs)
    out, c_out = outs[0]
    # the carry is the exact kernel's: the mixed history
    assert _same((out[:0], c_out), (out[:0], _reference(emu, case, (stage,), C, B,
                                                        L, fmt, fmt)[1]))
    data, plans, banks, carries = case
    t = torch.from_numpy
    for c in range(C):
        want, _ = chain.mix_resample_chain_plain(
            t(data.copy()), t(plans[:, c].copy().view(np.int32)), t(banks[0]),
            t(carries[0][c]), P=P, Q=Q, T=T, intype=fmt, outtype=fmt,
            dot_precision="split3" if passes == 3 else "default")
        if fmt == "i16":
            d = np.abs(out[c].view(np.int16).astype(np.int32)
                       - want.numpy().reshape(-1).view(np.int16).astype(np.int32))
            # under 1% of the samples, or one where a chunk has few
            assert d.max() <= 1 and (d > 0).sum() <= max(1, d.size // 100)
        else:
            w = want.numpy().reshape(2, -1)
            assert np.abs(out[:, c] - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("stage,L", [((3, 64, 370), 2048), ((2, 1, 23), 64)],
                         ids=["config3", "Q = 1"])
def test_emulated_fast_chain_bytes_do_not_depend_on_the_chunk_cut(emu, stage, L,
                                                                  passes):
    """Four blocks in one chunk against four chunks of one block (16·D
    windows each: D follows L), from the carries each leaves: window i's
    bytes do not depend on the CTA tile or the chunk it falls in.  The
    kernel refuses a D whose 16·D·Q does not divide L."""
    P, Q, T = stage
    D = geometry.fast_columns(P, Q, L)
    blocks, B = 1, 4
    assert D > 1 and L // Q == 16 * D
    case = _case(8, (stage,), 1, B, L, "i16")
    lay = geometry.fast_layout(P, Q, T, L, 64 * D, 64, passes)
    half = (np.ascontiguousarray(case[0][:, :L // 2]),
            np.ascontiguousarray(case[1]), *case[2:])
    assert _emulate_chain_fast(emu, half, stage, 1, B, L // 2, "i16", lay,
                               passes) == 0
    whole, c_whole = _emulate_chain_fast(emu, case, stage, 1, B, L, "i16", lay, passes)
    data, plans, banks, carries = case
    parts = []
    for b in range(0, B, blocks):
        part = (np.ascontiguousarray(data[b:b + blocks]),
                np.ascontiguousarray(plans[:, :, b:b + blocks]), banks, carries)
        o, c_out = _emulate_chain_fast(emu, part, stage, 1, blocks, L, "i16", lay,
                                       passes)
        parts.append(o)
        carries = c_out
    assert np.concatenate(parts, axis=1).tobytes() == whole.tobytes()
    assert c_out[0].tobytes() == c_whole[0].tobytes()


# -- (f) the cascade kernel of the bf16 dots ----------------------------------

# (stages, chunk blocks, block length L); D per stage in the comment
FAST_CASCADES = {
    "config3": (_stages(1_024_000), 2, 2048),               # (8, 2)
    "config3 f32 blocks": (_stages(1_024_000), 2, 1024),    # (8, 1)
    "front100M": (_stages(100_000_000), 2, 2048),           # (8, 1)
    "three": (_stages(2_048_000), 1, 2048),                 # (8, 8, 1)
    "one stage": (_stages(250_000), 2, 512),                # (8,)
}
# (M-tiles of 16·D of the last stage, threads, M-tiles of stage 0 a slab)
CASCADE_FAST_GEOMS = [(1, 32, 1), (2, 64, 4), (3, 128, 2)]


def _cascade_fast_geoms(stages, L):
    """``(windows, threads, slab)`` of CASCADE_FAST_GEOMS for the stages."""
    Ds = geometry.cascade_fast_columns(stages, L)
    return [(16 * Ds[-1] * m, t, 16 * Ds[0] * k) for m, t, k in CASCADE_FAST_GEOMS]


def test_cascade_fast_columns_per_stage():
    """D_s: the largest power of two with D_s·P_s ≤ 8 and 16·D_s·Q_s
    dividing the stage's input count a block (else 1); config 3 takes 8 and
    2, its f32 blocks and the 100 Msps front 8 and 1."""
    cols = geometry.cascade_fast_columns
    assert cols(_stages(1_024_000), 2048) == (8, 2)
    assert cols(_stages(1_024_000), 1024) == (8, 1)
    assert cols(_stages(100_000_000), 2048) == (8, 1)
    assert cols(_stages(2_048_000), 2048) == (8, 8, 1)
    for fs in (1_024_000, 100_000_000, 2_048_000, 250_000):
        stages = _stages(fs)
        for L in (4096, 2048, 1024, 512, 256):
            blk = L
            for (P, Q, _), D in zip(stages, cols(stages, L)):
                assert D & (D - 1) == 0 and (D == 1 or D * P <= 8)
                assert D == 1 or blk % (16 * D * Q) == 0
                # the largest such D
                assert 2 * D * P > 8 or blk % (32 * D * Q) != 0
                blk = blk * P // Q if blk % Q == 0 else 0.5


def test_cascade_fast_takes_every_chunk_the_old_rule_took(emu):
    """Every chunk in which each stage's window count is a multiple of 16
    (the rule of the one-window-a-row kernel, still
    ``geometry.check_cascade_fast_chunk``) holds whole M-tiles of 16·D_s
    windows at every stage, and the kernel's own checks take it; those
    that fail the old rule stay refused."""
    for fs in (1_024_000, 100_000_000, 2_048_000):
        stages = _stages(fs)
        S = len(stages)
        for L in (2048, 1024, 512):
            windows, threads, slab = _cascade_fast_geoms(stages, L)[0]
            lay = geometry.cascade_fast_layout(stages, L, windows, threads, 3, slab)
            layout = _ints([v for row in lay.rows for v in row])
            for B in range(1, 9):
                try:
                    geometry.check_cascade_fast_chunk(stages, B, L)
                    old = True
                except ValueError:
                    old = False
                units = len(geometry.fast_cta_units(stages, B * L, lay.windows))
                out = np.zeros((units, 3 + 6 * S), dtype=np.int64)
                n = emu.emu_fast_cascade_plans(layout, S, B, L, lay.windows, lay.slab,
                                               3, ctypes.c_longlong(lay.smem_bytes),
                                               ctypes.c_void_p(out.ctypes.data))
                assert n == (units if old else -1), (fs, L, B)
                k = B * L
                for (P, Q, _), D in zip(stages, lay.columns):
                    assert not old or (k // Q) % (16 * D) == 0
                    k = k // Q * P


@pytest.mark.parametrize("name", ["config 3 cascade", "config 5 / split front",
                                  "2.048 Msps, three stages", "config 3 chain"])
@pytest.mark.parametrize("tiles", [None, 1, 3])
@pytest.mark.parametrize("passes", [3, 1])
def test_cascade_fast_geometry_fits_and_covers(name, tiles, passes):
    """Every output and carry entry is one CTA's target; every window a CTA
    computes starts its M-tile at a multiple of 16·D_s; its span lies inside
    the layout's planes (x_0's a slab at a time, every slab starting at a
    multiple of 16·D_0); stage s−1 keeps exactly the entries of x_s the span
    reads from the chunk."""
    stages, n0 = PICKED[name]
    L = 2048
    Ds = geometry.cascade_fast_columns(stages, L)
    lay = (geometry.pick_cascade_fast(stages, L, H100_SMEM, passes) if tiles is None
           else geometry.cascade_fast_layout(stages, L, 16 * Ds[-1] * tiles, 256,
                                             passes, 16 * Ds[0] * tiles))
    assert lay.slab % (16 * Ds[0]) == 0
    assert 0 < lay.smem_bytes <= H100_SMEM or tiles is not None
    assert lay.columns == Ds and lay.windows % (16 * Ds[-1]) == 0
    geometry.check_cascade_fast_chunk(stages, n0 // L, L)
    n_in = [n0]
    for P, Q, _ in stages:
        n_in.append(n_in[-1] // Q * P)
    S = len(stages)
    seen = [np.zeros(n_in[S], dtype=np.int32)] + [
        np.zeros(T - 1, dtype=np.int32) for _, _, T in stages]
    for t, a, c in geometry.fast_cta_units(stages, n0, lay.windows):
        if t == S:
            seen[0][a:a + c] += 1
        else:
            first = n_in[t] - (stages[t][2] - 1)
            seen[1 + t][a - first:a - first + c] += 1
        spans = geometry.fast_cta_spans(stages, Ds, n0, t, a, c)
        want = (max(a, 0), a + c - 1)
        for s in range(t - 1, -1, -1):
            (P, Q, T), D = stages[s], Ds[s]
            ja, jb, w0, rows, org, length = spans[s]
            assert (ja, jb) == want
            if jb < ja:
                break
            assert w0 % (16 * D) == 0 and rows % (16 * D) == 0
            assert w0 <= ja // P and jb // P < w0 + rows
            K = length - Q * (rows - D)
            # x_0 a slab at a time: each slab's span inside the planes
            part = rows if s else min(rows, lay.slab)
            assert Q * (part - D) + K <= lay.spans[s]
            want = (max(org, 0), min(org + length, n_in[s]) - 1)
    assert all((v == 1).all() for v in seen)
    # the regions of the stages lie apart, inside the CTA
    end = 0
    bw, planes = (4, 4) if passes == 3 else (2, 2)
    for (P, Q, T, D, plane, g_off, x_off), span in zip(lay.rows, lay.spans):
        ks, nt = geometry.fast_dims(P, Q, T, D)
        assert g_off == end and x_off == g_off + 32 * bw * ks * nt
        last = span - 1
        assert last + geometry.fast_pad(D * Q) * (last // (D * Q)) < plane
        assert plane % 8 == 0
        end = x_off + planes * plane // 2
    assert 4 * end == lay.smem_bytes
    with pytest.raises(ValueError, match="16·Q"):
        geometry.check_cascade_fast_chunk(_stages(100_000_000), 3, 2048)
    with pytest.raises(ValueError, match="16·D"):
        geometry.cascade_fast_layout(_stages(1_024_000), 2048, 48, 256)


def test_cascade_fast_pick_gives_a_chunk_three_tiles_an_sm():
    """The tile is capped so that a chunk gives every SM of the card (132 on
    an H100) three tiles: 32 windows for the CLI's 256 blocks at config 3,
    the largest that leave three CTAs an SM on a large chunk."""
    stages, L = _stages(1_024_000), 2048
    for B, want in ((256, (32, 32)), (1024, (64, 64)), (16384, (256, 512))):
        windows = B * L // 64
        for passes, w in zip((3, 1), want):
            lay = geometry.pick_cascade_fast(stages, L, H100_SMEM, passes,
                                             windows // (3 * 132))
            assert lay.windows == w
            assert lay.windows == 32 or windows // lay.windows >= 3 * 132
    assert geometry.pick_cascade_fast(stages, L, H100_SMEM, 3, 5).windows == 32


@pytest.mark.parametrize("name", list(FAST_CASCADES))
def test_emulated_fast_cascade_plan_is_the_geometry_walk(emu, name):
    """``csrc/cascade_fast.cu fast_cascade_plan`` of every CTA equals
    ``geometry.fast_cta_units`` / ``fast_cta_spans``, which the test above
    holds to the rules (tiles at multiples of 16·D windows, spans inside the
    planes, every target once)."""
    stages, B, L = FAST_CASCADES[name]
    B *= 8
    S = len(stages)
    for windows, _, slab in _cascade_fast_geoms(stages, L)[::2]:
        lay = geometry.cascade_fast_layout(stages, L, windows, 256, 3, slab)
        units = geometry.fast_cta_units(stages, B * L, windows)
        out = np.zeros((len(units), 3 + 6 * S), dtype=np.int64)
        n = emu.emu_fast_cascade_plans(
            _ints([v for row in lay.rows for v in row]), S, B, L, windows, slab, 3,
            ctypes.c_longlong(lay.smem_bytes), ctypes.c_void_p(out.ctypes.data))
        assert n == len(units)
        for row, (t, a, c) in zip(out, units):
            want = [t, a, c] + [0] * (6 * S)
            for s, span in geometry.fast_cta_spans(stages, lay.columns, B * L, t, a,
                                                   c).items():
                want[3 + 6 * s:9 + 6 * s] = span
            assert row.tolist() == want
    windows, _, slab = _cascade_fast_geoms(stages, L)[0]
    lay = geometry.cascade_fast_layout(stages, L, windows, 256, 3, slab)
    rows = [list(row) for row in lay.rows]
    refused = []
    small = [r[:] for r in rows]
    small[0][4] = 8                                  # planes too small
    refused.append(small)
    if lay.columns[0] > 1:                           # a D the blocks do not tile
        wide = [r[:] for r in rows]
        wide[0][3] *= 2
        refused.append(wide)
    for bad in refused:
        assert emu.emu_fast_cascade_plans(
            _ints([v for row in bad for v in row]), S, B, L, windows, slab, 3,
            ctypes.c_longlong(10 * lay.smem_bytes), None) == -1
    # a slab that is not whole M-tiles of stage 0
    assert emu.emu_fast_cascade_plans(
        _ints([v for row in rows for v in row]), S, B, L, windows, slab + 8, 3,
        ctypes.c_longlong(10 * lay.smem_bytes), None) == -1


def _emulate_cascade_fast(emu, case, stages, B, L, fmt, outtype, lay):
    """Channel 0 of ``case`` through ``emu_cascade_fast``, its B fragments
    laid out by ``chain.fast_taps`` as the wrapper lays them out."""
    data, plans, banks, carries = case
    out, c_out = _outputs(stages, 1, B, L, outtype)
    taps = [chain.fast_taps(torch.from_numpy(b), P, Q, T, D, lay.passes).numpy()
            for b, (P, Q, T), D in zip(banks, stages, lay.columns)]
    c_in = [np.ascontiguousarray(c[0]) for c in carries]
    c_out = [c[0] for c in c_out]
    rc = emu.emu_cascade_fast(
        ctypes.c_void_p(data.ctypes.data), ctypes.c_void_p(out.ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(plans[:, 0]).ctypes.data),
        _ptrs(taps), _ptrs(c_in), _ptrs(c_out),
        _ints([v for row in lay.rows for v in row]), len(stages), B, L,
        lay.windows, lay.slab, lay.threads, ctypes.c_longlong(lay.smem_bytes),
        int(fmt == "f32"), int(outtype == "f32"), lay.passes)
    assert rc == 0, "the entry point's checks refuse these arguments"
    return out, c_out


def _fast_close(got, want, outtype, passes):
    """The card tests' tolerance of a fast cascade against its plain version
    (``test_torch_cuda.py``): three passes ≤ 1 LSB in under 1% of samples,
    float32 1e-5 of the largest output; one pass ≥ 70 dB and beyond those
    bounds in under 0.1% (a later stage's bf16 rounding of x_s may differ
    by one ulp where the two sum x_s in other orders)."""
    if outtype == "i16":
        g = got.reshape(-1).view(np.int16).astype(np.float64)
        w = want.reshape(-1).view(np.int16).astype(np.float64)
        off = np.abs(g - w) > (1 if passes == 1 else 0)
    else:
        g, w = got.reshape(2, -1).astype(np.float64), want.reshape(2, -1)
        off = np.abs(g - w) > 1e-5 * np.abs(w).max()
    if passes == 3:
        assert not off.any() if outtype == "f32" else (
            np.abs(g - w).max() <= 1 and off.sum() <= max(1, off.size // 100))
        return
    snr = 10 * np.log10((w ** 2).sum() / max(((g - w) ** 2).sum(), 1e-30))
    assert off.mean() < 1e-3 and snr >= 70.0


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("fmt", ["i16", "f32"])
@pytest.mark.parametrize("name", list(FAST_CASCADES))
def test_emulated_fast_cascade_kernel(emu, name, fmt, passes):
    """The same bytes and carries for every tile and thread count, in a CTA
    whose shared memory starts as NaN (every band entry a fragment reads is
    written), at D_s > 1 and, for one pass, in the compact layout; the
    stage-0 carry bitwise the exact kernel's; within the card tests'
    tolerance of the plain version of its dot precision, the later carries
    included."""
    stages, B, L = FAST_CASCADES[name]
    dense = all(Q % P == 0 for P, Q, _ in stages)
    outtype = "f32" if dense else fmt
    case = _case(6, stages, 1, B, L, fmt)
    outs = [_emulate_cascade_fast(emu, case, stages, B, L, fmt, outtype,
                                  geometry.cascade_fast_layout(stages, L, w, t, passes, k))
            for w, t, k in _cascade_fast_geoms(stages, L)]
    assert all(_same(o, outs[0]) for o in outs[1:])
    out, c_out = outs[0]
    exact = _reference(emu, case, stages, 1, B, L, fmt, outtype)
    assert c_out[0].tobytes() == exact[1][0][0].tobytes()
    data, plans, banks, carries = case
    t = torch.from_numpy
    want, c_want = cascade.mix_cascade_plain(
        t(data.copy()), t(plans[:, 0].copy().view(np.int32)), [t(b) for b in banks],
        [t(c[0]) for c in carries], stages=stages, intype=fmt, outtype=outtype,
        final_dense=dense, dot_precision="split3" if passes == 3 else "default")
    _fast_close(out[0] if outtype == "i16" else out[:, 0], want.numpy(), outtype,
                passes)
    for got, w in zip(c_out[1:], c_want[1:]):
        _fast_close(got, w.numpy(), "f32", passes)


def test_emulated_fast_cascade_bytes_do_not_depend_on_the_chunk_cut(emu):
    """Config 3 at D = (8, 2), split3 and the compact one pass: 4 blocks in
    one chunk against 4 chunks of one block and 2 chunks of two, from the
    carries each leaves."""
    stages, B, L = _stages(1_024_000), 4, 2048
    case = _case(7, stages, 1, B, L, "i16")
    data, plans, banks, _ = case
    for passes in (3, 1):
        lay = geometry.cascade_fast_layout(stages, L, 32, 64, passes, 256)
        assert lay.columns == (8, 2)
        whole, c_whole = _emulate_cascade_fast(emu, case, stages, B, L, "i16", "i16",
                                               lay)
        for blocks in (1, 2):
            carries, parts = case[3], []
            for b in range(0, B, blocks):
                part = (np.ascontiguousarray(data[b:b + blocks]),
                        np.ascontiguousarray(plans[:, :, b:b + blocks]), banks, carries)
                o, c_out = _emulate_cascade_fast(emu, part, stages, blocks, L, "i16",
                                                 "i16", lay)
                parts.append(o)
                carries = [c[None] for c in c_out]
            assert np.concatenate(parts, axis=1).tobytes() == whole.tobytes()
            assert all(a.tobytes() == b.tobytes() for a, b in zip(c_out, c_whole))


@pytest.mark.parametrize("passes", [3, 1])
def test_emulated_fast_cascade_nan_reach(emu, passes):
    """A NaN input sample reaches no output outside the band the kernel's
    header states, and every output the plain version's taps reach."""
    stages, B, L = _stages(1_024_000), 2, 2048
    case = _case(9, stages, 1, B, L, "f32")
    case[0][0, 0, 1500] = np.nan
    lay = geometry.cascade_fast_layout(stages, L, 32, 64, passes, 128)
    out, _ = _emulate_cascade_fast(emu, case, stages, B, L, "f32", "f32", lay)
    got = set(np.flatnonzero(np.isnan(out[:, 0]).any(axis=0)).tolist())
    data, plans, banks, carries = case
    t = torch.from_numpy
    want, _ = cascade.mix_cascade_plain(
        t(data.copy()), t(plans[:, 0].copy().view(np.int32)), [t(b) for b in banks],
        [t(c[0]) for c in carries], stages=stages, intype="f32", outtype="f32",
        dot_precision="split3" if passes == 3 else "default")
    plain = set(np.flatnonzero(np.isnan(want.numpy().reshape(2, -1)).any(axis=0)).tolist())
    band = geometry.cascade_fast_nan_reach(stages, lay.columns, B * L, [1500])
    assert plain and plain <= got <= band


# -- (g) the mixer -------------------------------------------------------------

MIXER_FORMATS = [("i16", "i16"), ("i16", "f32"), ("f32", "i16"), ("f32", "f32")]


def _mixer_case(seed, C, B, L, intype, outtype, misalign=False):
    rng = np.random.default_rng(seed)
    if intype == "i16":
        raw = rng.integers(-(1 << 31), 1 << 31, size=B * L + 1,
                           dtype=np.int64).astype(np.int32)
    else:
        raw = (rng.standard_normal(2 * B * L + 1) * 0.5).astype(np.float32)
        if outtype == "i16":        # the encode's NaN → 0 and saturation
            raw[rng.integers(0, raw.size, 8)] = np.nan
            raw[rng.integers(0, raw.size, 8)] = np.inf
            raw[rng.integers(0, raw.size, 8)] = 3.0
    data = raw[1:] if misalign else raw[:-1]
    data = data.reshape((B, L) if intype == "i16" else (2, B, L))
    plans = np.stack([_random_plans(rng, B, L) for _ in range(C)], axis=1)
    return data, np.ascontiguousarray(plans)


def _emulate_mixer(emu, data, plans, C, B, L, intype, outtype, G):
    out = (np.zeros((C, B, L), dtype=np.int32) if outtype == "i16"
           else np.zeros((2, C, B, L), dtype=np.float32))
    path = emu.emu_mixer(ctypes.c_void_p(data.ctypes.data),
                         ctypes.c_void_p(out.ctypes.data),
                         ctypes.c_void_p(plans.ctypes.data), C, B, L,
                         int(intype == "f32"), int(outtype == "f32"), G)
    assert path in (1, 2), "the entry point's checks refuse these arguments"
    return out, path


def _mixer_plain(data, plans, intype, outtype):
    return mixer.mix_blocks_fmt_channels_plain(
        torch.from_numpy(data.copy()), torch.from_numpy(plans.view(np.int32)),
        intype=intype, outtype=outtype).numpy()


@pytest.mark.parametrize("intype,outtype", MIXER_FORMATS)
@pytest.mark.parametrize("C", [1, 3, 16])
def test_emulated_mixer_bitwise_plain(emu, C, intype, outtype):
    """The 16-byte path: plan words that switch segment inside a block, every
    G (and 0, the kernel's own pick) bitwise the plain version."""
    B, L = 3, 2048 if C < 16 else 1024
    data, plans = _mixer_case(20 + C, C, B, L, intype, outtype)
    want = _mixer_plain(data, plans, intype, outtype)
    for G in (0, 1, 2, 4, 16):
        got, path = _emulate_mixer(emu, data, plans, C, B, L, intype, outtype, G)
        assert path == 2 and got.tobytes() == want.tobytes(), G


@pytest.mark.parametrize("misalign,L", [(True, 2048), (False, 98)],
                         ids=["misaligned", "odd L"])
def test_emulated_mixer_one_sample_path(emu, misalign, L):
    """Where the 16-byte path cannot run, one sample a step: the same bits."""
    C, B = 3, 2
    for intype, outtype in MIXER_FORMATS:
        data, plans = _mixer_case(30, C, B, L, intype, outtype, misalign=misalign)
        want = _mixer_plain(data, plans, intype, outtype)
        got, path = _emulate_mixer(emu, data, plans, C, B, L, intype, outtype, 2)
        assert path == 1 and got.tobytes() == want.tobytes(), (intype, outtype)


def test_mixer_group_pick(emu):
    """The kernel's own pick (``csrc/mixer.cu mixer_group``): G divides no
    C in particular; the pick keeps a wave of CTAs."""
    pick = emu.doppler_mixer_group
    assert pick(1, 16384, 2048) == 1
    assert pick(16, 16384, 2048) == 16
    assert pick(16, 256, 2048) == 2
    assert pick(3, 4096, 2048) == 2
    for C, B in ((256, 3), (5, 1), (7, 100000)):
        G = pick(C, B, 2048)
        assert G in (16, 8, 4, 2, 1) and G <= C


# -- (h) the chain-shaped mix probe ----------------------------------------------

# name -> (B, L, tile, P, Q)
SHAPE_CASES = {
    "tile=L, odd B": (3, 2048, 2048, 3, 64),
    "tile=L/2": (2, 2048, 1024, 3, 64),
    "tile=1.5L": (3, 2048, 3072, 3, 64),
    "keep%4=2": (2, 768, 384, 3, 64),
    "keep=384": (2, 2048, 2048, 3, 16),     # kept words over three trips a lane
}
SHAPE_GEOMS = [(8, 1, 1), (4, 1, 2), (1, 1, 1), (8, 4, 1), (2, 2, 2)]


def _shape_case(seed, B, L, misalign=False):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-(1 << 31), 1 << 31, size=B * L + 1,
                       dtype=np.int64).astype(np.int32)
    data = (raw[1:] if misalign else raw[:-1]).reshape(B, L)
    plans = _random_plans(rng, B, L)
    plans[6, 0] = 4 * (L // 8) + 2        # a segment switch inside a group
    return data, np.ascontiguousarray(plans)


def _shape_path(L, tile, keep, split, depth, vec4=True, rows_aligned=True):
    """The path emu_chain_shape reports: 2 the warp's own loop (16-byte
    loads, tiles inside blocks, whole trips of ``depth`` groups for every
    lane), 1 mix_span's; + 4 where a kept group is one 16-byte store."""
    fast = (vec4 and tile % 4 == 0 and L % tile == 0
            and (tile // 4) % (32 * split * depth) == 0)
    rows16 = rows_aligned and tile % 4 == 0 and keep % 4 == 0
    return (2 if fast else 1) + (4 if rows16 else 0)


def _emulate_shape(emu, data, plans, B, L, tile, keep, tone, geom, row_off=0):
    n_tiles = B * L // tile
    buf = np.full(n_tiles * keep + 4, 7, dtype=np.int32)
    out = buf[row_off:row_off + n_tiles * keep]
    side = np.full(n_tiles, 7, dtype=np.int32)
    path = emu.emu_chain_shape(ctypes.c_void_p(data.ctypes.data),
                               ctypes.c_void_p(out.ctypes.data),
                               ctypes.c_void_p(side.ctypes.data),
                               ctypes.c_void_p(plans.ctypes.data), B, L, tile, keep,
                               1 if tone == "fold" else 2, *geom)
    return out.reshape(n_tiles, keep), side, path


@pytest.mark.parametrize("tone", ["fold", "select"])
@pytest.mark.parametrize("name", list(SHAPE_CASES))
def test_emulated_chain_shape_bitwise_plain(emu, name, tone):
    """Every launch geometry gives the plain version's words and side words;
    the path taken is the one the geometry calls for."""
    B, L, tile, P, Q = SHAPE_CASES[name]
    data, plans = _shape_case(60, B, L)
    want = probes.mix_shape_run_plain(torch.from_numpy(data.copy()),
                                      torch.from_numpy(plans.view(np.int32)),
                                      P=P, Q=Q, tone=tone, tile=tile)
    keep = tile // Q * P
    for geom in SHAPE_GEOMS:
        out, side, path = _emulate_shape(emu, data, plans, B, L, tile, keep, tone, geom)
        assert path == _shape_path(L, tile, keep, geom[1], geom[2]), geom
        assert np.array_equal(out, want[0].numpy()), geom
        assert np.array_equal(side, want[1].numpy()), geom


@pytest.mark.parametrize("misalign,row_off", [(True, 0), (False, 1)],
                         ids=["misaligned input", "misaligned rows"])
def test_emulated_chain_shape_scalar_paths(emu, misalign, row_off):
    """A misaligned input takes mix_span one sample a step; misaligned rows
    store a kept group as four words: the same bits."""
    B, L, tile, P, Q = 3, 2048, 2048, 3, 64
    data, plans = _shape_case(61, B, L, misalign=misalign)
    keep = tile // Q * P
    for tone in ("fold", "select"):
        want = probes.mix_shape_run_plain(torch.from_numpy(data.copy()),
                                          torch.from_numpy(plans.view(np.int32)),
                                          P=P, Q=Q, tone=tone)
        for geom in ((8, 1, 1), (8, 4, 1)):
            out, side, path = _emulate_shape(emu, data, plans, B, L, tile, keep, tone,
                                             geom, row_off)
            assert path == _shape_path(L, tile, keep, geom[1], geom[2], vec4=not misalign,
                                       rows_aligned=not row_off), geom
            assert np.array_equal(out, want[0].numpy()), (tone, geom)
            assert np.array_equal(side, want[1].numpy()), (tone, geom)


def test_emulated_chain_shape_refuses_bad_geometry(emu):
    data, plans = _shape_case(62, 2, 2048)
    for geom in ((9, 1, 1), (0, 1, 1), (4, 3, 1), (2, 4, 1), (8, 8, 1), (4, 1, 3)):
        assert _emulate_shape(emu, data, plans, 2, 2048, 2048, 96, "fold", geom)[2] == 0


@pytest.mark.parametrize("B", [256, 16384])
def test_chain_shape_geometry_pick(emu, B):
    """At the tools' tile (2048 = L): one warp a tile in 8-warp CTAs at B =
    16384, two groups a lane loaded ahead; at the CLI's B = 256 four warps
    a tile, two tiles a CTA, so that the 256 tiles still give every SM of
    132 nearly eight warps.  Either way each lane takes whole groups of
    four (the warp's own loop) and the kernel takes the launch."""
    sm = 132
    tile = probes.chain_tile(B * 2048, 3, 64)
    g = probes.shape_geometry(B * 2048 // tile, tile, sm)
    n_tiles = B * 2048 // tile
    assert tile == 2048 and g.warps == probes.SHAPE_MAX_WARPS
    # 16 groups a lane keep two loaded ahead; 4 (a tile over four warps) one
    assert g == (probes.ShapeGeometry(8, 1, 2) if B == 16384
                 else probes.ShapeGeometry(8, 4, 1))
    # the least split that gives every SM its warps, at most four warps a tile
    want = probes.SHAPE_WARPS_PER_SM * sm
    assert g.split == 4 or n_tiles * g.split >= want
    assert g.split == 1 or n_tiles * g.split // 2 < want
    assert (tile // 4) % (32 * g.split) == 0
    data, plans = _shape_case(63, 2, 2048)
    geom = (g.warps, g.split, g.depth)
    assert _emulate_shape(emu, data, plans, 2, 2048, 2048, 96, "fold", geom)[2] == 6
