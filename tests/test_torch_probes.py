"""The roofline probes and the Q15 mixer: the port's plain versions against
what the JAX tools' kernel bodies compute.  The CUDA kernels against the plain
versions are in ``test_torch_cuda.py``.

The elementwise, chain-shape and mix-shape kernels of ``tools/roofline.py``
and ``tools/probe_chain_precision.py`` are closures inside ``main()`` and
cannot be imported, so the plain versions are held to the JAX package's own
functions that those bodies call: identity; ``doppler_tpu.ops.codec`` decode
then encode (bitwise); the same slice of ``mix_blocks_pallas``'s words in
interpret mode (≤ 1 LSB in under 1% of samples, the mixer's cross-package
bar: XLA may contract a product of the tone or the rotation into an FMA).
The Q15 mixer is held to ``mix_blocks_pallas_q15`` in interpret mode at the
same bar: a tone that differs by an ulp can move ``c15`` by one step, which
moves an output by at most 1 LSB.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops import codec as jcodec
from doppler_tpu.ops.pallas.mixer import mix_blocks_pallas, mix_blocks_pallas_q15
from doppler_tpu_torch import oracle
from doppler_tpu_torch.ops import nco, sincos
from doppler_tpu_torch.ops.cuda import probes
from doppler_tpu_torch.ops.cuda.mixer import (
    mix_blocks_fmt_plain,
    mix_blocks_q15,
    mix_blocks_q15_plain,
)
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
P, Q = 3, 64


def _case(B, L, seed, switch=True):
    """Words of full-range i16 pairs and a plan whose switch t falls inside
    some blocks (a rounding-reset-heavy shift) unless ``switch`` is False."""
    rng = np.random.default_rng(seed)
    plan = plan_blocks([327843.76] * (B // 2) + [-15000.0] * (B - B // 2),
                       [L] * B, FS, NCOState(samplenum=40000), L)
    assert not switch or (plan.t < L).any()
    words = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                         dtype=np.int64).astype(np.int32)
    return words, plan


def _fields(plan):
    return [getattr(plan, f) for f in nco.PLAN_FIELDS]


def _i16_diff(a, b):
    a = np.ascontiguousarray(a).view(np.int16).astype(np.int32)
    b = np.ascontiguousarray(b).view(np.int16).astype(np.int32)
    return np.abs(a - b)


def _iq(words):
    return oracle.decode_i16_bytes(np.ascontiguousarray(words).tobytes())


# -- kernel 3: the Q15 mixer ---------------------------------------------------

@pytest.mark.parametrize("B,L", [(4, 2048), (8, 1024)])
def test_q15_plain_matches_jax_pallas_q15(B, L):
    words, plan = _case(B, L, 21)
    launches = mix_blocks_q15.launches
    got = mix_blocks_q15(torch.from_numpy(words), nco.plan_tensor(plan)).numpy()
    assert mix_blocks_q15.launches == launches      # CPU tensor: no kernel
    want = np.asarray(mix_blocks_pallas_q15(jnp.asarray(words), *_fields(plan),
                                            interpret=True))
    d = _i16_diff(got, want)
    assert d.max() <= 1 and np.mean(d > 0) < 0.01


def test_q15_extremes_saturate_and_do_not_wrap():
    """±32768/32767 components at every tone: the int32 products stay in
    range (scale 32767) and the outputs saturate instead of wrapping."""
    B, L = 4, 1024
    _, plan = _case(B, L, 22)
    ext = np.array([-32768, 32767], dtype=np.int64)
    rng = np.random.default_rng(23)
    i = ext[rng.integers(0, 2, size=(B, L))]
    q = ext[rng.integers(0, 2, size=(B, L))]
    words = ((i & 0xFFFF) | ((q & 0xFFFF) << 16)).astype(np.uint32).view(np.int32)
    plans = nco.plan_tensor(plan)
    got = mix_blocks_q15_plain(torch.from_numpy(words), plans).numpy()
    # the rotation of a full-scale corner (|z| = √2) in float64, saturated:
    # a wrapped int32 product would land far from it
    q24 = nco.phase_q24(plans, L).numpy()
    z = (i + 1j * q) * np.exp(-2j * np.pi * q24 / float(1 << 24)) * (32767 / 32768)
    want_i = np.clip(z.real, -32768, 32767)
    want_q = np.clip(z.imag, -32768, 32767)
    g = got.view(np.int16).reshape(B, L, 2).astype(np.float64)
    # 3 LSB: the Q15 tone's half step times |z| ≤ 46341 is 0.7, the
    # truncation toward zero up to 1, the comparison's own rounding the rest
    assert np.abs(g[..., 0] - want_i).max() <= 3
    assert np.abs(g[..., 1] - want_q).max() <= 3
    assert (np.abs(g) >= 32767).any()               # saturation was reached


def test_q15_snr_against_the_exact_mixer():
    """A 15-bit tone: at least 80 dB from the float32 mixer's output."""
    words, plan = _case(8, 2048, 24)
    # moderate amplitudes, so that saturation does not enter the score
    rng = np.random.default_rng(25)
    pairs = rng.integers(-9000, 9000, size=(8, 2048, 2), dtype=np.int16)
    words = np.ascontiguousarray(pairs).view(np.int32).reshape(8, 2048)
    plans = nco.plan_tensor(plan)
    got = mix_blocks_q15_plain(torch.from_numpy(words), plans).numpy()
    exact = mix_blocks_fmt_plain(torch.from_numpy(words), plans).numpy()
    assert _i16_diff(got, exact).max() <= 2
    assert oracle.snr_db(_iq(exact), _iq(got)) >= 80.0


def test_q15_rejects_bad_layouts():
    words, plan = _case(2, 1024, 1, switch=False)
    with pytest.raises(ValueError, match="plans"):
        mix_blocks_q15(torch.from_numpy(words), nco.plan_tensor(plan)[:, :1])
    with pytest.raises(ValueError, match="i16 input"):
        mix_blocks_q15(torch.from_numpy(words).float(), nco.plan_tensor(plan))


# -- kernel 7: the elementwise probes --------------------------------------------

@pytest.mark.parametrize("vec", [1, 4])
def test_elementwise_copy_is_identity(vec):
    words, _ = _case(4, 1024, 31)
    x = torch.from_numpy(words)
    launches = probes.probe_elementwise.launches
    got = probes.probe_elementwise(x, body="copy", vec=vec)
    assert probes.probe_elementwise.launches == launches
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("vec", [1, 4])
def test_elementwise_codec_matches_jax_codec_bitwise(vec):
    words, _ = _case(4, 1024, 32)
    got = probes.probe_elementwise(torch.from_numpy(words), body="codec",
                                   vec=vec).numpy()
    want = np.asarray(jcodec.iq_to_i16_words(
        *jcodec.i16_words_to_iq(jnp.asarray(words))))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("body", ["copy", "codec"])
def test_elementwise_writes_into_the_callers_buffer(body):
    words, _ = _case(4, 1024, 33)
    x = torch.from_numpy(words)
    out = torch.full_like(x, 7)
    assert probes.probe_elementwise(x, body=body, vec=4, out=out) is out
    assert torch.equal(out, probes.probe_elementwise_plain(x, body=body))
    for bad in (out.float(), out[:, :-4], out.t()):
        with pytest.raises(ValueError, match="out must be"):
            probes.probe_elementwise(x, body=body, out=bad)


def test_elementwise_rejects_bad_arguments():
    x = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="body"):
        probes.probe_elementwise(x, body="xor")
    with pytest.raises(ValueError, match="vec"):
        probes.probe_elementwise(x, vec=2)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.probe_elementwise(x, vec=4)
    with pytest.raises(ValueError, match="int32"):
        probes.probe_elementwise(x.float())


# -- kernels 8 and 9: the chain-shaped probes ------------------------------------

def _xor_rows(a):
    return np.bitwise_xor.reduce(a, axis=1)


@pytest.mark.parametrize("B,L,tile", [(4, 2048, None), (8, 1024, 512), (3, 1024, 1536)])
def test_chain_copy_is_the_slice_of_the_words(B, L, tile):
    words, plan = _case(B, L, 41) if B % 2 == 0 else _case(4, L, 41)
    words = words[:B]
    plans = nco.plan_tensor(plan)[:, :B]
    out, side = probes.chain_shape_run(torch.from_numpy(words), plans, P=P, Q=Q,
                                       do_mix=False, tile=tile)
    t = tile or probes.chain_tile(B * L, P, Q)
    keep = t * P // Q
    tiles = words.reshape(-1, t)
    assert tuple(out.shape) == (B * L // t, keep)
    assert np.array_equal(out.numpy(), tiles[:, :keep])
    assert np.array_equal(side.numpy(), _xor_rows(tiles[:, keep:]))


@pytest.mark.parametrize("run", ["chain-mix", "mix-fold", "mix-select"])
@pytest.mark.parametrize("B,L", [(4, 2048), (8, 1024)])
def test_mix_probes_match_the_jax_pallas_mixer_slice(run, B, L):
    words, plan = _case(B, L, 42)
    x, plans = torch.from_numpy(words), nco.plan_tensor(plan)
    if run == "chain-mix":
        out, side = probes.chain_shape_run(x, plans, P=P, Q=Q, do_mix=True)
    else:
        out, side = probes.mix_shape_run(x, plans, P=P, Q=Q, tone=run[4:])
    t = probes.chain_tile(B * L, P, Q)
    keep = t * P // Q
    want = np.asarray(mix_blocks_pallas(jnp.asarray(words), *_fields(plan),
                                        interpret=True)).reshape(-1, t)
    d = _i16_diff(out.numpy(), want[:, :keep])
    assert d.max() <= 1 and np.mean(d > 0) < 0.01
    # within the port: exactly the mixer's plain words, and side is the XOR
    # of every word that out does not hold
    mixed = mix_blocks_fmt_plain(x, plans).numpy().reshape(-1, t)
    assert np.array_equal(out.numpy(), mixed[:, :keep])
    assert np.array_equal(side.numpy(), _xor_rows(mixed[:, keep:]))


def test_select_and_fold_tones_agree_bitwise():
    """All quadrants, and the phases where a polynomial is exactly zero (a
    fold could differ there in the sign of the zero)."""
    q24 = torch.cat([
        torch.arange(0, 1 << 24, 4099, dtype=torch.int32),
        torch.tensor([0, 1 << 22, 2 << 22, 3 << 22, (1 << 24) - 1, (1 << 22) - 1],
                     dtype=torch.int32)])
    cf, sf = sincos.sincos_q24_neg(q24)
    cs, ss = sincos.sincos_q24_neg_select(q24)
    assert torch.equal(cf.view(torch.int32), cs.view(torch.int32))
    assert torch.equal(sf.view(torch.int32), ss.view(torch.int32))
    words, plan = _case(4, 2048, 43)
    x, plans = torch.from_numpy(words), nco.plan_tensor(plan)
    a = probes.mix_shape_run(x, plans, P=P, Q=Q, tone="fold")
    b = probes.mix_shape_run(x, plans, P=P, Q=Q, tone="select")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_chain_tile_follows_the_chain_kernel():
    assert probes.chain_tile(1 << 25, 3, 64) == 2048      # the bench shape
    assert probes.chain_tile(2688 * 5, 3, 64) == 2688     # 42 · 64 ≤ 128 · 64 / 3
    assert probes.chain_tile(1 << 19, 1, 8) == 1024       # 128 outputs ÷ 8
    with pytest.raises(ValueError, match="divides"):
        probes.chain_tile(100, 3, 64)


def test_chain_shaped_probes_reject_bad_arguments():
    words, plan = _case(2, 1024, 1, switch=False)
    x, plans = torch.from_numpy(words), nco.plan_tensor(plan)
    with pytest.raises(ValueError, match="tile"):
        probes.chain_shape_run(x, plans, P=P, Q=Q, do_mix=True, tile=100)
    with pytest.raises(ValueError, match="tile"):
        probes.chain_shape_run(x, plans, P=P, Q=Q, do_mix=True, tile=1280)
    with pytest.raises(ValueError, match="tone"):
        probes.mix_shape_run(x, plans, P=P, Q=Q, tone="outer")
    with pytest.raises(ValueError, match="plans"):
        probes.mix_shape_run(x, plans[:, :1], P=P, Q=Q, tone="fold")
