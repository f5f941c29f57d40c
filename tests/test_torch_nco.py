"""The port's NCO (phase words, tone, per-block mixer) against the JAX package.

- q24 phase words are integers: bitwise against
  ``doppler_tpu.ops.pallas.mixer.phase_q24``, including block lengths past
  2^16 samples (the JAX kernel's ``small_j`` hazard).
- The tone is float32 arithmetic that XLA may contract differently
  (``doppler_tpu/ops/sincos.py:37-55``): within 1 ulp over all 2^24 words.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops import nco as j_nco
from doppler_tpu.ops.pallas.mixer import phase_q24 as j_phase_q24
from doppler_tpu.ops.sincos import sincos_q24_neg as j_sincos
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.sincos import sincos_q24_neg

torch.set_num_threads(1)   # leave the other test workers their cores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _random_plans(rng, B, L):
    """Random 64-bit D/C1/C2 words and segment switches t ∈ [0, L]."""
    f = rng.integers(0, 1 << 32, size=(7, B), dtype=np.uint64).astype(np.uint32)
    f[6] = rng.integers(0, L + 1, size=B).astype(np.uint32)
    f[6, 0], f[6, 1] = 0, L           # all-C2 and all-C1 blocks
    return f


@pytest.mark.parametrize("L", [2048, 65536 + 4096])
def test_phase_q24_bitwise(L):
    rng = np.random.default_rng(L)
    B = 6
    fields = _random_plans(rng, B, L)
    got = nco.phase_q24(nco.plan_tensor(list(fields)), L).numpy()
    j = jnp.arange(L, dtype=jnp.uint32)[None, :]
    want = np.asarray(j_phase_q24(
        j, *(jnp.asarray(fields[k])[:, None] for k in range(7)),
        small_j=(L <= 65536)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < (1 << 24)


def test_sincos_all_phase_words_within_one_ulp():
    q24 = np.arange(1 << 24, dtype=np.int32)
    c, s = sincos_q24_neg(torch.from_numpy(q24))
    jc, js = j_sincos(jnp.asarray(q24))
    for a, b in ((c.numpy(), np.asarray(jc)), (s.numpy(), np.asarray(js))):
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        assert np.all(np.abs(a - b) <= ulp)


def test_mix_blocks_vs_jax_nco():
    """The rotation of planned blocks: float32 outputs within 2^-20 (a few
    ulp of the tone polynomial, whose contraction XLA chooses)."""
    rng = np.random.default_rng(3)
    B, L = 4, 2048
    fields = _random_plans(rng, B, L)
    i = (rng.standard_normal((B, L)) * 0.4).astype(np.float32)
    q = (rng.standard_normal((B, L)) * 0.4).astype(np.float32)
    ti, tq = nco.mix_blocks(torch.from_numpy(i), torch.from_numpy(q),
                            nco.plan_tensor(list(fields)))
    ji, jq = j_nco.mix_blocks(jnp.asarray(i), jnp.asarray(q), *fields)
    assert np.abs(ti.numpy() - np.asarray(ji)).max() <= 2.0 ** -20
    assert np.abs(tq.numpy() - np.asarray(jq)).max() <= 2.0 ** -20


def test_plan_tensor_pads_partial_chunk():
    fields = [np.arange(3, dtype=np.uint32) + k for k in range(7)]
    t = nco.plan_tensor(fields, 5)
    assert t.dtype == torch.int32 and tuple(t.shape) == (7, 5)
    assert np.array_equal(t.numpy().view(np.uint32)[:, :3], np.stack(fields))
    assert not t[:, 3:].any()
