"""The mixer module: the port's plain version against the JAX Pallas mixer
(interpret mode).  The CUDA kernel against the plain version is in
``test_torch_cuda.py``.

Tolerances: the JAX kernel's XLA lowering may contract a product of the tone
polynomial or the rotation into an FMA (``doppler_tpu/ops/sincos.py:37-55``),
so float32 outputs agree within 2^-20 (a few ulp) and encoded i16 outputs
within 1 LSB in under 1% of samples.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops.pallas.mixer import mix_blocks_pallas_fmt
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

torch.set_num_threads(1)   # leave the other test workers their cores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FORMATS = [("i16", "i16"), ("i16", "f32"), ("f32", "i16"), ("f32", "f32")]


def _case(B, L, intype, seed):
    rng = np.random.default_rng(seed)
    # shifts with rounding resets give blocks with segment switches t < L
    plan = plan_blocks([327843.76] * (B // 2) + [-15000.0] * (B - B // 2),
                       [L] * B, 1024000, NCOState(samplenum=40000), L)
    if intype == "i16":
        data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                            dtype=np.int64).astype(np.int32)
    else:
        data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
    return data, plan


def _i16_diff(a, b):
    a = np.asarray(a).view(np.int16).astype(np.int32)
    b = np.asarray(b).view(np.int16).astype(np.int32)
    return np.abs(a - b)


@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_plain_matches_jax_pallas_mixer(intype, outtype):
    B, L = 4, 2048
    data, plan = _case(B, L, intype, 11)
    assert (plan.t < L).any()
    launches = mix_blocks_fmt.launches
    got = mix_blocks_fmt(torch.from_numpy(data), nco.plan_tensor(plan),
                         intype=intype, outtype=outtype).numpy()
    assert mix_blocks_fmt.launches == launches    # CPU tensor: no kernel
    want = np.asarray(mix_blocks_pallas_fmt(
        jnp.asarray(data), *(getattr(plan, f) for f in nco.PLAN_FIELDS),
        intype=intype, outtype=outtype, interpret=True))
    assert got.shape == want.shape
    if outtype == "i16":
        d = _i16_diff(got, want)
        assert d.max() <= 1 and np.mean(d > 0) < 0.01
    else:
        assert np.abs(got - want).max() <= 2.0 ** -20


def test_f32_in_i16_out_nan_encodes_to_zero():
    data, plan = _case(2, 256, "f32", 5)
    data[0, 1, 7] = np.nan
    out = mix_blocks_fmt(torch.from_numpy(data), nco.plan_tensor(plan),
                         intype="f32", outtype="i16").numpy()
    assert out[1, 7] == 0          # NaN spreads to I and Q, each encodes to 0


def test_rejects_bad_layouts():
    data, plan = _case(2, 256, "i16", 1)
    p = nco.plan_tensor(plan)
    with pytest.raises(ValueError, match="format"):
        mix_blocks_fmt(torch.from_numpy(data), p, intype="i8")
    with pytest.raises(ValueError, match="f32 input"):
        mix_blocks_fmt(torch.from_numpy(data), p, intype="f32")
    with pytest.raises(ValueError, match="plans"):
        mix_blocks_fmt(torch.from_numpy(data), p[:, :1])
