"""The hand-written CUDA kernels against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file imports
neither jax nor ``doppler_tpu``, so on a machine with a card but no jax it
runs without the JAX harness's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels round every mixer step as the plain version's
separate torch operations do, so mixer outputs are bitwise equal; the chain
kernel sums its FIR as a sequential FMA chain where the plain version sums a
fixed tree, so its encoded outputs agree within 1 LSB in under 1% of
samples and its float32 outputs within 2^-20, while its carry (mixed
samples) is bitwise the mixer's.
"""

import io

import numpy as np
import pytest
import torch

from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.chain import (
    mix_resample_chain_plain,
    mix_resample_chain_stream,
)
from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt, mix_blocks_fmt_plain
from doppler_tpu_torch.ops.filters import design_polyphase_bank
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FORMATS = [("i16", "i16"), ("i16", "f32"), ("f32", "i16"), ("f32", "f32")]
FS = 1024000
P, Q = 3, 64
BANK = design_polyphase_bank(P, Q)
T = BANK.shape[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _chunk(B, L, intype, rng, state):
    plan = plan_blocks([327843.76] * (B // 2) + [-15000.0] * (B - B // 2),
                       [L] * B, FS, state, L)
    if intype == "i16":
        data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                            dtype=np.int64).astype(np.int32)
    else:
        data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
    return data, plan


def _lsb(a, b):
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_mixer_kernel_bitwise_vs_plain(card, intype, outtype):
    L = 2048 if intype == "i16" else 1024
    data, plan = _chunk(64, L, intype, np.random.default_rng(1),
                        NCOState(samplenum=40000))
    assert (plan.t < L).any()
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    launches = mix_blocks_fmt.launches
    got = mix_blocks_fmt(x, p, intype=intype, outtype=outtype)
    torch.cuda.synchronize()
    assert mix_blocks_fmt.launches == launches + 1
    assert torch.equal(got, mix_blocks_fmt_plain(x, p, intype=intype,
                                                 outtype=outtype))


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_chain_kernel_vs_plain(card, intype, outtype):
    rng, state = np.random.default_rng(2), NCOState()
    bank = torch.from_numpy(BANK).to(card)
    c_k = c_p = torch.zeros(2, T - 1, device=card)
    for _ in range(2):                 # the second chunk starts from a carry
        data, plan = _chunk(32, 2048, intype, rng, state)
        x = torch.from_numpy(data).to(card)
        p = nco.plan_tensor(plan, device=card)
        got, c_k = mix_resample_chain_stream(x, p, bank, c_k, P=P, Q=Q, T=T,
                                             intype=intype, outtype=outtype)
        want, c_p = mix_resample_chain_plain(x, p, bank, c_p, P=P, Q=Q, T=T,
                                             intype=intype, outtype=outtype)
        mixed = mix_blocks_fmt(x, p, intype=intype, outtype="f32").reshape(2, -1)
        torch.cuda.synchronize()
        if outtype == "i16":
            d = _lsb(got, want)
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
        else:
            assert float((got - want).abs().max()) <= 2.0 ** -20
        assert torch.equal(c_k, mixed[:, -(T - 1):])
        assert torch.equal(c_k, c_p)


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(card):
    """The slice on the card against the same slice on the CPU: mix-only is
    bitwise; with the resampler the chain's FMA sum order allows 1 LSB."""
    rng = np.random.default_rng(3)
    data = rng.integers(-9000, 9000, size=2 * (2048 * 40 + 700),
                        dtype=np.int16).tobytes()

    def run(device, resample):
        pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                        chunk_blocks=16, device=device)
        if resample:
            attach_resampler(pipe, 48000)
        out = io.BytesIO()
        pipe.run(io.BytesIO(data), out)
        return out.getvalue(), pipe

    gpu, pipe = run("cuda", False)
    assert gpu == run("cpu", False)[0] and pipe.device_s > 0
    gpu, _ = run("cuda", True)
    cpu, _ = run("cpu", True)
    assert len(gpu) == len(cpu)
    d = _lsb(torch.frombuffer(bytearray(gpu), dtype=torch.int32),
             torch.frombuffer(bytearray(cpu), dtype=torch.int32))
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
