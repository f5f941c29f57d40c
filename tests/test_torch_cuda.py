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
samples) is bitwise the mixer's.  The cascade kernel likewise: ≤ 1 LSB in
under 1%, float32 outputs within 2^-20, its stage-0 carry bitwise and the
later carries (FIR outputs) within 2^-20; kernel against kernel, its bytes
do not depend on the chunk split.  The channel-batched launches hold the
same tolerances against their plain versions, and kernel against kernel
channel c is bitwise the one-channel launch with that channel's plan words
and carry, whatever the chunk split.  The Q15 mixer and the roofline probes are integer
or share the mixer's separately rounded steps, so they are bitwise equal to
their plain versions, the chain-shaped probes' XOR side output included.

The kernels of the bf16 dots (``csrc/chain_fast.cu``, ``csrc/cascade_fast.cu``,
``dot_precision`` ``split3`` and ``default``) are held to their plain
versions within a tolerance, bitwise only against themselves and in the
carries that are mixed samples (tolerances above their tests).

The chain and cascade kernels are also held to the SHA-256 digests of
``tools/kernel_digests.py``, taken on the kernels they replaced: their bytes
may depend on nothing but their inputs, so every tile, thread count and
register tile gives the same bytes, and a redesign gives the old ones.
"""

import io

import numpy as np
import pytest
import torch

from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.cascade import (
    mix_cascade_channels,
    mix_cascade_channels_plain,
    mix_cascade_plain,
    mix_cascade_stream,
    split_point,
)
from doppler_tpu_torch.ops.cuda.chain import (
    mix_resample_chain_channels,
    mix_resample_chain_channels_plain,
    mix_resample_chain_plain,
    mix_resample_chain_stream,
)
from doppler_tpu_torch.ops.cuda.mixer import (
    mix_blocks_fmt,
    mix_blocks_fmt_channels,
    mix_blocks_fmt_channels_plain,
    mix_blocks_fmt_plain,
    mix_blocks_q15,
    mix_blocks_q15_plain,
)
from doppler_tpu_torch.ops.cuda import cascade as cascade_mod
from doppler_tpu_torch.ops.cuda import chain as chain_mod
from doppler_tpu_torch.ops.cuda import geometry, probes
from doppler_tpu_torch.ops.filters import design_polyphase_bank
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline
from doppler_tpu_torch.tools import kernel_digests

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


def _cascade_args(ms, card, k=None):
    fused = ms.stages[:k]
    return (tuple((st.P, st.Q, st.T) for st in fused),
            tuple(torch.from_numpy(st.bank).to(card) for st in fused))


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_cascade_kernel_vs_plain(card, intype, outtype):
    """Config-3 stages (÷8 T = 65, 3/8 T = 51); the second chunk starts
    from the carries of the first."""
    stages, banks = _cascade_args(MultiStageResampler(FS, 48000), card)
    rng, state = np.random.default_rng(4), NCOState()
    c_k = c_p = tuple(torch.zeros(2, T - 1, device=card) for _, _, T in stages)
    for _ in range(2):
        data, plan = _chunk(32, 2048, intype, rng, state)
        x = torch.from_numpy(data).to(card)
        p = nco.plan_tensor(plan, device=card)
        launches = mix_cascade_stream.launches
        got, c_k = mix_cascade_stream(x, p, banks, c_k, stages=stages,
                                      intype=intype, outtype=outtype)
        want, c_p = mix_cascade_plain(x, p, banks, c_p, stages=stages,
                                      intype=intype, outtype=outtype)
        mixed = mix_blocks_fmt(x, p, intype=intype, outtype="f32").reshape(2, -1)
        torch.cuda.synchronize()
        assert mix_cascade_stream.launches == launches + 1
        if outtype == "i16":
            d = _lsb(got, want)
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
        else:
            assert float((got - want).abs().max()) <= 2.0 ** -20
        assert torch.equal(c_k[0], mixed[:, -(stages[0][2] - 1):])
        assert torch.equal(c_k[0], c_p[0])
        assert float((c_k[1] - c_p[1]).abs().max()) <= 2.0 ** -20
        c_p = c_k                      # both continue from the kernel's state


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [FS, 100_000_000])
def test_cascade_kernel_invariant_to_chunk_split(card, fs):
    """Kernel against kernel: 64 blocks in one chunk against 4 × 16, with
    the split front (float32 planes) at 100 Msps."""
    ms = MultiStageResampler(fs, 48000)
    k = split_point(ms.stages)
    stages, banks = _cascade_args(ms, card, k)
    dense = k < len(ms.stages)
    outtype = "f32" if dense else "i16"
    data, plan = _chunk(64, 2048, "i16", np.random.default_rng(5), NCOState())
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    zero = tuple(torch.zeros(2, T - 1, device=card) for _, _, T in stages)
    whole, c_whole = mix_cascade_stream(x, p, banks, zero, stages=stages,
                                        outtype=outtype, final_dense=dense)
    c, parts = zero, []
    for b in range(0, 64, 16):
        o, c = mix_cascade_stream(x[b:b + 16].contiguous(),
                                  p[:, b:b + 16].contiguous(), banks, c,
                                  stages=stages, outtype=outtype,
                                  final_dense=dense)
        parts.append(o)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=-2), whole)
    assert all(torch.equal(a, b) for a, b in zip(c, c_whole))
    want, _ = mix_cascade_plain(x, p, banks, zero, stages=stages,
                                outtype=outtype, final_dense=dense)
    if dense:
        assert float((whole - want).abs().max()) <= 2.0 ** -20
    else:
        d = _lsb(whole, want)
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [FS, 250000])
def test_default_route_pipeline_on_card_matches_cpu(card, fs):
    """The cascade route ('auto') on the card against the same pipeline on
    the CPU: ≤ 1 LSB in under 1%, every full chunk through the kernel."""
    rng = np.random.default_rng(6)
    n = 2048 * 40 + 700
    data = rng.integers(-9000, 9000, size=2 * n, dtype=np.int16).tobytes()

    def run(device):
        pipe = Pipeline(fs, "i16", "i16", ConstScheduler(-15000.0),
                        chunk_blocks=16, device=device)
        attach_resampler(pipe, 48000, stages="auto")
        out = io.BytesIO()
        pipe.run(io.BytesIO(data), out)
        return out.getvalue()

    launches = mix_cascade_stream.launches
    gpu = run("cuda")
    assert mix_cascade_stream.launches == launches + n // (16 * 2048)
    cpu = run("cpu")
    assert len(gpu) == len(cpu)
    d = _lsb(torch.frombuffer(bytearray(gpu), dtype=torch.int32),
             torch.frombuffer(bytearray(cpu), dtype=torch.int32))
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01


# -- the channel axis -------------------------------------------------------

C = 5


def _channel_chunk(B, L, intype, rng, states):
    """One shared chunk with C plans: each channel its own shifts and its
    own samplenum state."""
    data, _ = _chunk(B, L, intype, rng, NCOState())
    plans = torch.stack([
        nco.plan_tensor(plan_blocks(
            [327843.76 - 9000.0 * c] * (B // 2) + [-15000.0 + 777.0 * c] * (B - B // 2),
            [L] * B, FS, states[c], L))
        for c in range(C)], dim=1)
    return data, plans


def _assert_close(got, want, outtype):
    if outtype == "i16":
        d = _lsb(got, want)
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    else:
        assert float((got - want).abs().max()) <= 2.0 ** -20


def _channel(out, c, outtype):
    return out[c] if outtype == "i16" else out[:, c]


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_channel_mixer_kernel_bitwise(card, intype, outtype):
    L = 2048 if intype == "i16" else 1024
    rng = np.random.default_rng(11)
    states = [NCOState(samplenum=40000 + c) for c in range(C)]
    data, plans = _channel_chunk(48, L, intype, rng, states)
    x, p = torch.from_numpy(data).to(card), plans.to(card)
    launches = mix_blocks_fmt_channels.launches
    got = mix_blocks_fmt_channels(x, p, intype=intype, outtype=outtype)
    torch.cuda.synchronize()
    assert mix_blocks_fmt_channels.launches == launches + 1
    assert torch.equal(got, mix_blocks_fmt_channels_plain(
        x, p, intype=intype, outtype=outtype))
    for c in range(C):
        one = mix_blocks_fmt(x, p[:, c].contiguous(), intype=intype,
                             outtype=outtype)
        assert torch.equal(_channel(got, c, outtype), one)


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_channel_chain_kernel(card, intype, outtype):
    """Against plain (≤ 1 LSB / 2^-20, carries bitwise); channel c bitwise
    the one-channel launch; the second chunk starts from nonzero carries."""
    rng = np.random.default_rng(12)
    states = [NCOState() for _ in range(C)]
    bank = torch.from_numpy(BANK).to(card)
    carries = torch.zeros(C, 2, T - 1, device=card)
    kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
    for _ in range(2):
        data, plans = _channel_chunk(32, 2048, intype, rng, states)
        x, p = torch.from_numpy(data).to(card), plans.to(card)
        launches = mix_resample_chain_channels.launches
        got, c_got = mix_resample_chain_channels(x, p, bank, carries, **kw)
        torch.cuda.synchronize()
        assert mix_resample_chain_channels.launches == launches + 1
        want, c_want = mix_resample_chain_channels_plain(x, p, bank, carries, **kw)
        _assert_close(got, want, outtype)
        assert torch.equal(c_got, c_want)
        for c in range(C):
            one, c_one = mix_resample_chain_stream(
                x, p[:, c].contiguous(), bank, carries[c].contiguous(), **kw)
            assert torch.equal(_channel(got, c, outtype), one)
            assert torch.equal(c_got[c], c_one)
        carries = c_got


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [FS, 100_000_000])
@pytest.mark.parametrize("intype", ["i16", "f32"])
def test_channel_cascade_kernel(card, fs, intype):
    """Config-3 stages fully fused (i16 out) and the 100 Msps split front
    (float32 planes): against plain, channel c bitwise the one-channel
    launch, and 32 blocks against 2 × 16."""
    ms = MultiStageResampler(fs, 48000)
    k = split_point(ms.stages)
    stages, banks = _cascade_args(ms, card, k)
    dense = k < len(ms.stages)
    outtype = "f32" if dense else "i16"
    kw = dict(stages=stages, intype=intype, outtype=outtype, final_dense=dense)
    rng = np.random.default_rng(13)
    states = [NCOState() for _ in range(C)]
    carries = tuple(torch.zeros(C, 2, Ts - 1, device=card) for _, _, Ts in stages)
    for _ in range(2):
        data, plans = _channel_chunk(32, 2048, intype, rng, states)
        x, p = torch.from_numpy(data).to(card), plans.to(card)
        launches = mix_cascade_channels.launches
        got, c_got = mix_cascade_channels(x, p, banks, carries, **kw)
        torch.cuda.synchronize()
        assert mix_cascade_channels.launches == launches + 1
        want, c_want = mix_cascade_channels_plain(x, p, banks, carries, **kw)
        _assert_close(got, want, outtype)
        assert torch.equal(c_got[0], c_want[0])
        for a, b in zip(c_got[1:], c_want[1:]):
            assert float((a - b).abs().max()) <= 2.0 ** -20
        for c in range(C):
            one, c_one = mix_cascade_stream(
                x, p[:, c].contiguous(), banks,
                [cr[c].contiguous() for cr in carries], **kw)
            assert torch.equal(_channel(got, c, outtype), one)
            assert all(torch.equal(a[c], b) for a, b in zip(c_got, c_one))
        # the chunk split: 32 blocks against 2 × 16
        cs, parts = carries, []
        for b in (0, 16):
            xb = x[b:b + 16] if intype == "i16" else x[:, b:b + 16]
            o, cs = mix_cascade_channels(xb.contiguous(),
                                         p[:, :, b:b + 16].contiguous(),
                                         banks, cs, **kw)
            parts.append(o)
        assert torch.equal(torch.cat(parts, dim=-2), got)
        assert all(torch.equal(a, b) for a, b in zip(cs, c_got))
        carries = c_got


@pytest.mark.cuda
@pytest.mark.parametrize("fs,stages,rates", [
    (FS, "single", (48000, 48000, 48000)),
    (FS, "auto", (48000, 48000, 48000)),
    (250000, "auto", (48000, 48000, 48000)),
    (FS, "auto", (48000, None, 128000)),
    (FS, "auto", (None, None, None)),
])
def test_channels_pipeline_on_card_matches_cpu(card, fs, stages, rates):
    """MultiChannelPipeline on the card against the CPU: mix-only bitwise,
    ≤ 1 LSB in under 1% with a resampler; every full chunk of a
    uniform-rate run goes through the channel-batched kernel."""
    rng = np.random.default_rng(14)
    n = 2048 * 40 + 700
    data = rng.integers(-9000, 9000, size=2 * n, dtype=np.int16).tobytes()

    def run(device):
        specs = [ChannelSpec(f"c{k}", ConstScheduler(s), center_offset_hz=c,
                             out_rate=r)
                 for k, (s, c, r) in enumerate(zip(
                     (-15000.0, 0.0, 90000.5), (500.0, 0.0, -250.0), rates))]
        mp = MultiChannelPipeline(fs, "i16", "i16", specs, chunk_blocks=16,
                                  resample_stages=stages, drain_on_eof=True,
                                  device=device)
        outs = [io.BytesIO() for _ in specs]
        mp.run(io.BytesIO(data), outs)
        return [o.getvalue() for o in outs], mp

    before = {f: f.launches for f in (mix_blocks_fmt_channels,
                                      mix_resample_chain_channels,
                                      mix_cascade_channels)}
    gpu, mp = run("cuda")
    full = n // (16 * 2048)
    uniform = len(set(rates)) == 1 and rates[0] is not None
    fused = {"single": mix_resample_chain_channels,
             "auto": mix_cascade_channels}[stages]
    assert fused.launches - before[fused] == (full if uniform else 0)
    assert (mix_blocks_fmt_channels.launches - before[mix_blocks_fmt_channels]
            == (1 if uniform else full + 1))
    assert mp.device_s > 0
    cpu, _ = run("cpu")
    for g, w, r in zip(gpu, cpu, rates):
        assert len(g) == len(w) > 0
        if r is None:
            assert g == w
        else:
            d = _lsb(torch.frombuffer(bytearray(g), dtype=torch.int32),
                     torch.frombuffer(bytearray(w), dtype=torch.int32))
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01


# -- the Q15 mixer and the roofline probes ------------------------------------

def _probe_case(card, B=64, L=2048, seed=40):
    data, plan = _chunk(B, L, "i16", np.random.default_rng(seed),
                        NCOState(samplenum=40000))
    assert (plan.t < L).any()
    return torch.from_numpy(data).to(card), nco.plan_tensor(plan, device=card)


@pytest.mark.cuda
def test_q15_kernel_bitwise_vs_plain(card):
    x, p = _probe_case(card)
    launches = mix_blocks_q15.launches
    got = mix_blocks_q15(x, p)
    torch.cuda.synchronize()
    assert mix_blocks_q15.launches == launches + 1
    assert torch.equal(got, mix_blocks_q15_plain(x, p))
    # a 15-bit tone: within 2 LSB of the float32 mixer (1 from the tone's
    # quantisation through each product, 1 from the truncation)
    pairs = np.random.default_rng(41).integers(-9000, 9000, size=(64, 2048, 2),
                                               dtype=np.int16)
    x = torch.from_numpy(pairs.view(np.int32).reshape(64, 2048)).to(card)
    assert int(_lsb(mix_blocks_q15(x, p), mix_blocks_fmt(x, p)).max()) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["copy", "codec"])
@pytest.mark.parametrize("vec", [1, 4])
def test_elementwise_probe_bitwise_vs_plain(card, body, vec):
    x, _ = _probe_case(card)
    launches = probes.probe_elementwise.launches
    got = probes.probe_elementwise(x, body=body, vec=vec)
    torch.cuda.synchronize()
    assert probes.probe_elementwise.launches == launches + 1
    assert torch.equal(got, probes.probe_elementwise_plain(x, body=body))
    # ragged lengths, none a multiple of a CTA's 1024 words (256 threads × 16
    # bytes): the last CTA's tail at a few CTAs and at some 8000
    big = torch.randint(-(1 << 31), 1 << 31, (1024 * 8191 + 4 * 37,),
                        dtype=torch.int64, device=card).to(torch.int32)
    for words in (x.reshape(-1)[:2048 * 3 + 4 * 37], big):
        want = probes.probe_elementwise_plain(words, body=body)
        assert torch.equal(probes.probe_elementwise(words, body=body, vec=vec), want)
        # into a buffer the caller owns
        out = torch.full_like(words, 7)
        assert probes.probe_elementwise(words, body=body, vec=vec, out=out) is out
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, 512, 2688])
def test_chain_shaped_probes_bitwise_vs_plain(card, tile):
    """Copy, mix, and both tones: the kept words and the XOR of the rest.
    A tile of 2688 samples straddles the 2048-sample blocks."""
    x, p = _probe_case(card, B=63 if tile == 2688 else 64)
    kw = dict(P=P, Q=Q, tile=tile)
    launches = probes.chain_shape_run.launches, probes.mix_shape_run.launches
    copy = probes.chain_shape_run(x, p, do_mix=False, **kw)
    mix = probes.chain_shape_run(x, p, do_mix=True, **kw)
    fold = probes.mix_shape_run(x, p, tone="fold", **kw)
    select = probes.mix_shape_run(x, p, tone="select", **kw)
    torch.cuda.synchronize()
    assert probes.chain_shape_run.launches == launches[0] + 2
    assert probes.mix_shape_run.launches == launches[1] + 2
    for got, want in (
            (copy, probes.chain_shape_run_plain(x, p, do_mix=False, **kw)),
            (mix, probes.chain_shape_run_plain(x, p, do_mix=True, **kw)),
            (fold, probes.mix_shape_run_plain(x, p, tone="fold", **kw)),
            (select, probes.mix_shape_run_plain(x, p, tone="select", **kw))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(fold[0], select[0]) and torch.equal(fold[1], select[1])
    # the mix probe's words are the mixer kernel's, sliced the same way
    t = tile or probes.chain_tile(x.numel(), P, Q)
    assert torch.equal(mix[0], mix_blocks_fmt(x, p).reshape(-1, t)[:, :t * P // Q])


@pytest.mark.cuda
def test_chain_shaped_probes_do_the_unstored_work(card):
    """One input word outside the kept part of a tile changes that tile's
    side word, in the copy and in the mix, exactly as the plain version says:
    the kernel loaded and mixed a sample whose word it does not store."""
    x, p = _probe_case(card)
    t = probes.chain_tile(x.numel(), P, Q)
    y = x.clone()
    y.view(-1)[5 * t + t - 1] ^= 0x00010001       # the last sample of tile 5
    for do_mix in (False, True):
        a = probes.chain_shape_run(x, p, P=P, Q=Q, do_mix=do_mix)
        b = probes.chain_shape_run(y, p, P=P, Q=Q, do_mix=do_mix)
        want = probes.chain_shape_run_plain(y, p, P=P, Q=Q, do_mix=do_mix)
        assert torch.equal(a[0], b[0])
        changed = (a[1] != b[1]).nonzero().flatten().tolist()
        assert changed == [5]
        assert torch.equal(b[1], want[1])


@pytest.mark.cuda
def test_tools_run_on_the_card_through_the_kernels(card, capsys):
    import json

    from doppler_tpu_torch.tools import probe_chain_precision, roofline

    fns = (mix_blocks_q15, probes.probe_elementwise, probes.chain_shape_run,
           probes.mix_shape_run, mix_blocks_fmt, mix_resample_chain_stream,
           mix_cascade_stream)
    before = [f.launches for f in fns]
    fast_before = mix_resample_chain_stream.launches_fast
    small = ["--samples", str(1 << 20), "--dispatches", "4", "--iters", "2"]
    names = roofline.MIXER_SHAPED + roofline.CHAIN_SHAPED
    assert roofline.main(small + ["--variants", ",".join(names)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == list(names)
    assert probe_chain_precision.main(small) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == list(probe_chain_precision.VARIANTS)
    assert all(f.launches > n for f, n in zip(fns, before))
    assert mix_resample_chain_stream.launches_fast > fast_before


# -- the bytes of the chain and cascade kernels -------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["i16", "f32"])
@pytest.mark.parametrize("B", kernel_digests.BLOCKS)
def test_kernel_bytes_equal_the_pinned_digests(card, B, fmt):
    """Chain, config-3 cascade and 100 Msps front, one stream and 16
    channels, from non-zero carries: every output and every carry has the
    SHA-256 of the kernels before their redesign."""
    got = kernel_digests.compute(blocks=(B,), fmts=(fmt,))
    assert len(got) == 6
    assert kernel_digests.mismatches(got) == []


def _digest_case(kernel, card, B, fmt, C=3):
    stages, banks = kernel_digests.geometry(kernel)
    data, plans = kernel_digests.seeded_inputs(B, fmt, C)
    carries = kernel_digests.seeded_carries(stages, C)
    t = lambda a: torch.from_numpy(a).to(card)             # noqa: E731
    return stages, [t(b) for b in banks], t(data), t(plans), [t(c) for c in carries]


CHAIN_GEOMS = [(128, 128, 1), (192, 128, 2), (384, 512, 1), (512, 256, 2), (33, 32, 1)]
CASCADE_GEOMS = {
    "cascade": [(128, 128, (1, 1)), (256, 256, (2, 1)), (512, 512, (2, 2)),
                (96, 64, (1, 2))],
    "front": [(16, 128, (1, 1)), (32, 512, (2, 1)), (32, 256, (2, 2)),
              (8, 64, (1, 2))],
}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["i16", "f32"])
def test_chain_bytes_do_not_depend_on_the_launch_geometry(card, fmt):
    """Tiles, thread counts and register tiles through ``_launch``'s
    ``geom``: the picked geometry's bytes, output and carry."""
    C, B, L = 3, 48, kernel_digests.L
    ((P, Q, T),), (bank,), data, plans, (carry,) = _digest_case("chain", card, B, fmt)
    args = (data, plans, bank, carry, C, B, L, P, Q, T, fmt, fmt)
    want = chain_mod._launch(*args)
    for geom in CHAIN_GEOMS:
        got = chain_mod._launch(*args, geom=geom)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), geom


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["i16", "f32"])
@pytest.mark.parametrize("kernel", list(CASCADE_GEOMS))
def test_cascade_bytes_do_not_depend_on_the_launch_geometry(card, kernel, fmt):
    C, B, L = 3, 48, kernel_digests.L
    stages, banks, data, plans, carries = _digest_case(kernel, card, B, fmt)
    n_out = cascade_mod.chunk_out_count(stages, B, L)
    outtype = "f32" if kernel == "front" else fmt
    args = (data, plans, banks, carries, C, B, L, stages, n_out, fmt, outtype)
    want = cascade_mod._launch(*args)
    for geom in CASCADE_GEOMS[kernel]:
        got = cascade_mod._launch(*args, geom=geom)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), geom
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), geom


@pytest.mark.cuda
@pytest.mark.parametrize("L", [96, 98, 1000])
def test_walker_bitwise_at_block_lengths_that_are_no_power_of_two(card, L):
    """The chain-shaped mix probe runs the kernels' mix front (the strided
    walker: 16-byte loads where 4 | L, one sample a step at L = 98) over
    blocks that a thread's stride crosses several at a time, with the
    segment switch inside some blocks: the mixer kernel's words."""
    B = 64
    data, plan = _chunk(B, L, "i16", np.random.default_rng(50 + L),
                        NCOState(samplenum=40000))
    assert (plan.t < L).any() and (plan.t > 0).any()
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    tile = probes.chain_tile(B * L, 1, 4)
    got = probes.chain_shape_run(x, p, P=1, Q=4, do_mix=True)
    want = probes.chain_shape_run_plain(x, p, P=1, Q=4, do_mix=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], mix_blocks_fmt(x, p).reshape(-1, tile)[:, :tile // 4])


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", [("i16", "i16"), ("f32", "f32")])
def test_chain_and_cascade_at_a_block_length_that_is_no_power_of_two(
        card, intype, outtype):
    """L = 960: against plain (≤ 1 LSB / 2^-20), the stage-0 carries bitwise
    the mixer kernel's last samples, 32 blocks against 4 × 8."""
    B, L = 32, 960
    rng, state = np.random.default_rng(60), NCOState(samplenum=40000)
    data, plan = _chunk(B, L, intype, rng, state)
    assert (plan.t < L).any()
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    mixed = mix_blocks_fmt(x, p, intype=intype, outtype="f32").reshape(2, -1)
    blocks = (lambda b: x[b:b + 8]) if intype == "i16" else (lambda b: x[:, b:b + 8])
    kw = dict(intype=intype, outtype=outtype)

    bank = torch.from_numpy(BANK).to(card)
    carry = torch.from_numpy(
        kernel_digests.seeded_carries(((P, Q, T),), 1)[0][0]).to(card)
    got, c_got = mix_resample_chain_stream(x, p, bank, carry, P=P, Q=Q, T=T, **kw)
    want, c_want = mix_resample_chain_plain(x, p, bank, carry, P=P, Q=Q, T=T, **kw)
    _assert_close(got, want, outtype)
    assert torch.equal(c_got, mixed[:, -(T - 1):]) and torch.equal(c_got, c_want)
    c, parts = carry, []
    for b in range(0, B, 8):
        o, c = mix_resample_chain_stream(blocks(b).contiguous(),
                                         p[:, b:b + 8].contiguous(), bank, c,
                                         P=P, Q=Q, T=T, **kw)
        parts.append(o)
    assert torch.equal(torch.cat(parts, dim=-2), got) and torch.equal(c, c_got)

    stages, banks = _cascade_args(MultiStageResampler(FS, 48000), card)
    carries = [torch.from_numpy(cr[0]).to(card)
               for cr in kernel_digests.seeded_carries(stages, 1)]
    got, c_got = mix_cascade_stream(x, p, banks, carries, stages=stages, **kw)
    want, c_want = mix_cascade_plain(x, p, banks, carries, stages=stages, **kw)
    _assert_close(got, want, outtype)
    assert torch.equal(c_got[0], mixed[:, -(stages[0][2] - 1):])
    assert float((c_got[1] - c_want[1]).abs().max()) <= 2.0 ** -20
    c, parts = carries, []
    for b in range(0, B, 8):
        o, c = mix_cascade_stream(blocks(b).contiguous(),
                                  p[:, b:b + 8].contiguous(), banks, c,
                                  stages=stages, **kw)
        parts.append(o)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=-2), got)
    assert all(torch.equal(a, b) for a, b in zip(c, c_got))


@pytest.mark.cuda
def test_chain_indices_beyond_32_bits(card):
    """A chunk of 1.43 G samples: output index × Q passes 2^32, so the CTA
    plans divide in 64 bits and the walker seeks beyond 2^31.  The last 64
    blocks' outputs are those of a launch over these blocks alone, from the
    carry the mixer kernel gives for the samples before them."""
    B, L, tail = 700_000, 2048, 64
    gen = torch.Generator(device=card).manual_seed(70)
    x = torch.randint(-(1 << 31), 1 << 31, (B, L), dtype=torch.int64,
                      device=card, generator=gen).to(torch.int32)
    p = torch.randint(-(1 << 31), 1 << 31, (7, B), dtype=torch.int64,
                      device=card, generator=gen).to(torch.int32)
    p[6] = torch.randint(0, L + 1, (B,), device=card, generator=gen).to(torch.int32)
    bank = torch.from_numpy(BANK).to(card)
    zero = torch.zeros(2, T - 1, device=card)
    whole, c_whole = mix_resample_chain_stream(x, p, bank, zero, P=P, Q=Q, T=T)
    before = mix_blocks_fmt(x[B - tail - 1:B - tail].contiguous(),
                            p[:, B - tail - 1:B - tail].contiguous(),
                            outtype="f32").reshape(2, -1)[:, -(T - 1):]
    part, c_part = mix_resample_chain_stream(
        x[B - tail:].contiguous(), p[:, B - tail:].contiguous(), bank,
        before.contiguous(), P=P, Q=Q, T=T)
    torch.cuda.synchronize()
    assert B * L * P > 1 << 32
    assert torch.equal(whole[B - tail:], part) and torch.equal(c_whole, c_part)


# -- the kernel of --precision fast (csrc/chain_fast.cu) ----------------------
#
# Tolerances: a tensor core does not add as IEEE float32 does, so the fast
# kernel is held to its plain version (the split3 function summed as a fixed
# tree) within 1 LSB in under 1% of i16 samples and 1e-5 of the largest
# float32 output, and to the exact kernel within the JAX tests' bounds of
# split3 (≤ 1 LSB and ≥ 80 dB; float32 3e-5).  Against itself it is bitwise:
# across launch geometries, chunk cuts and channels.  Its carry is the exact
# kernel's, bitwise.

# (windows, threads): windows a multiple of 16·D = 32 at 3/64, L = 2048 (D = 2)
FAST_GEOMS = [(32, 32), (64, 128), (96, 192), (128, 256), (192, 64)]


def _close_fast(got, want, outtype):
    if outtype == "i16":
        d = _lsb(got, want)
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def _snr_vs_exact(fast, exact, outtype):
    if outtype == "i16":
        g = fast.view(torch.int16).double() / 32768
        w = exact.view(torch.int16).double() / 32768
        assert float((g - w).abs().max()) <= 1 / 32768
        err = float(((g - w) ** 2).mean())
        assert 10 * np.log10(float((w ** 2).mean()) / max(err, 1e-30)) > 80.0
    else:
        assert float((fast - exact).abs().max()) < 3e-5 * float(exact.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_fast_chain_kernel_vs_plain_and_exact(card, intype, outtype):
    rng, state = np.random.default_rng(80), NCOState()
    bank = torch.from_numpy(BANK).to(card)
    kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
    carry = torch.zeros(2, T - 1, device=card)
    for _ in range(2):                 # the second chunk starts from a carry
        data, plan = _chunk(32, 2048, intype, rng, state)
        x = torch.from_numpy(data).to(card)
        p = nco.plan_tensor(plan, device=card)
        fast0, exact0 = (mix_resample_chain_stream.launches_fast,
                         mix_resample_chain_stream.launches)
        got, c_got = mix_resample_chain_stream(x, p, bank, carry,
                                               dot_precision="split3", **kw)
        torch.cuda.synchronize()
        assert mix_resample_chain_stream.launches_fast == fast0 + 1
        assert mix_resample_chain_stream.launches == exact0
        want, c_want = mix_resample_chain_plain(x, p, bank, carry,
                                                dot_precision="split3", **kw)
        exact, c_exact = mix_resample_chain_stream(x, p, bank, carry, **kw)
        torch.cuda.synchronize()
        _close_fast(got, want, outtype)
        _snr_vs_exact(got, exact, outtype)
        assert torch.equal(c_got, c_exact) and torch.equal(c_got, c_want)
        carry = c_got


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_fast_channel_chain_kernel(card, intype, outtype):
    """C = 16 against plain; carries bitwise the exact kernel's; channel c
    bitwise the one-channel launch."""
    C16 = 16
    rng = np.random.default_rng(81)
    data, _ = _chunk(32, 2048, intype, rng, NCOState())
    plans = torch.stack([
        nco.plan_tensor(plan_blocks(
            [327843.76 - 9000.0 * c] * 16 + [-15000.0 + 777.0 * c] * 16,
            [2048] * 32, FS, NCOState(samplenum=c), 2048))
        for c in range(C16)], dim=1)
    x, p = torch.from_numpy(data).to(card), plans.to(card)
    bank = torch.from_numpy(BANK).to(card)
    carries = torch.from_numpy(
        (rng.standard_normal((C16, 2, T - 1)) * 0.3).astype(np.float32)).to(card)
    kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
    fast0 = mix_resample_chain_channels.launches_fast
    got, c_got = mix_resample_chain_channels(x, p, bank, carries,
                                             dot_precision="split3", **kw)
    torch.cuda.synchronize()
    assert mix_resample_chain_channels.launches_fast == fast0 + 1
    want, c_want = mix_resample_chain_channels_plain(x, p, bank, carries,
                                                     dot_precision="split3", **kw)
    _, c_exact = mix_resample_chain_channels(x, p, bank, carries, **kw)
    torch.cuda.synchronize()
    _close_fast(got, want, outtype)
    assert torch.equal(c_got, c_exact) and torch.equal(c_got, c_want)
    for c in (0, 7, C16 - 1):
        one, c_one = mix_resample_chain_stream(
            x, p[:, c].contiguous(), bank, carries[c].contiguous(),
            dot_precision="split3", **kw)
        assert torch.equal(_channel(got, c, outtype), one)
        assert torch.equal(c_got[c], c_one)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["i16", "f32"])
def test_fast_chain_bytes_do_not_depend_on_geometry_or_chunk_cut(card, fmt):
    """Every (windows, threads) of FAST_GEOMS through ``_launch_fast``'s
    ``geom``, and 256 blocks against 4 × 64, from a non-zero carry."""
    C3, B = 3, 256
    ((P_, Q_, T_),), (bank,), data, plans, (carry,) = _digest_case(
        "chain", card, B, fmt, C=C3)
    args = (data, plans, bank, carry, C3, B, 2048, P_, Q_, T_, fmt, fmt)
    want = chain_mod._launch_fast(*args)
    for geom in FAST_GEOMS:
        got = chain_mod._launch_fast(*args, geom=geom)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), geom
    kw = dict(P=P_, Q=Q_, T=T_, intype=fmt, outtype=fmt, dot_precision="split3")
    blocks = (lambda b: data[b:b + 64]) if fmt == "i16" else (lambda b: data[:, b:b + 64])
    whole, c_whole = mix_resample_chain_stream(data, plans[:, 0].contiguous(),
                                               bank, carry[0], **kw)
    c, parts = carry[0], []
    for b in range(0, B, 64):
        o, c = mix_resample_chain_stream(blocks(b).contiguous(),
                                         plans[:, 0, b:b + 64].contiguous(),
                                         bank, c, **kw)
        parts.append(o)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=-2), whole) and torch.equal(c, c_whole)
    assert torch.equal(_channel(want[0], 0, fmt).reshape(whole.shape), whole)


@pytest.mark.cuda
def test_fast_pipeline_on_card(card):
    """``Pipeline(precision='fast')`` on the card: its full chunks launch
    the fast kernel and no exact chain kernel, ≤ 1 LSB of the CPU run; with
    the cascade, 'fast' is the exact run's bytes."""
    rng = np.random.default_rng(83)
    data = rng.integers(-9000, 9000, size=2 * (2048 * 40 + 700),
                        dtype=np.int16).tobytes()

    def run(device, precision, stages="single"):
        pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                        chunk_blocks=16, precision=precision, device=device)
        attach_resampler(pipe, 48000, stages=stages)
        out = io.BytesIO()
        pipe.run(io.BytesIO(data), out)
        return out.getvalue()

    fast0, exact0 = (mix_resample_chain_stream.launches_fast,
                     mix_resample_chain_stream.launches)
    gpu = run("cuda", "fast")
    assert mix_resample_chain_stream.launches_fast - fast0 == (2048 * 40 + 700) // (16 * 2048)
    assert mix_resample_chain_stream.launches == exact0
    cpu = run("cpu", "fast")
    assert len(gpu) == len(cpu) > 0
    d = _lsb(torch.frombuffer(bytearray(gpu), dtype=torch.int32),
             torch.frombuffer(bytearray(cpu), dtype=torch.int32))
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    assert run("cuda", "fast", "auto") == run("cuda", "exact", "auto")


@pytest.mark.cuda
def test_fast_pipeline_f32_odd_chunk_on_card(card):
    """f32 input (1024-sample blocks, so D = 1 at 3/64) at an odd
    ``chunk_blocks``: every full chunk launches the fast kernel, ≤ 1 LSB of
    the CPU run."""
    rng = np.random.default_rng(85)
    data = (rng.standard_normal(2 * (1024 * 21 + 300)) * 0.3).astype("<f4").tobytes()

    def run(device):
        pipe = Pipeline(FS, "f32", "i16", ConstScheduler(-15000.0), chunk_blocks=7,
                        precision="fast", device=device)
        attach_resampler(pipe, 48000, stages="single")
        out = io.BytesIO()
        pipe.run(io.BytesIO(data), out)
        return out.getvalue()

    fast0 = mix_resample_chain_stream.launches_fast
    gpu = run("cuda")
    assert mix_resample_chain_stream.launches_fast - fast0 == 3
    cpu = run("cpu")
    assert len(gpu) == len(cpu) > 0
    d = _lsb(torch.frombuffer(bytearray(gpu), dtype=torch.int32),
             torch.frombuffer(bytearray(cpu), dtype=torch.int32))
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_default_chain_kernels_vs_plain(card, intype, outtype):
    """``dot_precision="default"`` on kernels 2 and 4: ``csrc/chain_fast.cu``
    with one pass against its plain version, C = 1 and C = 3; counted in
    ``.launches_fast`` and ``.launches_default``; carries bitwise the exact
    kernel's."""
    rng = np.random.default_rng(84)
    data, plan = _chunk(32, 2048, intype, rng, NCOState())
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    bank = torch.from_numpy(BANK).to(card)
    carries = torch.from_numpy(
        (rng.standard_normal((3, 2, T - 1)) * 0.3).astype(np.float32)).to(card)
    kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
    counts = (mix_resample_chain_stream.launches_fast,
              mix_resample_chain_stream.launches_default)
    got, c_got = mix_resample_chain_stream(x, p, bank, carries[0],
                                           dot_precision="default", **kw)
    torch.cuda.synchronize()
    assert (mix_resample_chain_stream.launches_fast,
            mix_resample_chain_stream.launches_default) == (counts[0] + 1, counts[1] + 1)
    want, _ = mix_resample_chain_plain(x, p, bank, carries[0],
                                       dot_precision="default", **kw)
    _, c_exact = mix_resample_chain_stream(x, p, bank, carries[0], **kw)
    _close_fast(got, want, outtype)
    assert torch.equal(c_got, c_exact)
    plans = torch.stack([p] * 3, dim=1).contiguous()
    ch0 = mix_resample_chain_channels.launches_default
    got_c, _ = mix_resample_chain_channels(x, plans, bank, carries,
                                           dot_precision="default", **kw)
    torch.cuda.synchronize()
    assert mix_resample_chain_channels.launches_default == ch0 + 1
    want_c, _ = mix_resample_chain_channels_plain(x, plans, bank, carries,
                                                  dot_precision="default", **kw)
    _close_fast(got_c, want_c, outtype)
    assert torch.equal(_channel(got_c, 0, outtype), got)


# -- the cascade of the bf16 dots (csrc/cascade_fast.cu) ----------------------
#
# Tolerances.  split3 as the fast chain's: against its plain version ≤ 1 LSB
# in under 1% (float32 1e-5 of the largest output, the later carries too),
# against the exact kernel ≤ 1 LSB and ≥ 80 dB (float32 3e-5).  default
# against its plain version: ≥ 70 dB, and over 1 LSB (float32: 1e-5 of the
# largest output) in under 0.1% of samples.  Its later stages read x_s
# that the kernel and the plain version sum in other orders; where the two
# float32 values lie either side of a bf16 rounding boundary, their one
# pass takes x_h one bf16 ulp (2^-8 of x_s) apart and nothing takes the
# difference up (split3's x_l does), so a few outputs move by up to that
# times a tap.  default against the exact kernel ≥ 45 dB (it keeps 8 bits
# of each operand; 50 dB measured on the CPU).  Stage-0 carries bitwise the
# exact kernel's; bitwise against itself across geometries and chunk cuts.

# (windows, threads[, slab]): windows multiples of 16·D = 32 at config 3's
# last stage, slabs of 16·D_0 = 128 windows of its first
CASCADE_FAST_GEOMS = [(32, 64), (64, 128, 1024), (96, 256, 128)]


def _snr_db(fast, exact):
    """SNR of ``fast`` against ``exact``: i16 words, or float32 planes."""
    if fast.dtype == torch.int32:
        g, w = fast.view(torch.int16).double(), exact.view(torch.int16).double()
    else:
        g, w = fast.double(), exact.double()
    return 10 * np.log10(float((w * w).sum()) / max(float(((g - w) ** 2).sum()), 1e-30))


def _close_default(got, want, outtype):
    """The one-pass cascade against its plain version (above)."""
    if outtype == "i16":
        off = _lsb(got, want) > 1
    else:
        off = (got - want).abs() > 1e-5 * float(want.abs().max())
    assert float(off.float().mean()) < 1e-3 and _snr_db(got, want) >= 70.0


def _close_carries(got, want):
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dot", ["split3", "default"])
@pytest.mark.parametrize("intype,outtype", FORMATS)
def test_cascade_fast_kernel_vs_plain_and_exact(card, intype, outtype, dot):
    """Config-3 stages; the second chunk starts from the carries of the
    first."""
    stages, banks = _cascade_args(MultiStageResampler(FS, 48000), card)
    rng, state = np.random.default_rng(85), NCOState()
    carries = tuple(torch.zeros(2, T_ - 1, device=card) for _, _, T_ in stages)
    kw = dict(stages=stages, intype=intype, outtype=outtype)
    for _ in range(2):
        data, plan = _chunk(32, 2048, intype, rng, state)
        x = torch.from_numpy(data).to(card)
        p = nco.plan_tensor(plan, device=card)
        counts = (mix_cascade_stream.launches, mix_cascade_stream.launches_fast,
                  mix_cascade_stream.launches_default)
        got, c_got = mix_cascade_stream(x, p, banks, carries, dot_precision=dot, **kw)
        torch.cuda.synchronize()
        assert (mix_cascade_stream.launches, mix_cascade_stream.launches_fast,
                mix_cascade_stream.launches_default) == (
            counts[0], counts[1] + 1, counts[2] + (dot == "default"))
        want, c_want = mix_cascade_plain(x, p, banks, carries, dot_precision=dot, **kw)
        exact, c_exact = mix_cascade_stream(x, p, banks, carries, **kw)
        torch.cuda.synchronize()
        if dot == "split3":
            _close_fast(got, want, outtype)
            _snr_vs_exact(got, exact, outtype)
            _close_carries(c_got, c_want)
        else:
            _close_default(got, want, outtype)
            assert _snr_db(got, exact) >= 45.0
        assert torch.equal(c_got[0], c_exact[0]) and torch.equal(c_got[0], c_want[0])
        carries = c_got


@pytest.mark.cuda
@pytest.mark.parametrize("dot", ["split3", "default"])
def test_cascade_fast_split_front(card, dot):
    """The ÷16·÷16 front of the 100 Msps route, float32 planes out."""
    ms = MultiStageResampler(100_000_000, 48000)
    stages, banks = _cascade_args(ms, card, split_point(ms.stages))
    data, plan = _chunk(32, 2048, "i16", np.random.default_rng(86), NCOState())
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    rng = np.random.default_rng(87)
    carries = tuple(torch.from_numpy((rng.standard_normal((2, T_ - 1)) * 0.3)
                                     .astype(np.float32)).to(card)
                    for _, _, T_ in stages)
    kw = dict(stages=stages, outtype="f32", final_dense=True, dot_precision=dot)
    got, c_got = mix_cascade_stream(x, p, banks, carries, **kw)
    want, c_want = mix_cascade_plain(x, p, banks, carries, **kw)
    torch.cuda.synchronize()
    if dot == "split3":
        _close_fast(got, want, "f32")
        _close_carries(c_got, c_want)
    else:
        _close_default(got, want, "f32")
    assert torch.equal(c_got[0], c_want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dot", ["split3", "default"])
@pytest.mark.parametrize("fmt", ["i16", "f32"])
def test_cascade_fast_bytes_do_not_depend_on_geometry_or_chunk_cut(card, fmt, dot):
    """Every (windows, threads, slab) of CASCADE_FAST_GEOMS through
    ``_launch_fast``'s ``geom``, and 256 blocks against 4 × 64 and 8 × 32, from
    non-zero carries."""
    from doppler_tpu_torch.ops.precision import PASSES

    stages, banks = _cascade_args(MultiStageResampler(FS, 48000), card)
    B = 256
    data, plan = _chunk(B, 2048, fmt, np.random.default_rng(88), NCOState())
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    rng = np.random.default_rng(89)
    carries = tuple(torch.from_numpy((rng.standard_normal((2, T_ - 1)) * 0.3)
                                     .astype(np.float32)).to(card)
                    for _, _, T_ in stages)
    n_out = B * 2048 * 3 // 64
    args = (x, p, banks, carries, B, 2048, stages, n_out, fmt, fmt, PASSES[dot])
    want = cascade_mod._launch_fast(*args)
    for geom in CASCADE_FAST_GEOMS:
        got = cascade_mod._launch_fast(*args, geom=geom)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), geom
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), geom
    kw = dict(stages=stages, intype=fmt, outtype=fmt, dot_precision=dot)
    whole, c_whole = mix_cascade_stream(x, p, banks, carries, **kw)
    for n in (64, 32):          # two cuts: 4 × 64 and 8 × 32 blocks
        blocks = (lambda b: x[b:b + n]) if fmt == "i16" else (lambda b: x[:, b:b + n])
        c, parts = carries, []
        for b in range(0, B, n):
            o, c = mix_cascade_stream(blocks(b).contiguous(),
                                      p[:, b:b + n].contiguous(), banks, c, **kw)
            parts.append(o)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(parts, dim=-2), whole), n
        assert all(torch.equal(a, b) for a, b in zip(c, c_whole)), n
    assert torch.equal(whole.reshape(-1), want[0].reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("dot", ["split3", "default"])
def test_cascade_fast_nan_reach(card, dot):
    """A NaN input sample (float32 in and out) reaches no output outside
    the band ``csrc/cascade_fast.cu`` states (``geometry.
    cascade_fast_nan_reach``: all D·P outputs of every row whose K-entry
    band holds it, stage by stage), and every output the plain version's
    taps reach."""
    stages, banks = _cascade_args(MultiStageResampler(FS, 48000), card)
    B, L = 32, 2048
    data, plan = _chunk(B, L, "f32", np.random.default_rng(90), NCOState())
    at = (5 * L + 700, 17 * L + 1999)
    for n in at:
        data[0, n // L, n % L] = np.nan
    x = torch.from_numpy(data).to(card)
    p = nco.plan_tensor(plan, device=card)
    carries = tuple(torch.zeros(2, T_ - 1, device=card) for _, _, T_ in stages)
    kw = dict(stages=stages, intype="f32", outtype="f32", dot_precision=dot)
    got, _ = mix_cascade_stream(x, p, banks, carries, **kw)
    want, _ = mix_cascade_plain(x, p, banks, carries, **kw)
    torch.cuda.synchronize()
    lay = cascade_mod.plan_launch_fast(card, stages, L, 3 if dot == "split3" else 1)
    nan = lambda y: set(torch.nonzero(torch.isnan(y.reshape(2, -1)).any(0))  # noqa: E731
                        .flatten().tolist())
    band = geometry.cascade_fast_nan_reach(stages, lay.columns, B * L, at)
    assert nan(want) and nan(want) <= nan(got) <= band
