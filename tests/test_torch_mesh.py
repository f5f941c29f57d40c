"""``--mesh`` in the port on the CPU: a run sharded over a grid of devices
emits the unsharded run's bytes.

Mirrors ``tests/test_sharded_pipeline.py``, ``tests/test_sharding.py`` and
``tests/test_mesh_scaling.py``.  The meshes here hold the CPU four times
(``make_mesh(..., device='cpu')``), so every shard runs the kernels' plain
versions; the card tests (``tests/test_torch_cuda.py -k mesh``) and
``chip_smoke.py`` run the same steps on [cuda:0] × n.  Tolerances: the port
against itself is bitwise (``==`` on bytes, ``torch.equal`` on state); the
port against the JAX package's own mesh run (``impl='pallas'`` in interpret
mode, on the conftest's 8 fake CPU devices) is within 1 LSB in under 1% of
samples, lengths exact (XLA contracts and sums in other orders).
"""

import contextlib
import io
import logging

import numpy as np
import pytest
import torch

from doppler_tpu_torch import cli
from doppler_tpu_torch.ops import codec, nco
from doppler_tpu_torch.ops.cuda import chain, mixer
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.ops.resample import RationalResampler, attach_resampler, window_dot
from doppler_tpu_torch.parallel import sharded
from doppler_tpu_torch.parallel.mesh import make_mesh, shard_slices
from doppler_tpu_torch.runtime import checkpoint
from doppler_tpu_torch.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
RNG = np.random.default_rng(0xD1)


class VaryScheduler:
    """Track-like schedule: a shift that moves every block."""

    def __init__(self):
        self.k = 0

    def shifts(self, block_counts):
        out = []
        for _ in block_counts:
            out.append(9660.609375 - 3.25 * self.k)
            self.k += 1
        return out


def i16_stream(n, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    return rng.integers(-20000, 20000, size=2 * n, dtype=np.int16).tobytes()


def f32_stream(n):
    return (0.4 * RNG.standard_normal(2 * n)).astype("<f4").tobytes()


def cpu_mesh(time=1, channel=1):
    return make_mesh(time=time, channel=channel, device="cpu")


def make_pipe(mesh, *, fs=FS, intype="i16", outtype="i16", resample=None,
              stages="single", scheduler=None, chunk_blocks=16,
              precision="exact"):
    pipe = Pipeline(fs, intype, outtype, scheduler or ConstScheduler(-15000.0),
                    chunk_blocks=chunk_blocks, precision=precision,
                    device="cpu", mesh=mesh)
    if resample:
        attach_resampler(pipe, resample, stages=stages)
    return pipe


def run(pipe, raw):
    out = io.BytesIO()
    pipe.run(io.BytesIO(raw), out)
    return out.getvalue()


@contextlib.contextmanager
def warnings_logged():
    """The package logger's WARNING records while the block runs, whatever
    handlers and level an earlier ``cli.main`` in this process left."""
    logger = logging.getLogger("doppler_tpu_torch")
    records, level = [], logger.level
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger.addHandler(handler)
    logger.setLevel(logging.WARNING)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def run_pipe(raw, mesh, **kw):
    pipe = make_pipe(mesh, **kw)
    return run(pipe, raw), pipe


# -- one stream: mesh == unsharded ------------------------------------------------

@pytest.mark.parametrize("fmt,n_time,n", [
    ("i16", 4, 2048 * 16 * 2 + 5000),     # 2 full chunks + a partial tail
    ("f32", 2, 1024 * 16 + 300),
])
def test_mesh_mix_only_identical(fmt, n_time, n):
    raw = i16_stream(n) if fmt == "i16" else f32_stream(n)
    a, _ = run_pipe(raw, None, intype=fmt, outtype=fmt)
    b, pipe = run_pipe(raw, cpu_mesh(time=n_time), intype=fmt, outtype=fmt)
    assert a == b and len(a) == len(raw)
    assert list(pipe._sharded_steps) == ["mix"]


@pytest.mark.parametrize("chunk_blocks,n_time", [(16, 4), (32, 8)])
def test_mesh_chain_identical_at_two_chunk_widths(chunk_blocks, n_time):
    raw = i16_stream(2048 * chunk_blocks * 3 + 4321)
    a, _ = run_pipe(raw, None, resample=48000, chunk_blocks=chunk_blocks)
    b, pipe = run_pipe(raw, cpu_mesh(time=n_time), resample=48000,
                       chunk_blocks=chunk_blocks)
    assert a == b and len(a) > 0
    assert list(pipe._sharded_steps) == ["chain"]


def test_mesh_chain_f32_identical():
    raw = f32_stream(1024 * 16 * 2 + 555)
    a, _ = run_pipe(raw, None, intype="f32", outtype="f32", resample=48000)
    b, pipe = run_pipe(raw, cpu_mesh(time=2), intype="f32", outtype="f32",
                       resample=48000)
    assert a == b and len(a) > 0
    assert list(pipe._sharded_steps) == ["chain"]


@pytest.mark.parametrize("fs,split", [(FS, False), (250000, True)])
def test_mesh_cascade_full_and_split_identical(fs, split):
    """The fused cascade (1.024 Msps → 48 ksps) and the split one (250 ksps
    → 48 ksps: a ÷4 front, the 24/125 tail once over the gathered
    planes), full chunks and the partial tail."""
    raw = i16_stream(2048 * 16 * 3 + 3000)
    a, _ = run_pipe(raw, None, fs=fs, resample=48000, stages="multi",
                    scheduler=VaryScheduler())
    b, pipe = run_pipe(raw, cpu_mesh(time=4), fs=fs, resample=48000,
                       stages="multi", scheduler=VaryScheduler())
    assert pipe._cascade_mesh_ok()
    assert (pipe._cascade_k < len(pipe.resampler.stages)) == split
    assert list(pipe._sharded_steps) == ["cascade"]
    assert a == b and len(a) > 0


def test_mesh_window_route_identical():
    """A single-stage resampler the chain gate refuses (250 ksps → 48 ksps,
    Q = 125): the mixer + window resampler step, its halo mixed from the
    raw blocks before each shard."""
    raw = i16_stream(2048 * 16 * 2 + 100)
    a, _ = run_pipe(raw, None, fs=250000, resample=48000)
    b, pipe = run_pipe(raw, cpu_mesh(time=4), fs=250000, resample=48000)
    assert a == b and len(a) > 0
    assert list(pipe._sharded_steps) == ["window"]


def test_mesh_track_schedule_identical():
    raw = i16_stream(2048 * 16 * 2 + 999)
    a, _ = run_pipe(raw, None, scheduler=VaryScheduler(), resample=48000)
    b, _ = run_pipe(raw, cpu_mesh(time=4), scheduler=VaryScheduler(),
                    resample=48000)
    assert a == b


def test_mesh_fast_equals_exact():
    """Mesh paths keep the exact dot, as in the JAX package: under a mesh
    ``--precision fast`` gives the exact bytes."""
    raw = i16_stream(2048 * 16 * 2 + 77)
    exact, _ = run_pipe(raw, cpu_mesh(time=4), resample=48000)
    fast, _ = run_pipe(raw, cpu_mesh(time=4), resample=48000, precision="fast")
    assert fast == exact


def test_mesh_replay_counts(monkeypatch):
    """Each chunk launches the chain once a shard plus one 1-block replay
    for every shard k > 0; the EOF chunk runs the mixer unsharded."""
    calls = []
    real = chain.mix_resample_chain_stream

    def counting(data, *a, **kw):
        calls.append(data.shape[-2])
        return real(data, *a, **kw)

    monkeypatch.setattr(chain, "mix_resample_chain_stream", counting)
    raw = i16_stream(2048 * 16 * 3 + 10)
    run_pipe(raw, cpu_mesh(time=4), resample=48000)
    assert sorted(calls) == [1] * 9 + [4] * 12


@pytest.mark.parametrize("stages", ["single", "multi"])
def test_mesh_after_seek_identical(stages):
    """A meshed pipeline seeked to a chunk boundary (the start of a
    ``--distributed`` host's range) emits the unsharded run's bytes from
    there: the seek's replay seeds the carry the first shard takes."""
    raw = i16_stream(2048 * 16 * 4 + 500)
    whole, _ = run_pipe(raw, None, resample=48000, stages=stages)
    prefix, _ = run_pipe(raw[:2048 * 32 * 4], None, resample=48000,
                         stages=stages)
    pipe = make_pipe(cpu_mesh(time=4), resample=48000, stages=stages)
    n_hist = pipe.seek_history_blocks()
    pipe.seek_to_block(32, history=raw[(32 - n_hist) * 8192:32 * 8192])
    assert prefix + run(pipe, raw[32 * 8192:]) == whole


def test_mesh_checkpoint_resume_both_ways(tmp_path):
    """A checkpoint cut under a mesh resumes without one bitwise, and the
    other way round; the checkpoints of the two runs are equal."""
    raw = i16_stream(2048 * 16 * 4)
    for resample, stages in ((48000, "single"), (48000, "multi")):
        full, _ = run_pipe(raw, None, resample=resample, stages=stages)
        cut = 2048 * 16 * 2 * 4                    # bytes: 2 whole chunks
        states = []
        for first, second in ((cpu_mesh(time=4), None), (None, cpu_mesh(time=4))):
            p1 = make_pipe(first, resample=resample, stages=stages)
            out1 = run(p1, raw[:cut])
            path = tmp_path / f"ck{len(states)}.npz"
            checkpoint.save(path, p1)
            states.append(np.load(path))
            p2 = make_pipe(second, resample=resample, stages=stages)
            meta = checkpoint.restore(path, p2)
            assert meta["sample_offset"] * 4 == cut
            assert out1 + run(p2, raw[cut:]) == full
        assert sorted(states[0].files) == sorted(states[1].files)
        for key in states[0].files:
            assert np.array_equal(states[0][key], states[1][key]), key


def test_mesh_validation_errors(monkeypatch):
    with pytest.raises(ValueError, match="channel=1"):
        Pipeline(FS, "i16", "i16", ConstScheduler(0.0), device="cpu",
                 mesh=cpu_mesh(time=2, channel=2))
    with pytest.raises(ValueError, match="divisible"):
        Pipeline(FS, "i16", "i16", ConstScheduler(0.0), chunk_blocks=3,
                 device="cpu", mesh=cpu_mesh(time=2))
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(0.0), chunk_blocks=4,
                    block_bytes=512, device="cpu", mesh=cpu_mesh(time=4))
    with pytest.raises(ValueError, match="exceeds one time shard"):
        attach_resampler(pipe, 48000)
    with pytest.raises(ValueError, match="divide over mesh"):
        MultiChannelPipeline(
            FS, "i16", "i16",
            [ChannelSpec(name=c, scheduler=ConstScheduler(0.0)) for c in "abc"],
            device="cpu", mesh=cpu_mesh(time=2, channel=2))
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        make_mesh(time=4, channel=4, devices=["cpu"] * 8)
    # on the card the default devices are the distinct local cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(time=2)
    mesh = make_mesh(time=2, devices=["cuda:0"] * 2)
    assert mesh.shape == {"channel": 1, "time": 2}
    assert mesh.distinct_devices() == [torch.device("cuda", 0)]


def test_mesh_cascade_that_cannot_shard_warns_and_runs_unsharded():
    """A cascade whose replay span is longer than a shard runs unsharded
    with a warning, and still gives the unsharded bytes."""
    raw = i16_stream(2048 * 8 * 2 + 10)
    a, _ = run_pipe(raw, None, fs=100_000_000, resample=48000, stages="multi",
                    chunk_blocks=8)
    with warnings_logged() as records:
        b, pipe = run_pipe(raw, cpu_mesh(time=4), fs=100_000_000,
                           resample=48000, stages="multi", chunk_blocks=8)
    assert not pipe._cascade_mesh_ok() and not pipe._sharded_steps
    assert any("cannot run the sharded" in r.getMessage() for r in records)
    assert a == b and len(a) > 0


def test_mesh_replay_span_equals_seek_history():
    """The mesh replay and the seek use one definition of the span
    (``cascade.cascade_replay_need``): on a fully fused cascade the mesh's
    span in blocks is ``seek_history_blocks`` (before widening), and on a
    split one the seek's need is the whole cascade's with the tail's T−1."""
    from doppler_tpu_torch.ops.cuda import cascade

    for fs, chunk_blocks in ((FS, 256), (100_000_000, 256)):
        pipe = make_pipe(None, fs=fs, resample=48000, stages="multi",
                         chunk_blocks=chunk_blocks)
        rs, L = pipe.resampler, pipe.block_samples
        n_hist = pipe.seek_history_blocks()
        k = pipe._cascade_k
        need_seek = cascade.cascade_replay_need(rs.stages, fs, k)
        assert n_hist == -(-need_seek // L)
        need_mesh = cascade.cascade_replay_need(rs.stages[:k], fs)
        if k == len(rs.stages):
            assert need_mesh == need_seek
        else:
            assert need_mesh < need_seek
        r_h = sharded.cascade_shard_replay(rs, k, L, chunk_blocks // 2)
        assert r_h >= -(-need_mesh // L)
        assert cascade.chunk_out_count(
            tuple((st.P, st.Q, st.T) for st in rs.stages[:k]), r_h, L)


def test_mesh_replay_spans_stay_small():
    """test_mesh_scaling.py's geometry on the port's: a shard of b_loc
    blocks does b_loc + r_h blocks of work.  The chain replays one block;
    the config-3 cascade one block at any width; config 5's ÷256 front
    (5224 samples of corrupt head and cone) three blocks, over 97% of the
    work at B = 2048 out to width 8."""
    from doppler_tpu_torch.ops.multistage import MultiStageResampler

    rs = RationalResampler(FS, 48000)
    assert rs.T - 1 <= 2048          # the chain's carry fits in one block
    ms = MultiStageResampler(FS, 48000)
    for n_time in (2, 4, 8, 16, 64):
        assert sharded.cascade_shard_replay(ms, 2, 2048, 4096 // n_time) == 1
    ms5 = MultiStageResampler(100_000_000, 48000)
    for n_time in (2, 4, 8):
        b_loc = 2048 // n_time
        r_h = sharded.cascade_shard_replay(ms5, 2, 2048, b_loc)
        assert r_h == 3 and b_loc / (b_loc + r_h) > 0.97, (n_time, r_h)


# -- channels ---------------------------------------------------------------------

def run_channels(raw, mesh, specs, *, fs=FS, chunk_blocks=16, **kw):
    mp = MultiChannelPipeline(fs, "i16", "i16", specs, chunk_blocks=chunk_blocks,
                              device="cpu", mesh=mesh, **kw)
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(raw), outs)
    return [o.getvalue() for o in outs], mp


def const_specs(n=4):
    return [ChannelSpec(name=f"ch{k}", scheduler=ConstScheduler(-30000.0 + 8000 * k),
                        center_offset_hz=500.0 * k) for k in range(n)]


def mixed_rate_specs():
    return [ChannelSpec(name="a", scheduler=ConstScheduler(-30000.0), out_rate=48000.0),
            ChannelSpec(name="b", scheduler=ConstScheduler(12000.0), out_rate=48000.0),
            ChannelSpec(name="c", scheduler=ConstScheduler(50000.0), out_rate=32000.0),
            ChannelSpec(name="d", scheduler=ConstScheduler(-4000.0), out_rate=32000.0)]


def mixed_route_specs():
    """A cascade group (48 ksps) beside a no-resampler group."""
    return [ChannelSpec(name="a", scheduler=ConstScheduler(-30000.0)),
            ChannelSpec(name="b", scheduler=ConstScheduler(12000.0), out_rate=48000.0),
            ChannelSpec(name="c", scheduler=ConstScheduler(50000.0)),
            ChannelSpec(name="d", scheduler=ConstScheduler(-4000.0), out_rate=48000.0)]


@pytest.mark.parametrize("case,specs,kw,kinds", [
    ("mix", const_specs, {}, ["mix"]),
    ("single-stage", const_specs, dict(out_rate=48000), ["window"]),
    ("cascade", const_specs, dict(out_rate=48000, resample_stages="multi"),
     ["cascade"]),
    ("mixed rates", mixed_rate_specs, {}, ["window", "window"]),
    ("cascade beside mix", mixed_route_specs, dict(resample_stages="multi"),
     ["mix", "cascade"]),
])
def test_mesh_channels_identical(case, specs, kw, kinds):
    raw = i16_stream(2048 * 16 * 2 + 3000)
    a, _ = run_channels(raw, None, specs(), **kw)
    b, mp = run_channels(raw, cpu_mesh(time=2, channel=2), specs(), **kw)
    assert a == b and all(len(x) > 0 for x in a), case
    assert not mp._warned, mp._warned
    assert sorted(kind for kind, _ in mp._sharded_steps) == sorted(kinds)


def test_mesh_channels_split_and_config5_rate():
    """The split channel cascade at 250 ksps and at config 5's literal
    100 Msps (÷16·÷16 front, 384/3125 tail) over a few blocks."""
    for fs, n, cb in ((250000, 2048 * 16 * 2, 16), (100_000_000, 2048 * 64, 32)):
        raw = i16_stream(n, seed=fs % 97)
        step = 1e6 if fs > FS else 5000.0

        def specs():
            return [ChannelSpec(name=f"c{k}",
                                scheduler=ConstScheduler(step * (k - 1.5)))
                    for k in range(4)]
        kw = dict(fs=fs, chunk_blocks=cb, out_rate=48000, resample_stages="multi")
        a, _ = run_channels(raw, None, specs(), **kw)
        b, mp = run_channels(raw, cpu_mesh(time=2, channel=2), specs(), **kw)
        assert mp._sharded_casc_cfg[0] < len(mp.resampler.stages)   # split
        assert list(mp._sharded_steps) == [("cascade", 0)] and not mp._warned
        assert a == b and all(len(x) > 0 for x in a), fs


def test_mesh_channels_checkpoint_resume_both_ways(tmp_path):
    raw = i16_stream(2048 * 16 * 4)
    kw = dict(out_rate=48000, resample_stages="multi")
    full, _ = run_channels(raw, None, const_specs(), **kw)
    cut = 2048 * 16 * 2 * 4
    for first, second in ((cpu_mesh(time=2, channel=2), None),
                          (None, cpu_mesh(time=2, channel=2))):
        out1, mp1 = run_channels(raw[:cut], first, const_specs(), **kw)
        path = tmp_path / "ck.npz"
        checkpoint.save_channels(path, mp1)
        mp2 = MultiChannelPipeline(FS, "i16", "i16", const_specs(),
                                   chunk_blocks=16, device="cpu", mesh=second,
                                   **kw)
        checkpoint.restore_channels(path, mp2)
        outs = [io.BytesIO() for _ in range(4)]
        mp2.run(io.BytesIO(raw[cut:]), outs)
        assert [x + y.getvalue() for x, y in zip(out1, outs)] == full


# -- the op-level step and the host helpers ---------------------------------------

def _channel_batch(C, B, L, fs, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(-(1 << 31), 1 << 31, size=(C, B, L),
                         dtype=np.int64).astype(np.int32)
    fields = np.zeros((7, C, B), dtype=np.uint32)
    for c in range(C):
        plan = plan_blocks([9000.0 + 130.0 * c - 0.5 * k for k in range(B)],
                           [L] * B, fs, NCOState(), L)
        fields[:, c] = np.stack([np.asarray(getattr(plan, f), dtype=np.uint32)
                                 for f in ("d_hi", "d_lo", "c1_hi", "c1_lo",
                                           "c2_hi", "c2_lo", "t")])
    return torch.from_numpy(words), torch.from_numpy(fields.view(np.int32))


def test_sharded_step_mix_and_resample():
    """``make_sharded_step`` (tests/test_sharding.py): the mix over a
    channel × time mesh bitwise the unsharded mixer, and the resample's
    valid outputs bitwise one ``window_dot`` over each whole channel."""
    C, B, L = 4, 8, 2048
    mesh = cpu_mesh(time=2, channel=4)
    words, plans = _channel_batch(C, B, L, 256000, 1)
    got = sharded.make_sharded_step(mesh)(words, plans)
    want = torch.stack([mixer.mix_blocks_fmt(words[c], plans[:, c])
                        for c in range(C)])
    assert torch.equal(got, want)
    got = sharded.make_sharded_step(mesh, outtype="f32")(words, plans)
    want = torch.stack([mixer.mix_blocks_fmt(words[c], plans[:, c], outtype="f32")
                        for c in range(C)], dim=1)
    assert got.shape == (2, C, B, L) and torch.equal(got, want)

    words, plans = _channel_batch(C, B, L, FS, 2)
    rs = RationalResampler(FS, 48000)
    out = sharded.make_sharded_step(mesh, outtype="f32", resampler=rs)(words, plans)
    counts = sharded.shard_valid_out_counts(B * L // 2, 2, rs.P, rs.Q)
    got = torch.cat([out[:, :, k, :counts[k]] for k in range(2)], dim=-1)
    mixed = torch.stack([mixer.mix_blocks_fmt(words[c], plans[:, c], outtype="f32")
                         .reshape(2, -1) for c in range(C)], dim=1)
    zeros = torch.zeros((C, rs.T - 1))
    wi, wq = window_dot(torch.cat([zeros, mixed[0]], -1),
                        torch.cat([zeros, mixed[1]], -1),
                        torch.from_numpy(rs.bank[:, ::-1].copy()), 0, 0,
                        P=rs.P, Q=rs.Q, T=rs.T, M=sum(counts))
    assert torch.equal(got[0], wi) and torch.equal(got[1], wq)


def test_shard_slices_cover_the_chunk_once():
    mesh = cpu_mesh(time=4, channel=2)
    seen = np.zeros((8, 16), dtype=int)
    for dev, cs, bs in shard_slices(mesh, 8, 16):
        assert dev == torch.device("cpu")
        seen[cs, bs] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError, match="do not divide"):
        shard_slices(mesh, 8, 18)


# -- against the JAX package's own mesh run ---------------------------------------

@pytest.fixture(scope="module")
def jax_mesh4():
    import jax

    from doppler_tpu.parallel import make_mesh as j_make_mesh

    assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"
    return j_make_mesh(time=4, channel=1)


@pytest.mark.parametrize("stages", ["single", "multi"])
def test_mesh_against_jax_mesh(jax_mesh4, stages):
    """The port's mesh run against the JAX package's (``impl='pallas'``,
    interpret mode, time=4): the fused chain and the fused cascade."""
    from doppler_tpu.ops.resample import attach_resampler as j_attach
    from doppler_tpu.runtime.pipeline import ConstScheduler as JConst
    from doppler_tpu.runtime.pipeline import Pipeline as JPipeline

    raw = i16_stream(2048 * 16 * 2 + 999, seed=17)
    jp = JPipeline(FS, "i16", "i16", JConst(-15000.0), chunk_blocks=16,
                   mesh=jax_mesh4, impl="pallas", pallas_interpret=True)
    j_attach(jp, 48000, stages=stages)
    want = io.BytesIO()
    jp.run(io.BytesIO(raw), want)
    got, pipe = run_pipe(raw, cpu_mesh(time=4), resample=48000, stages=stages)
    assert list(pipe._sharded_steps) == ["chain" if stages == "single" else "cascade"]
    a = np.frombuffer(got, "<i2").astype(np.int32)
    b = np.frombuffer(want.getvalue(), "<i2").astype(np.int32)
    assert a.size == b.size and a.size > 0
    d = np.abs(a - b)
    assert d.max() <= 1 and np.mean(d > 0) < 0.01


def test_sharded_mix_step_against_jax(jax_mesh4):
    """The op-level mix step against the JAX one (XLA, a 2 × 4 mesh)."""
    import jax
    import jax.numpy as jnp

    from doppler_tpu.parallel import iq_sharding, plan_sharding
    from doppler_tpu.parallel import make_mesh as j_make_mesh
    from doppler_tpu.parallel import make_sharded_step as j_step

    C, B, L = 4, 8, 2048
    words, plans = _channel_batch(C, B, L, 256000, 3)
    jmesh = j_make_mesh(time=2, channel=4)
    fields = [jax.device_put(jnp.asarray(plans[f].numpy().view(np.uint32)),
                             plan_sharding(jmesh)) for f in range(7)]
    want = np.asarray(j_step(jmesh)(jax.device_put(jnp.asarray(words.numpy()),
                                                   iq_sharding(jmesh)), *fields))
    got = sharded.make_sharded_step(cpu_mesh(time=2, channel=4))(words, plans)
    gi, gq = codec.i16_words_to_iq(got)
    wi, wq = codec.i16_words_to_iq(torch.from_numpy(want.copy()))
    d = torch.maximum((gi - wi).abs(), (gq - wq).abs()) * 32768.0
    assert float(d.max()) <= 1.0 + 1e-3 and float((d == 0).float().mean()) > 0.999
    # channel 0 is the plain mix of its own chunk
    i, q = codec.i16_words_to_iq(words[0])
    ri, rq = nco.mix_blocks(i, q, plans[:, 0])
    assert torch.equal(got[0], codec.iq_to_i16_words(ri, rq))


# -- the CLI ----------------------------------------------------------------------

def test_cli_mesh_cpu_channels(tmp_path):
    """``channels --mesh time=2,channel=2 --device cpu``: the channel files
    equal the unsharded run's."""
    import json

    cfg = {"channels": [{"name": f"c{k}", "shift": -30000.0 + 9000.0 * k}
                        for k in range(4)]}
    path = tmp_path / "ch.json"
    path.write_text(json.dumps(cfg))
    raw = i16_stream(2048 * 16 * 2 + 700)
    outs = {}
    for key, extra in (("plain", []), ("mesh", ["--mesh", "time=2,channel=2"])):
        rc = cli.main(["channels", "-s", str(FS), "-i", "i16", "--config",
                       str(path), "--output-dir", str(tmp_path / key),
                       "--resample-to", "48000", "--resample-stages", "multi",
                       "--chunk-blocks", "16", "--device", "cpu",
                       "--log-level", "error"] + extra,
                      stdin=io.BytesIO(raw), stdout=io.BytesIO())
        assert rc == 0
        outs[key] = [(tmp_path / key / f"c{k}.iq").read_bytes() for k in range(4)]
    assert outs["plain"] == outs["mesh"] and all(outs["plain"])
