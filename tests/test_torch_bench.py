"""The bench port (``doppler_tpu_torch/tools/bench.py``) against ``bench.py``.

``bench.py``'s arguments are read from its source with ``ast`` (its ``main``
runs a benchmark and parses ``sys.argv``); each mode's step is held against
the JAX call that ``bench.py`` makes for that mode, rebuilt here from the
same seed-``0xBE`` words and the JAX package's plan words, Pallas in
interpret mode, at the smallest sizes ``bench.py`` accepts: two blocks of
8192 samples a stream, C = 2 in the channel modes.

Tolerance: the bar of ``tests/test_torch_chain.py`` — encoded outputs of
equal length within 1 LSB in under 1% of samples (the port sums its FIRs
in a fixed order, JAX as XLA contracts; no module test holds any of these
kernels bitwise to JAX).  Inside the port, a time-sharded chain gives the
unsharded chain's bytes.
"""

import argparse
import ast
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as Spec

from doppler_tpu.ops import codec as jcodec
from doppler_tpu.ops import nco as jnco
from doppler_tpu.ops.multistage import MultiStageResampler as JMultiStage
from doppler_tpu.ops.pallas.chain import (
    carry_rows,
    make_chain_taps,
    mix_cascade_pallas_channels,
    mix_cascade_pallas_stream,
    mix_resample_chain_pallas_channels,
    mix_resample_chain_pallas_stream,
)
from doppler_tpu.ops.pallas.mixer import mix_blocks_pallas
from doppler_tpu.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu.ops.resample import RationalResampler as JRational
from doppler_tpu.ops.resample import (
    conv_stream_geometry,
    make_taps_matrix,
    resample_conv_block,
    resample_conv_stream,
)
from doppler_tpu.parallel import make_mesh as jmake_mesh
from doppler_tpu.parallel.sharded import make_chain_stream_step
from doppler_tpu_torch.tools import bench, common

torch.set_num_threads(1)   # leave the other test workers their cores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
L = 8192
C = 2
FIELDS = ("d_hi", "d_lo", "c1_hi", "c1_lo", "c2_hi", "c2_lo", "t")
# (mode, precision): every mode, and 'fast' where bench.py has it
CASES = [(m, "exact") for m in bench.MODES] + [
    ("chain-pallas", "fast"), ("channels-pallas", "fast")]


def _arguments(path, namespace):
    """``{flag: {type, choices, default, action}}`` of every
    ``add_argument`` call in the source at ``path`` (its names looked up in
    ``namespace``), without running it."""
    tree = ast.parse(open(path).read())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: eval(compile(ast.Expression(k.value), path, "eval"),
                              dict(namespace))
                  for k in node.keywords
                  if k.arg in ("type", "choices", "default", "action")}
            if "choices" in kw:
                kw["choices"] = list(kw["choices"])
            found[ast.literal_eval(node.args[0])] = kw
    return found


def _bench_py_metrics():
    """The metric names ``bench.py`` can print, f-strings with ``{C}``."""
    tree = ast.parse(open(BENCH_PY).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            text = "".join(v.value if isinstance(v, ast.Constant)
                           else "{" + ast.unparse(v.value) + "}"
                           for v in node.values)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        else:
            continue
        if text.endswith(("_chip", "_aggregate")) and " " not in text:
            names.add(text)
    return names


def _blocks(mode):
    """Blocks a stream: 2, or 4 in the split modes, whose JAX front takes
    no fewer (``pick_cascade_blocks_per_step``)."""
    return 4 if "split" in mode else 2


def _samples(mode):
    return (C if mode.startswith("channels") else 1) * _blocks(mode) * L


def _args(mode, precision="exact", mesh_time=0):
    return argparse.Namespace(samples=_samples(mode), channels=C,
                              precision=precision, mesh_time=mesh_time)


# -- bench.py's JAX calls -------------------------------------------------

def _jax_plan(shifts, fs):
    plan = plan_blocks(shifts, [L] * len(shifts), fs, NCOState(), L)
    return [jnp.asarray(getattr(plan, f)) for f in FIELDS]


def _jax_fields(shift, B, fs):
    fields = np.zeros((7, C, B), dtype=np.uint32)
    for c in range(C):
        plan = plan_blocks([shift(c, k) for k in range(B)], [L] * B, fs,
                           NCOState(), L)
        for fi, name in enumerate(FIELDS):
            fields[fi, c] = getattr(plan, name)
    return jnp.asarray(fields)


def _jax_conv(xi, xq, taps, st, n_in, m):
    """``bench.py``'s conv stage: T−1 zeros, then ``resample_conv_stream``."""
    s0, p0, K, PADZ, TAIL = conv_stream_geometry(0, 0, m, n_in, P=st.P,
                                                 Q=st.Q, T=st.T)
    zeros = jnp.zeros(xi.shape[:-1] + (st.T - 1,), jnp.float32)
    return resample_conv_stream(
        jnp.concatenate([zeros, xi], axis=-1),
        jnp.concatenate([zeros, xq], axis=-1), taps, jnp.int32(s0),
        jnp.int32(p0), P=st.P, Q=st.Q, T=st.T, K=K, M=m, PADZ=PADZ, TAIL=TAIL)


def _jax_output(mode, precision):
    """What ``bench.py``'s step for ``mode`` returns, as numpy words."""
    split = mode.startswith("split") or mode == "channels-split"
    fs = 100_000_000 if split else 1024000
    B = _blocks(mode)
    N = B * L
    rng = np.random.default_rng(0xBE)
    data = jnp.asarray(rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                    dtype=np.int64).astype(np.int32))
    plan = _jax_plan([9000.0 - 0.01 * k for k in range(B)], fs)
    dot = "split3" if precision == "fast" else "highest"
    rs = None if split else JRational(fs, 48000)
    chain_shift = lambda c, k: 9000.0 + 120.0 * c - 0.01 * k  # noqa: E731

    if mode in ("mix", "mix-pallas"):
        if mode == "mix-pallas":
            return mix_blocks_pallas(data, *plan, interpret=True)
        i, q = jcodec.i16_words_to_iq(data)
        return jcodec.iq_to_i16_words(*jnco.mix_blocks(i, q, *plan))
    if mode == "chain-pallas":
        taps = jnp.asarray(make_chain_taps(rs.bank, rs.P, rs.Q))
        carry = jnp.zeros((2, carry_rows(rs.T), 128), jnp.float32)
        return mix_resample_chain_pallas_stream(
            data, *plan, taps, carry, P=rs.P, Q=rs.Q, T=rs.T,
            dot_precision=dot, interpret=True)[0]
    if mode == "channels-pallas":
        taps = jnp.asarray(make_chain_taps(rs.bank, rs.P, rs.Q))
        carries = jnp.zeros((C, 2, carry_rows(rs.T), 128), jnp.float32)
        return mix_resample_chain_pallas_channels(
            data, _jax_fields(chain_shift, B, fs), taps, carries, P=rs.P,
            Q=rs.Q, T=rs.T, dot_precision=dot, interpret=True)[0]
    if mode == "cascade-pallas":
        ms = JMultiStage(fs, 48000)
        n = len(ms.stages)
        taps = tuple(jnp.asarray(make_chain_taps(
            st.bank, st.P, st.Q, pp=(st.P if i < n - 1 else None)))
            for i, st in enumerate(ms.stages))
        carries = tuple(jnp.zeros((2, carry_rows(st.T), 128), jnp.float32)
                        for st in ms.stages)
        return mix_cascade_pallas_stream(
            data, *plan, taps, carries,
            stages=tuple((st.P, st.Q, st.T) for st in ms.stages),
            interpret=True)[0]
    if mode == "chain-mesh":
        mesh = jmake_mesh(time=2, channel=1)
        step = make_chain_stream_step(mesh, resampler=rs, interpret=True)
        d = jax.device_put(data, NamedSharding(mesh, Spec("time", None)))
        plans = [jax.device_put(a[None], NamedSharding(mesh, Spec("channel", "time")))
                 for a in plan]
        repl = NamedSharding(mesh, Spec())
        carry = jax.device_put(
            jnp.zeros((2, carry_rows(rs.T), 128), jnp.float32), repl)
        taps = jax.device_put(jnp.asarray(make_chain_taps(rs.bank, rs.P, rs.Q)),
                              repl)
        return step(d, *plans, carry, taps)[0]
    if mode in ("chain", "channels"):
        taps = jnp.asarray(make_taps_matrix(rs.bank, rs.P, rs.Q))
        zeros = jnp.zeros(rs.T - 1, jnp.float32)

        def one(p):
            i, q = jcodec.i16_words_to_iq(data)
            i, q = jnco.mix_blocks(i, q, *p)
            i = jnp.concatenate([zeros, i.reshape(-1)])
            q = jnp.concatenate([zeros, q.reshape(-1)])
            return jcodec.iq_to_i16_words(*resample_conv_block(
                i, q, taps, P=rs.P, Q=rs.Q, T=rs.T))

        if mode == "chain":
            return one(plan)
        fields = _jax_fields(chain_shift, B, fs)
        return jnp.stack([one([fields[f, c] for f in range(7)])
                          for c in range(C)])
    # the split modes: the fused ÷16·÷16 front (or its XLA twin), the tail
    ms = JMultiStage(fs, 48000)
    front, fin = ms.stages[:-1], ms.stages[-1]
    stages = tuple((st.P, st.Q, st.T) for st in front)
    front_taps = tuple(jnp.asarray(make_chain_taps(st.bank, st.P, st.Q,
                                                   pp=st.P)) for st in front)
    fin_taps = jnp.asarray(make_taps_matrix(fin.bank, fin.P, fin.Q))
    n_mid = N // int(np.prod([st.Q for st in front]))
    m_fin = n_mid * fin.P // fin.Q
    if mode == "channels-split":
        carries = tuple(jnp.zeros((C, 2, carry_rows(st.T), 128), jnp.float32)
                        for st in front)
        planes = mix_cascade_pallas_channels(
            data, _jax_fields(lambda c, k: 1e6 * (c - C / 2) - 0.01 * k, B, fs),
            front_taps, carries, stages=stages, intype="i16", outtype="f32",
            final_dense=True, interpret=True)[0].reshape(2, C, -1)
    elif mode == "split-pallas":
        carries = tuple(jnp.zeros((2, carry_rows(st.T), 128), jnp.float32)
                        for st in front)
        planes = mix_cascade_pallas_stream(
            data, *plan, front_taps, carries, stages=stages, intype="i16",
            outtype="f32", final_dense=True, interpret=True)[0].reshape(2, -1)
    else:
        i, q = jcodec.i16_words_to_iq(data)
        i, q = jnco.mix_blocks(i, q, *plan)
        yi, yq, n = i.reshape(-1), q.reshape(-1), N
        for st in front:
            m = n * st.P // st.Q
            yi, yq = _jax_conv(yi, yq, jnp.asarray(
                make_taps_matrix(st.bank, st.P, st.Q)), st, n, m)
            n = m
        planes = jnp.stack([yi, yq])
    return jcodec.iq_to_i16_words(*_jax_conv(planes[0], planes[1], fin_taps,
                                             fin, n_mid, m_fin))


def _words(out):
    if isinstance(out, (list, tuple)):          # chain-mesh: the time shards
        out = torch.cat(list(out))
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


def _lsb_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.view(np.int16).astype(np.int32)
               - want.view(np.int16).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


# -- tests ----------------------------------------------------------------

def test_arguments_are_bench_pys():
    want = _arguments(BENCH_PY, {})
    got = _arguments(bench.__file__, vars(bench))
    assert got.pop("--device") == {"choices": ["cuda", "cpu"], "default": None}
    assert got == want
    assert tuple(want["--mode"]["choices"]) == bench.MODES
    args = bench.parse_args([])
    assert args.device == "cuda" and args.samples == 1 << 25
    assert bench.parse_args(["--platform", "cpu"]).device == "cpu"
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        bench.parse_args(["--platform", "cpu", "--device", "cuda"])


@pytest.mark.parametrize("mode,precision", CASES)
def test_step_matches_bench_pys_jax_call(mode, precision):
    step, total, metric, fs = bench.build(mode, _args(mode, precision, 2),
                                          torch.device("cpu"))
    _lsb_close(_words(step()), np.asarray(_jax_output(mode, precision)))
    assert total == _samples(mode)
    assert fs == (100_000_000 if "split" in mode else 1024000)
    assert metric.replace(f"channels{C}_", "channels{C}_") in _bench_py_metrics()


def test_inputs_are_bench_pys():
    """``(B, L)`` words of seed 0xBE and the JAX package's plan words."""
    words, plans, B = common.bench_inputs(3 * L + 5, "cpu", fs=1024000, L=L)
    assert B == 3 and tuple(words.shape) == (3, L)
    rng = np.random.default_rng(0xBE)
    assert np.array_equal(words.numpy(), rng.integers(
        -(1 << 31), 1 << 31, size=(3, L), dtype=np.int64).astype(np.int32))
    plan = plan_blocks([9000.0 - 0.01 * k for k in range(3)], [L] * 3, 1024000,
                       NCOState(), L)
    want = np.stack([getattr(plan, f) for f in FIELDS]).view(np.int32)
    assert np.array_equal(plans.numpy(), want)
    shift = lambda c, k: 1e6 * (c - C / 2) - 0.01 * k  # noqa: E731
    got = common.channel_plans(shift, C, 3, 100_000_000, "cpu", L)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(_jax_fields(shift, 3, 100_000_000)))


def test_mix_modes_run_one_function():
    a = bench.build("mix", _args("mix"), torch.device("cpu"))[0]()
    b = bench.build("mix-pallas", _args("mix"), torch.device("cpu"))[0]()
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_time", [1, 2])
def test_chain_mesh_is_the_unsharded_chain_bitwise(n_time):
    outs = bench.build("chain-mesh", _args("chain-mesh", mesh_time=n_time),
                       torch.device("cpu"))[0]()
    assert len(outs) == n_time
    whole = bench.build("chain-pallas", _args("chain-pallas"),
                        torch.device("cpu"))[0]()
    assert torch.equal(torch.cat(outs), whole)


def _main(argv, capsys):
    assert bench.main(argv) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, out.out
    return json.loads(lines[0]), out.err


@pytest.mark.parametrize("mode,precision", CASES)
def test_main_prints_one_json_line(mode, precision, capsys):
    res, err = _main(["--device", "cpu", "--mode", mode, "--precision", precision,
                      "--channels", str(C), "--samples", str(_samples(mode)),
                      "--iters", "1", "--dispatches", "1"], capsys)
    fs = 100_000_000 if "split" in mode else 1024000
    assert res["metric"].replace(f"channels{C}_", "channels{C}_") in _bench_py_metrics()
    assert res["unit"] == "samples/s" and res["value"] > 0
    assert res["vs_baseline"] == res["value"] / fs
    assert "[cpu]" in err
    if mode == "chain-mesh":
        assert res["mesh_time"] == 1 and "efficiency_vs_time1" not in res


def test_mesh_scan_reports_the_efficiency(capsys):
    res, err = _main(["--platform", "cpu", "--mode", "chain-mesh", "--mesh-time",
                      "2", "--mesh-scan", "--samples", str(2 * L), "--iters", "1",
                      "--dispatches", "1"], capsys)
    assert res["mesh_time"] == 2 and res["efficiency_vs_time1"] > 0
    assert "time=1" in err and "time=2" in err and "scaling efficiency" in err


def test_mesh_time_must_divide_the_blocks():
    with pytest.raises(SystemExit, match="not divisible"):
        bench.build("chain-mesh", _args("chain-mesh", mesh_time=3),
                    torch.device("cpu"))


def test_profile_writes_a_trace(tmp_path, capsys):
    _main(["--device", "cpu", "--mode", "mix", "--samples", str(L), "--iters",
           "1", "--dispatches", "1", "--profile", str(tmp_path)], capsys)
    trace = tmp_path / "mix.trace.json"
    assert trace.exists() and "traceEvents" in json.loads(trace.read_text())


def test_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("only a machine without a card can show this")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--samples", str(L), "--iters", "1", "--dispatches", "1"])
