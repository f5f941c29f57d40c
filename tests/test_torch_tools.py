"""The port's measuring tools on the CPU: ``runtime/timing.py``, the roofline,
tone, cascade-precision and split-tail tools at a small ``--samples`` with
``--device cpu`` (the kernels' plain versions: a check of the control flow,
no measurement), the conformance harness config by config, and the walk
that shows no module of the package imports jax or the JAX package.

Conformance's bar is the harness's own: > 60 dB against the golden model
after i16 quantization, exact lengths (±2 on config 5).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from doppler_tpu_torch.runtime.timing import card_label, timed_dispatches
from doppler_tpu_torch.tools import (
    conformance,
    probe_cascade_precision,
    probe_chain_precision,
    probe_split_tail,
    roofline,
)

torch.set_num_threads(1)   # leave the other test workers their cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--samples", "16384", "--dispatches", "2",
         "--iters", "2"]


def test_timed_dispatches_on_the_cpu_calls_step_k_times():
    calls = []
    dt = timed_dispatches(lambda: calls.append(1), 5, "cpu")
    assert isinstance(dt, float) and dt > 0.0
    assert len(calls) == 5
    assert card_label("cpu") == "cpu"


def test_timed_dispatches_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("only a machine without a card can show this")
    with pytest.raises(RuntimeError):
        timed_dispatches(lambda: None, 1, "cuda")


def _json_line(capsys):
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, out.out
    return json.loads(lines[0]), out.err


def test_roofline_emits_every_asked_variant(capsys):
    names = list(roofline.MIXER_SHAPED + roofline.CHAIN_SHAPED)
    assert roofline.main(SMALL + ["--variants", ",".join(names)]) == 0
    res, err = _json_line(capsys)
    assert list(res) == names
    for name in names:
        assert set(res[name]) == {"gsps", "gbps", "ms_per_dispatch"}
        assert res[name]["ms_per_dispatch"] > 0
        assert any(ln.startswith(name + " ") for ln in err.splitlines())
    # 8 B a sample for the mixer's shape, 4 + 4·3/64 for the chain's
    assert res["copy"]["gbps"] == pytest.approx(8.0 * res["copy"]["gsps"])
    assert res["chain-mix"]["gbps"] == pytest.approx(
        (4 + 4 * 3 / 64) * res["chain-mix"]["gsps"])


def test_roofline_default_variants_are_the_mixer_shaped_ones(capsys):
    assert roofline.main(SMALL) == 0
    res, _ = _json_line(capsys)
    assert list(res) == list(roofline.MIXER_SHAPED)


def test_roofline_variant_names_match_exactly(capsys):
    """``chain-copy`` must not also select ``copy``; unknown names select
    nothing."""
    assert roofline.main(SMALL + ["--variants", "chain-copy,mix,copy-v,xla-xor"]) == 0
    res, _ = _json_line(capsys)
    assert list(res) == ["chain-copy"]


def test_probe_chain_precision_emits_every_asked_variant(capsys):
    assert probe_chain_precision.main(SMALL) == 0
    res, err = _json_line(capsys)
    assert list(res) == list(probe_chain_precision.VARIANTS)
    assert all(set(v) == {"gsps", "ms"} and v["ms"] > 0 for v in res.values())
    assert "iter 1 mix-fold" in err                  # interleaved rounds
    assert probe_chain_precision.main(SMALL + ["--variants", "mix-fold,default"]) == 0
    res, _ = _json_line(capsys)
    assert list(res) == ["mix-fold"]


def test_probe_cascade_precision_emits_every_asked_variant(capsys):
    assert probe_cascade_precision.main(SMALL) == 0
    res, err = _json_line(capsys)
    assert list(res) == list(probe_cascade_precision.VARIANTS) == ["exact", "fast", "def"]
    assert all(set(v) == {"gsps", "ms"} and v["ms"] > 0 for v in res.values())
    assert "iter 1 def" in err and "1/8(T=65) -> 3/8(T=51)" in err
    assert probe_cascade_precision.main(SMALL + ["--variants", "fast,split3"]) == 0
    res, _ = _json_line(capsys)
    assert list(res) == ["fast"]


def test_probe_split_tail_emits_both_variants_and_the_share(capsys):
    assert probe_split_tail.main(SMALL) == 0
    res, err = _json_line(capsys)
    assert set(res) == {"full_gsps", "front_gsps", "full_ms", "front_ms",
                        "tail_share"}
    assert res["tail_share"] == pytest.approx(1.0 - res["front_ms"] / res["full_ms"])
    assert "384/3125(T=163)" in err and "iter 1 front" in err
    assert probe_split_tail.main(SMALL + ["--variants", "front"]) == 0
    res, _ = _json_line(capsys)
    assert set(res) == {"front_gsps", "front_ms"}


@pytest.mark.parametrize("tool", [roofline, probe_chain_precision,
                                  probe_cascade_precision, probe_split_tail,
                                  conformance])
def test_tools_fail_without_a_card_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("only a machine without a card can show this")
    with pytest.raises(RuntimeError):
        tool.main([] if tool is conformance else ["--samples", "4096"])


@pytest.fixture(scope="module")
def conformance_run():
    """One run of the harness on the CPU (≈ 1 min: five CLI subprocesses and
    their goldens), shared by the cases below."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = conformance.main(["--device", "cpu"])
    (line,) = out.getvalue().strip().splitlines()
    return rc, json.loads(line), err.getvalue().splitlines()


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_conformance_config_passes_on_the_cpu(config, conformance_run):
    rc, res, err = conformance_run
    assert len(res["configs"]) == 5 and len(err) == 5
    entry = res["configs"][config - 1]
    assert entry["ok"] and entry["snr_db"] > 60.0
    assert err[config - 1].startswith("PASS")
    assert rc == 0 and res["conformance"] == "pass"


def test_jax_roofline_tool_still_runs_its_probe_kernels():
    """The JAX tool whose kernels the probes replace, as a smoke on the CPU
    (it prints times only, nothing to compare)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "roofline.py"),
         "--platform", "cpu", "--samples", "16384", "--dispatches", "1",
         "--iters", "1", "--variants", "copy,codec,chain-copy,chain-mix"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert set(json.loads(proc.stdout.strip().splitlines()[-1])) == {
        "copy", "codec", "chain-copy", "chain-mix"}


def test_no_module_of_the_port_imports_jax():
    """Walks the package in a fresh interpreter (this process has jax
    already): after importing every module, neither jax nor the JAX package
    is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import doppler_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'doppler_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "print('\\n'.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    walked = proc.stdout.split()
    for name in ("doppler_tpu_torch.tools.bench",
                 "doppler_tpu_torch.tools.roofline",
                 "doppler_tpu_torch.tools.probe_chain_precision",
                 "doppler_tpu_torch.tools.probe_cascade_precision",
                 "doppler_tpu_torch.tools.probe_split_tail",
                 "doppler_tpu_torch.tools.conformance",
                 "doppler_tpu_torch.ops.cuda.probes",
                 "doppler_tpu_torch.runtime.timing",
                 "doppler_tpu_torch.__main__"):
        assert name in walked
