"""The JAX CLI's implementation flags in the port's CLI, one test per flag
and mapping: ``--impl``, ``--resample-impl`` and ``--platform``.

Mappings: ``--impl auto|pallas`` → ``Pipeline(impl='pallas')`` (the fused
kernels where the gates take a chunk), ``--impl xla`` →
``Pipeline(impl='xla')`` (the mixer kernel and the resampler on every
chunk; the same bytes); ``--resample-impl`` → the resampler's ``impl``
(``auto`` is ``window`` in the port; channels mode ignores the flag, as the
JAX CLI does); ``--platform cpu`` → ``--device cpu``, ``default`` →
``--device``, ``tpu`` and ``cpu`` beside ``--device cuda`` → exit 2.  The
``conv`` bytes are held to the JAX CLI's ``--impl xla --resample-impl
conv`` within 1 LSB in under 1% of samples.
"""

import io
import logging

import numpy as np
import pytest
import torch

from doppler_tpu import cli as jcli
from doppler_tpu_torch import cli
from doppler_tpu_torch.runtime import channels as channels_mod
from doppler_tpu_torch.runtime import pipeline as pipeline_mod

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
CONST = ["const", "-s", str(FS), "-i", "i16", "--shift", "-15000",
         "--resample-to", "48000", "--chunk-blocks", "8", "--log-level", "error"]


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(21)
    return rng.integers(-9000, 9000, size=2 * (2048 * 8 * 2 + 777),
                        dtype=np.int16).tobytes()


@pytest.fixture
def spy(monkeypatch):
    """The pipelines and resamplers the CLI builds, by class name."""
    made = {}
    for mod, name in ((pipeline_mod, "Pipeline"),
                      (channels_mod, "MultiChannelPipeline")):
        cls = getattr(mod, name)

        def make(*a, _cls=cls, _name=name, **kw):
            made[_name] = _cls(*a, **kw)
            return made[_name]
        monkeypatch.setattr(mod, name, make)
    return made


def _run(argv, raw):
    out = io.BytesIO()
    rc = cli.main(argv, stdin=io.BytesIO(raw), stdout=out)
    return rc, out.getvalue()


@pytest.mark.parametrize("flag,want", [([], "pallas"), (["--impl", "auto"], "pallas"),
                                       (["--impl", "pallas"], "pallas"),
                                       (["--impl", "xla"], "xla")])
def test_impl_flag_maps_to_the_pipeline_impl(spy, raw, flag, want):
    rc, _ = _run(CONST + ["--device", "cpu"] + flag, raw)
    assert rc == 0 and spy["Pipeline"].impl == want


@pytest.mark.parametrize("stages", ["single", "auto"])
def test_impl_xla_gives_the_fused_route_bytes(raw, stages):
    """The unfused route (mixer + window resampler every chunk) and the
    fused chain / cascade route compute the same bytes."""
    argv = CONST + ["--device", "cpu", "--resample-stages", stages]
    rc_p, fused = _run(argv + ["--impl", "pallas"], raw)
    rc_x, unfused = _run(argv + ["--impl", "xla"], raw)
    assert rc_p == rc_x == 0 and fused == unfused and fused


@pytest.mark.parametrize("flag,want", [([], "window"),
                                       (["--resample-impl", "auto"], "window"),
                                       (["--resample-impl", "window"], "window"),
                                       (["--resample-impl", "conv"], "conv")])
def test_resample_impl_flag_maps_to_the_resampler(spy, raw, flag, want):
    argv = CONST + ["--device", "cpu", "--resample-stages", "single"] + flag
    rc, _ = _run(argv, raw)
    assert rc == 0 and spy["Pipeline"].resampler.impl == want
    rc, _ = _run(CONST + ["--device", "cpu"] + flag, raw)      # the cascade
    assert rc == 0 and {st.impl for st in spy["Pipeline"].resampler.stages} == {want}


@pytest.mark.parametrize("stages", ["single", "auto"])
def test_resample_impl_conv_against_the_jax_cli(raw, stages):
    """``--impl xla --resample-impl conv``: the port's CLI against the JAX
    CLI's (both on the CPU), ≤ 1 LSB in under 1%."""
    argv = CONST + ["--resample-stages", stages, "--impl", "xla",
                    "--resample-impl", "conv"]
    rc, got = _run(argv + ["--device", "cpu"], raw)
    out = io.BytesIO()
    # the JAX CLI turns off its logger's propagation; restore it, so that a
    # later test in this process still reads its records through caplog
    logger = logging.getLogger("doppler_tpu")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    try:
        jrc = jcli.main(argv + ["--platform", "cpu"], stdin=io.BytesIO(raw),
                        stdout=out)
    finally:
        logger.handlers, logger.propagate = saved[0], saved[1]
        logger.setLevel(saved[2])
    assert jrc == 0 and rc == 0
    a = np.frombuffer(got, "<i2").astype(int)
    b = np.frombuffer(out.getvalue(), "<i2").astype(int)
    assert a.shape == b.shape and a.size > 0
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_platform_cpu_is_device_cpu(spy, raw):
    rc, out = _run(CONST + ["--platform", "cpu"], raw)
    assert rc == 0 and spy["Pipeline"].device == torch.device("cpu")
    assert out == _run(CONST + ["--device", "cpu"], raw)[1]


def test_platform_default_keeps_device(spy, raw, monkeypatch):
    rc, _ = _run(CONST + ["--platform", "default", "--device", "cpu"], raw)
    assert rc == 0 and spy["Pipeline"].device == torch.device("cpu")
    # unset --device stays 'cuda', which fails without a card (rc 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _run(CONST + ["--platform", "default"], raw)[0] == 1


def test_platform_cpu_with_device_cuda_is_a_usage_error(raw, capsys):
    assert _run(CONST + ["--platform", "cpu", "--device", "cuda"], raw) == (2, b"")
    assert "--platform cpu contradicts --device cuda" in capsys.readouterr().err


def test_platform_tpu_is_a_usage_error_naming_device(raw, capsys):
    assert _run(CONST + ["--platform", "tpu"], raw) == (2, b"")
    assert "--device" in capsys.readouterr().err


def test_bad_flag_values_are_usage_errors(raw):
    for flag in (["--impl", "cuda"], ["--resample-impl", "fft"],
                 ["--platform", "gpu"]):
        assert _run(CONST + ["--device", "cpu"] + flag, raw)[0] == 2


def test_flags_reach_channels_mode(spy, raw, tmp_path):
    """``--impl`` reaches ``MultiChannelPipeline``; ``--resample-impl`` is
    accepted and ignored there (the JAX CLI does not pass it either);
    ``--platform cpu`` is ``--device cpu``."""
    (tmp_path / "c.json").write_text(
        '{"channels": [{"name": "a", "shift": -15000}, {"name": "b", "shift": 9000}]}')
    base = ["channels", "-s", str(FS), "-i", "i16", "--config",
            str(tmp_path / "c.json"), "--resample-to", "48000",
            "--resample-stages", "single", "--chunk-blocks", "8",
            "--log-level", "error", "--platform", "cpu"]
    outs = {}
    for impl in ("pallas", "xla"):
        d = tmp_path / impl
        rc = cli.main(base + ["--impl", impl, "--resample-impl", "conv",
                              "--output-dir", str(d)], stdin=io.BytesIO(raw))
        mp = spy["MultiChannelPipeline"]
        assert rc == 0 and mp.impl == impl and mp.device == torch.device("cpu")
        assert mp.resampler.impl == "window"
        outs[impl] = [(d / f"{n}.iq").read_bytes() for n in "ab"]
    assert outs["pallas"] == outs["xla"] and all(outs["xla"])


def test_host_split_flags_parse():
    args = cli.build_parser().parse_args(
        ["const", "-s", "256000", "-i", "i16", "--shift", "1",
         "--prefetch-chunks", "2", "--host-channels", "2", "--distributed",
         "coordinator=h:1,num_processes=2,process_id=0"])
    assert (args.prefetch_chunks, args.host_channels, args.distributed) == (
        2, 2, "coordinator=h:1,num_processes=2,process_id=0")
