"""Whole runs of the harness on the CPU at a small size (the kernels' plain
versions stand in for the card): the result line, cells found by name, the
faults that must read as not correct, and the control."""

from __future__ import annotations

import json
import logging
import shutil

import pytest
import torch

from benchmark import run as bench_run
from benchmark.cell import load_cell, load_metric_reader
from benchmark.control import control_numbers

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks"}


@pytest.fixture(autouse=True)
def fresh_logger():
    # the CLI binds its stderr handler to the stream it first sees
    logging.getLogger("doppler_tpu_torch").handlers.clear()
    yield
    logging.getLogger("doppler_tpu_torch").handlers.clear()


def _run(root, capsys, workload, seconds=1.5, seed=4294967311):
    rc = bench_run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        device="cpu", root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", ["estcube-track.replay",
                                      "wideband-256ch.replay",
                                      "estcube-track.live"])
def test_a_sound_run_is_correct_with_only_the_result_keys(
        tiny_root, capsys, workload):
    line = _run(tiny_root, capsys, workload)
    assert set(line) <= LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    cell = load_cell(workload, root=tiny_root)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path, tiny_root,
                                                       capsys):
    root = tmp_path / "benchmark"
    shutil.copytree(tiny_root, root)
    shutil.copy(tiny_root.parent / "BENCHMARK.json",
                tmp_path / "BENCHMARK.json")
    cfg = json.loads((root / "configs" / "estcube-track.json").read_text())
    cfg["name"] = "estcube-offset"
    cfg["channels"][0]["track"]["offset"] = -3000.0
    (root / "configs" / "estcube-offset.json").write_text(json.dumps(cfg))
    (root / "traffic" / "replay-again.json").write_text('{"loop": "closed"}')
    (root / "metrics" / "outputs_written.py").write_text(
        "def read(run):\n    return float(len(run.outputs[0]))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "estcube-offset.replay-again",
                              "config": "estcube-offset",
                              "traffic": "replay-again", "chips": 1,
                              "why": "a cell added by files alone"})
    spec["end_to_end"].append({"name": "outputs_written", "unit": "samples",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["estcube-offset.replay-again"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("estcube-offset.replay-again", root=root)
    assert cell.config["name"] == "estcube-offset"
    assert load_metric_reader("outputs_written", root) is not None
    line = _run(root, capsys, "estcube-offset.replay-again")
    assert line["correct"] is True
    assert line["metrics"]["outputs_written"]["value"] > 0
    # input_msps lists its cells: the new one is not among them
    assert set(line["metrics"]) == {"outputs_written", "setup_s"}


def _alter(data: bytes, step: int) -> bytes:
    import numpy as np

    words = np.frombuffer(data, dtype="<i2").copy()
    words[::step] += 3
    return words.tobytes()


FAULTS = {
    # an answer altered where it is produced: 3 LSB on every 7th value
    "altered": ("Pipeline._stage_out",
                lambda f: lambda self, hosts: _alter(f(self, hosts), 7)),
    # half of each chunk's outputs left out
    "half": ("Pipeline._stage_out",
             lambda f: lambda self, hosts: (lambda b: b[:len(b) // 8 * 4])(
                 f(self, hosts))),
    # a step that leaves its state unchanged: every chunk plans from the
    # NCO state the stream had before it
    "state": ("plan_blocks",
              lambda f: lambda shifts, counts, fs, state, *a, **k: f(
                  shifts, counts, fs, type(state)(state.samplenum,
                                                  state.abs_offset),
                  *a, **k)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                           fault):
    from doppler_tpu_torch.runtime import pipeline

    where, wrap = FAULTS[fault]
    if "." in where:
        cls, name = where.split(".")
        target = getattr(pipeline, cls)
    else:
        target, name = pipeline, where
    monkeypatch.setattr(target, name, wrap(getattr(target, name)))
    line = _run(tiny_root, capsys, "estcube-track.replay")
    assert line["correct"] is False
    failing = [k for k, c in line["checks"].items()
               if not c["value"] <= c["limit"]]
    if fault == "half":
        assert "count_gap" in failing
    else:
        assert failing == ["rms_lsb"]


def _channels_fault(kind):
    """Wrap ``MultiChannelPipeline._start_out``'s finalizer: every channel's
    values altered, or the second half of the channels' outputs left out."""
    def wrap(f):
        def start_out(self, parts, starts):
            fin = f(self, parts, starts)

            def finalize():
                outs = fin()
                if kind == "altered":
                    return [_alter(o, 7) if o else o for o in outs]
                half = len(outs) // 2
                return outs[:half] + [b""] * (len(outs) - half)
            return finalize
        return start_out
    return wrap


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_channel_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                              fault):
    from doppler_tpu_torch.runtime.channels import MultiChannelPipeline

    monkeypatch.setattr(MultiChannelPipeline, "_start_out", _channels_fault(
        fault)(MultiChannelPipeline._start_out))
    line = _run(tiny_root, capsys, "wideband-256ch.replay")
    assert line["correct"] is False
    failing = [k for k, c in line["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing == (["count_gap", "rms_lsb"] if fault == "half"
                       else ["rms_lsb"])


@pytest.mark.parametrize("workload", ["estcube-track.replay",
                                      "wideband-256ch.replay"])
def test_the_bfloat16_control_fails_the_limit(tiny_root, workload):
    cell = load_cell(workload, root=tiny_root)
    nums = control_numbers(cell.config, 12345, 2_000_000, "cpu")
    assert nums["count_gap"] == 0
    assert nums["rms_lsb"] > cell.config["check"]["limits"]["rms_lsb"]


@pytest.mark.cuda
def test_a_live_run_on_the_card_is_correct(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = _run_card(capsys)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def _run_card(capsys):
    rc = bench_run.main(["--workload", "estcube-track.live", "--seed", "7",
                         "--seconds", "2", "--trace", "1"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
