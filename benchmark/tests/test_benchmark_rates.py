"""Channels that each keep their own output rate, on the CPU at a small size.

- The check of a configuration with one rate reads as it did before
  channels could carry their own: a frozen copy of the earlier
  ``stages_of`` / ``pick_regions`` / ``check_outputs`` gives the same regions
  and numbers on synthetic outputs of the three measured configurations.
- A four-channel capture at 1.024 Msps, two channels at 48 ksps and two at
  96 ksps by their own ``resample_to``, run through :func:`benchmark.drive`
  (the program's unfused route: the channel mixer into float32 planes, one
  batched resampler a rate group), is correct; each planted fault is not.
- The two roofline readers read nothing from such a run, and a channel left
  with no rate is an error that names it.

The small configuration's ``rms_lsb`` limit is 0.2, the wideband
configuration's: the program reads 0 to 0.016 here (the plain versions on
the CPU), and 3 LSB on every 7th value of one channel of the four reads
0.567 over the four.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import drive as bench_drive
from benchmark.capture import make_capture
from benchmark.cell import HERE, load_cell, load_metric_reader
from benchmark.check import (channel_rates, channel_stages, check_outputs,
                             pick_regions, stages_of)
from benchmark.control import control_numbers
from benchmark.reference.design import design_stages
from benchmark.reference.nco import counter_segments
from benchmark.reference.schedule import channel_ratios, expand_channels
from benchmark.reference.stream import due_count, encode_i16, region
from benchmark.trace import Stretch

B = 8                          # --chunk-blocks of the mixed-rate copy


# -- a frozen copy of the check as it was when every channel shared one rate


def _old_stages_of(config: dict) -> list:
    return design_stages(config["samplerate"], float(config["resample_to"]),
                         config.get("resample_stages", "auto"),
                         config.get("atten_db", 70.0))


def _old_pick_regions(seed: int, n_channels: int, due: int,
                      check: dict) -> dict:
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    want = min(n_channels, int(check.get("channels", n_channels)))
    base = sorted({0, n_channels // 2, n_channels - 1})[:want]
    rest = [c for c in range(n_channels) if c not in base]
    k = min(len(rest), want - len(base))
    extra = rng.choice(rest, size=k, replace=False).tolist() if k > 0 else []
    chans = sorted(set(base) | set(extra))
    size = min(int(check["region_outputs"]), due)
    out = {}
    for c in chans:
        starts = {0, due - size}
        extra = max(0, int(check["regions"]) - 2)
        if due > size and extra:
            starts |= set(rng.integers(0, due - size, size=extra).tolist())
        out[c] = [(s, s + size) for s in sorted(starts) if size > 0]
    return out


def _old_check_outputs(config: dict, capture: np.ndarray, n_in: int,
                       outputs: list, seed: int, device,
                       dtype=torch.float64) -> dict:
    dev = torch.device(device)
    stages = _old_stages_of(config)
    channels = expand_channels(config)
    fs = int(config["samplerate"])
    block = int(config["block_bytes"]) // 4
    due = due_count(n_in, stages)
    written = ([len(o) for o in outputs] if outputs is not None
               else [due] * len(channels))
    gap = int(sum(abs(w - due) for w in written))
    cap = torch.from_numpy(np.ascontiguousarray(capture)).to(dev)
    sumsq, count = 0.0, 0
    for c, regions in _old_pick_regions(seed, len(channels),
                                        min(due, *written),
                                        config["check"]).items():
        segs = counter_segments(
            channel_ratios(channels[c], n_in, fs, block), dev)
        for lo, hi in regions:
            want = encode_i16(*region(cap, segs, stages, lo, hi))
            if outputs is None:
                got = encode_i16(*region(cap, segs, stages, lo, hi, dtype))
            else:
                got = np.asarray(outputs[c][lo:hi], dtype=np.int64)
            d = (got - want).astype(np.float64)
            sumsq += float(np.sum(d * d))
            count += d.size
    rms = math.sqrt(sumsq / count) if count else float("inf")
    return {"numbers": {"count_gap": gap, "rms_lsb": rms},
            "attempted": due * len(channels), "failed": gap,
            "compared": count // 2}


# -- (a) the three measured configurations read as before


def _small(name: str) -> dict:
    """The configuration ``name``, its capture and check cut to the CPU."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["capture"]["samples"] = 1 << 15
    cfg["check"].update(channels=min(4, cfg["check"]["channels"]),
                        regions=3, region_outputs=64)
    return cfg


CONFIGS = ["estcube-track", "wideband-256ch", "sat16-track"]
N_IN = {"estcube-track": (1_000_003, 2_500_000),
        "wideband-256ch": (2_200_000, 3_000_017),
        "sat16-track": (1_000_003, 2_500_000)}


@pytest.mark.parametrize("seed", [1, 4294967311, (1 << 40) + 3])
@pytest.mark.parametrize("n_channels", [1, 3, 16, 256])
@pytest.mark.parametrize("due", [0, 63, 64, 65, 5000])
def test_one_rate_draws_the_same_regions(seed, n_channels, due):
    check = {"channels": 16, "regions": 6, "region_outputs": 64}
    assert pick_regions(seed, [due] * n_channels, check) == \
        _old_pick_regions(seed, n_channels, due, check)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("seed", [7, 3000000019])
@pytest.mark.parametrize("name", CONFIGS)
def test_one_rate_reads_as_before(name, seed, k):
    cfg = _small(name)
    n_in = N_IN[name][k]
    want = stages_of(cfg)
    for got in channel_stages(cfg):
        assert [(s.P, s.Q, s.T) for s in got] == [(s.P, s.Q, s.T)
                                                  for s in want]
        assert all(np.array_equal(a.bank, b.bank) for a, b in zip(got, want))
    capture = make_capture(cfg, seed, "cpu").numpy()
    due = due_count(n_in, stages_of(cfg))
    rng = np.random.default_rng(seed)
    outputs = [rng.integers(-300, 300, size=(due, 2)).astype(np.int16)
               for _ in expand_channels(cfg)]
    outputs[-1] = outputs[-1][:due - 100]          # one channel 100 short
    got = check_outputs(cfg, capture, n_in, outputs, seed, "cpu")
    assert got == _old_check_outputs(cfg, capture, n_in, outputs, seed, "cpu")
    assert got["numbers"]["count_gap"] == 100 and got["compared"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_the_control_reads_as_before(name):
    cfg = _small(name)
    capture = make_capture(cfg, 11, "cpu").numpy()
    n_in = N_IN[name][0]
    got = control_numbers(cfg, 11, n_in, "cpu")
    assert got == _old_check_outputs(cfg, capture, n_in, None, 11, "cpu",
                                     dtype=torch.bfloat16)["numbers"]


# -- (b) to (d): a capture whose channels keep two rates


MIXED = {
    "name": "mixed-rate",
    "mode": "channels",
    "samplerate": 1024000,
    "block_bytes": 8192,
    "resample_to": 48000,
    "resample_stages": "auto",
    "atten_db": 70.0,
    "argv": ["channels", "-s", "1024000", "-i", "i16", "--config",
             "{channels}", "--output-dir", "{output_dir}", "--resample-to",
             "48000", "--block-bytes", "{block_bytes}", "--chunk-blocks",
             str(B)],
    # n0 takes the configuration's rate, the others their own
    "channels": [{"name": "n0", "shift": -384000.0},
                 {"name": "w1", "shift": -128000.0, "resample_to": 96000},
                 {"name": "n2", "shift": 128000.0, "resample_to": 48000},
                 {"name": "w3", "shift": 384000.0, "resample_to": 96000}],
    "capture": {"samples": 1 << 17, "tones_per_channel": 2,
                "tone_amplitude": 0.02, "tone_band_hz": [-12000.0, 12000.0],
                "noise_rms": 0.03},
    "warm_samples": B * 2048 * 2 + 1000,
    "check": {"channels": 4, "regions": 4, "region_outputs": 256,
              "limits": {"count_gap": 0, "rms_lsb": 0.2}},
}
WIDE = 1                       # a 96 ksps channel


@pytest.fixture(autouse=True)
def fresh_logger():
    # the CLI binds its stderr handler to the stream it first sees
    logging.getLogger("doppler_tpu_torch").handlers.clear()
    yield
    logging.getLogger("doppler_tpu_torch").handlers.clear()


@pytest.fixture(scope="module")
def mixed_root(tmp_path_factory):
    dest = tmp_path_factory.mktemp("mixed")
    root = dest / "benchmark"
    (root / "configs").mkdir(parents=True)
    shutil.copytree(HERE / "traffic", root / "traffic")
    shutil.copytree(HERE / "metrics", root / "metrics")
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mixed-rate.replay",
                              "config": "mixed-rate", "traffic": "replay",
                              "chips": 1, "why": "channels at two rates"})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "configs" / "mixed-rate.json").write_text(json.dumps(MIXED))
    return root


def _drive(root, tmp_path, seed=3000000019, config=None):
    cell = load_cell("mixed-rate.replay", root=root)
    work = tmp_path / "work"
    work.mkdir()
    run = bench_drive.drive(cell, seed, 1.2, False, "cpu", 0.0, str(work))
    res = check_outputs(config or cell.config, run.capture, run.n_in,
                        run.outputs, seed, "cpu")
    limits = cell.config["check"]["limits"]
    failing = sorted(k for k, v in res["numbers"].items() if not v <= limits[k])
    return run, res, failing


def test_each_channel_keeps_its_own_rate():
    assert channel_rates(MIXED) == [48000.0, 96000.0, 48000.0, 96000.0]
    st = channel_stages(MIXED)
    assert [(s.P, s.Q, s.T) for s in st[0]] == [(1, 8, 65), (3, 8, 51)]
    assert [(s.P, s.Q, s.T) for s in st[1]] == [(1, 4, 31), (3, 8, 51)]
    assert st[0] is st[2] and st[1] is st[3]


def test_a_run_at_two_rates_is_correct(mixed_root, tmp_path):
    run, res, failing = _drive(mixed_root, tmp_path)
    assert failing == [] and res["failed"] == 0
    n = [len(o) for o in run.outputs]
    assert n[1] == n[3] == 2 * n[0] == 2 * n[2] > 0
    assert res["attempted"] == sum(n) and res["compared"] == 4 * 4 * 256


def test_the_bfloat16_control_fails_the_limit_at_two_rates():
    nums = control_numbers(MIXED, 12345, 2_000_000, "cpu")
    assert nums["count_gap"] == 0
    assert nums["rms_lsb"] > MIXED["check"]["limits"]["rms_lsb"]


def _read_then(alter):
    read = bench_drive._read_outputs

    def reader(config, out_dir, sink):
        alter(config, out_dir)
        return read(config, out_dir, sink)
    return reader


def test_a_wide_channel_cut_short_is_not_correct(mixed_root, tmp_path,
                                                 monkeypatch):
    def cut(config, out_dir):
        path = os.path.join(out_dir, f"{config['channels'][WIDE]['name']}.iq")
        os.truncate(path, os.path.getsize(path) - 4 * 100)

    monkeypatch.setattr(bench_drive, "_read_outputs", _read_then(cut))
    _, res, failing = _drive(mixed_root, tmp_path)
    assert failing == ["count_gap"] and res["numbers"]["count_gap"] == 100


def test_a_wide_channel_altered_is_not_correct(mixed_root, tmp_path,
                                               monkeypatch):
    def alter(config, out_dir):
        path = os.path.join(out_dir, f"{config['channels'][WIDE]['name']}.iq")
        words = np.fromfile(path, dtype="<i2")
        words[::7] += 3
        words.tofile(path)

    monkeypatch.setattr(bench_drive, "_read_outputs", _read_then(alter))
    _, res, failing = _drive(mixed_root, tmp_path)
    assert failing == ["rms_lsb"] and res["numbers"]["count_gap"] == 0


def test_a_wide_channel_held_to_the_narrow_rate_is_not_correct(mixed_root,
                                                               tmp_path):
    wrong = copy.deepcopy(MIXED)
    wrong["channels"][WIDE]["resample_to"] = 48000
    run, res, failing = _drive(mixed_root, tmp_path, config=wrong)
    assert failing == ["count_gap", "rms_lsb"]
    assert res["numbers"]["count_gap"] == len(run.outputs[WIDE]) // 2


def test_the_rooflines_read_nothing_at_two_rates(mixed_root, tmp_path):
    run, _, _ = _drive(mixed_root, tmp_path)
    L = MIXED["block_bytes"] // 4
    front, tail = ("cascade_kernel<true>", 0.1, 0.2), ("window_kernel", 0.3,
                                                       0.4)
    routes = {"split_roofline": [front, tail],
              "channel_cascade_roofline": [front]}
    one_rate = copy.deepcopy(MIXED)
    for ch in one_rate["channels"]:
        ch.pop("resample_to", None)
    for name, events in routes.items():
        read = load_metric_reader(name, mixed_root)
        stretch = Stretch(t_start=0.0, t_end=1.0, events=events,
                          launches={"cascade_channels": 1},
                          bytes_in=4 * B * L, complete=True)
        assert read(SimpleNamespace(stretch=stretch, cell=run.cell,
                                    outputs=run.outputs)) is None
        # the same stretch at one rate reads a share
        single = read(SimpleNamespace(stretch=stretch,
                                      cell=SimpleNamespace(config=one_rate),
                                      outputs=run.outputs))
        assert single is not None and single > 0


def test_a_channel_with_no_rate_is_named():
    cfg = copy.deepcopy(MIXED)
    del cfg["resample_to"]
    with pytest.raises(ValueError, match="'n0'"):
        channel_rates(cfg)
    with pytest.raises(ValueError, match="'n0'"):
        channel_stages(cfg)
