"""The benchmark's ``sat16-track`` configuration (BASELINE config 4: 16
TLE-tracked satellites out of one 1.024 Msps capture) on the CPU at a small
size: its files agree with each other and with the program, a run of its
cell is correct against the plain reference, planted faults are not, and
the program's track counters are what the staircase gives.

A run of the cell drives its own copy of the configuration from a
temporary benchmark root: 4 of the 16 channels (k = 0, 5, 10, 15), a
capture of 2^17 samples, chunks of 8 blocks.
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import numpy as np
import pytest

from benchmark import drive as bench_drive
from benchmark.cell import HERE, load_cell
from benchmark.check import check_outputs, stages_of
from benchmark.reference import orbit as ref_orbit
from benchmark.reference.schedule import channel_ratios

CONFIG = HERE / "configs" / "sat16-track.json"
TLE = HERE / "configs" / "sat16-track.tle"
KEEP = (0, 5, 10, 15)
B = 8                          # --chunk-blocks of the copy


@pytest.fixture(autouse=True)
def fresh_logger():
    # the CLI binds its stderr handler to the stream it first sees
    logging.getLogger("doppler_tpu_torch").handlers.clear()
    yield
    logging.getLogger("doppler_tpu_torch").handlers.clear()


def _config() -> dict:
    return json.loads(CONFIG.read_text())


def _tle_entries() -> dict:
    lines = [ln.rstrip("\n") for ln in TLE.read_text().splitlines()]
    assert len(lines) % 3 == 0
    return {lines[i]: (lines[i + 1], lines[i + 2])
            for i in range(0, len(lines), 3)}


def _small_root(dest, mutate=None):
    """``dest/benchmark`` with the sat16 cell cut to the CPU's size; its
    channel entries name the copied TLE file by its absolute path."""
    root = dest / "benchmark"
    (root / "configs").mkdir(parents=True)
    shutil.copytree(HERE / "traffic", root / "traffic")
    shutil.copytree(HERE / "metrics", root / "metrics")
    shutil.copy(HERE.parent / "BENCHMARK.json", dest / "BENCHMARK.json")
    tle = root / "configs" / "sat16-track.tle"
    shutil.copy(TLE, tle)
    cfg = _config()
    cfg["channels"] = [dict(cfg["channels"][k], tlefile=str(tle))
                       for k in KEEP]
    cfg["capture"]["samples"] = 1 << 17
    cfg["argv"] += ["--chunk-blocks", str(B)]
    cfg["warm_samples"] = B * 2048 * 2 + 1000
    cfg["check"].update(channels=len(KEEP), regions=4, region_outputs=256)
    if mutate is not None:
        mutate(cfg)
    (root / "configs" / "sat16-track.json").write_text(json.dumps(cfg))
    return root


def _drive(root, tmp_path, seconds=1.2, seed=3000000019):
    cell = load_cell("sat16-track.replay", root=root)
    work = tmp_path / "work"
    work.mkdir()
    run = bench_drive.drive(cell, seed, seconds, False, "cpu", 0.0,
                            str(work))
    res = check_outputs(cell.config, run.capture, run.n_in, run.outputs,
                        seed, "cpu")
    limits = cell.config["check"]["limits"]
    failing = sorted(k for k, v in res["numbers"].items() if not v <= limits[k])
    return run, res, failing


def test_every_entry_names_the_same_satellite_in_both_forms():
    cfg = _config()
    tles = _tle_entries()
    assert len(cfg["channels"]) == 16 and len(tles) == 16
    names = set()
    for k, ch in enumerate(cfg["channels"]):
        tr = ch["track"]
        assert ch["name"] == f"sat{k:02d}"
        assert ch["center_offset"] == -480000.0 + 64000.0 * k
        assert ch["frequency"] == tr["frequency"] == 436500000.0 + ch[
            "center_offset"]
        assert ch["offset"] == tr["offset"] == 0.0
        assert ch["tlefile"] == "benchmark/configs/sat16-track.tle"
        assert ch["tlename"] == tr["name"]
        assert tuple(tr["tle"]) == tles[ch["tlename"]]
        assert ch["time"] == tr["time"]
        loc = dict(kv.split("=") for kv in ch["location"].split(","))
        assert {k2: float(v) for k2, v in loc.items()} == tr["location"]
        names.add(ch["tlename"])
    assert len(names) == 16


def test_every_tle_line_holds_its_checksum_and_the_train_offsets():
    from doppler_tpu_torch.orbit import Tle

    for k, (name, (l1, l2)) in enumerate(sorted(_tle_entries().items())):
        for line in (l1, l2):
            assert len(line) == 69
            assert int(line[68]) == ref_orbit.checksum(line)
        assert l1[2:7] == l2[2:7] == str(88900 + k)
        assert float(l2[43:51]) == pytest.approx(110.5714 + (k - 8), abs=1e-9)
        assert Tle.from_file(name, str(TLE)).name == name


def test_the_harness_stages_are_the_programs_fused_cascade():
    from doppler_tpu_torch.ops.cuda import cascade
    from doppler_tpu_torch.ops.multistage import make_resampler

    cfg = _config()
    rs = make_resampler(cfg["samplerate"], cfg["resample_to"],
                        stages=cfg["resample_stages"], channels=16,
                        device="cpu")
    want = [(st.P, st.Q, st.T) for st in rs.stages]
    assert [(s.P, s.Q, s.T) for s in stages_of(cfg)] == want
    assert want == [(1, 8, 65), (3, 8, 51)]
    assert cascade.split_point(rs.stages) == len(want)   # all fused


def _staircase_counts(channels, n_in, fs, L, B=B):
    """``(track_evals, track_steps)`` the staircase gives for ``n_in``
    samples in chunks of ``B`` blocks of ``L``: the unique evaluation
    seconds of each chunk's blocks, and the chunks inside which a channel's
    float32 shift changes (from the reference's own segments)."""
    n_blocks = -(-n_in // L)
    k = np.arange(n_blocks, dtype=np.int64)
    dt = ((np.maximum(k - 1, 0) * L).astype(np.float32)
          / np.float32(fs)).astype(np.int64)
    evals = sum(len(np.unique(dt[j:j + B])) for j in range(0, n_blocks, B))
    steps = 0
    for ch in channels:
        starts = [s for s, _, _ in channel_ratios(ch, n_in, fs, L)][1:]
        steps += len({s // (B * L) for s in starts if s % (B * L)})
    return evals * len(channels), steps


def test_the_schedulers_count_the_instants_they_propagate():
    from doppler_tpu_torch.cli import parse_time_utc
    from doppler_tpu_torch.orbit import (Observer, Predictor,
                                         RealtimeTrackScheduler, Tle,
                                         TrackScheduler)

    ch = _config()["channels"][0]
    pred = Predictor(Tle.from_file(ch["tlename"], str(TLE)),
                     Observer(58.26541, 26.46667, 76.0))
    fs, L = 1024000, 2048
    rec = TrackScheduler(pred, ch["frequency"], 0.0, fs,
                         parse_time_utc(ch["time"]), telemetry=False)
    assert rec.last_evals == 0
    rec.shifts([L] * 400)               # blocks 0..399: seconds 0
    assert rec.last_evals == 1
    rec.shifts([L] * 400)               # blocks 400..799: seconds 0, 1
    assert rec.last_evals == 2
    rec.shifts([])
    assert rec.last_evals == 0
    live = RealtimeTrackScheduler(pred, ch["frequency"], 0.0, fs,
                                  telemetry=False, clock=lambda: 3.4e8)
    live.shifts([L] * 32)               # one instant a block
    assert live.last_evals == 32


def test_a_run_is_correct_and_counts_the_staircase(tmp_path):
    from doppler_tpu_torch.runtime import telemetry

    run, res, failing = _drive(_small_root(tmp_path), tmp_path)
    assert failing == [] and res["failed"] == 0
    assert len(run.outputs) == len(KEEP)
    cfg = run.cell.config
    rec = telemetry.last_spans()
    evals, steps = _staircase_counts(cfg["channels"], run.n_in,
                                     cfg["samplerate"], 2048)
    assert rec.counters["track_evals"] == evals > 0
    assert rec.counters["track_steps"] == steps
    # every stepping channel-chunk went to the lanes a segment at a time;
    # only the genesis chunk went to plan_blocks
    assert rec.counters["chan_plans_split"] == steps
    assert rec.counters["chan_plans_per_channel"] == len(KEEP)


def test_the_planner_counts_and_plans_sixteen_staircases_bitwise(tmp_path):
    """All 16 channels over 4 chunks of 256 blocks (2.05 s of stream): the
    chunks in which the staircase steps go to the lanes in two segments,
    cut at the step, the others to a lane whole, and every word and state
    is what one ``plan_blocks`` a channel over the same shifts gives; the
    counters are the staircase's."""
    from doppler_tpu_torch.ops import phase_plan
    from doppler_tpu_torch.runtime.channels import (MultiChannelPipeline,
                                                    load_channel_config)

    cfg = _config()
    chans = [dict(ch, tlefile=str(TLE)) for ch in cfg["channels"]]
    (tmp_path / "c.json").write_text(json.dumps({"channels": chans}))
    fs, L, Bk = cfg["samplerate"], 2048, 256
    specs, _ = load_channel_config(str(tmp_path / "c.json"), fs)
    mirror, _ = load_channel_config(str(tmp_path / "c.json"), fs)
    mp = MultiChannelPipeline(fs, "i16", "i16", specs, chunk_blocks=Bk,
                              device="cpu")
    states = [phase_plan.NCOState() for _ in mirror]
    counts = [L] * Bk
    for k in range(4):
        got = mp._plan_all(counts, k)
        for c, ch in enumerate(mirror):
            shifts = (np.asarray(ch.scheduler.shifts(counts)).astype(
                np.float32) + np.float32(ch.center_offset_hz)).astype(
                    np.float64)
            plan = phase_plan.plan_blocks(shifts, counts, fs, states[c], L)
            want = np.stack([plan.d_hi, plan.d_lo, plan.c1_hi, plan.c1_lo,
                             plan.c2_hi, plan.c2_lo, plan.t])
            assert np.array_equal(got[:, c], want), (k, c)
            assert (mp.channels[c].state.samplenum, mp.channels[c].state
                    .abs_offset) == (states[c].samplenum, states[c].abs_offset)
    n_in = 4 * Bk * L
    evals, steps = _staircase_counts(
        cfg["channels"], n_in, fs, L, Bk)
    c = mp.spans.counters
    assert (c["track_evals"], c["track_steps"]) == (evals, steps)
    assert steps == 2 * 16                 # chunks 1 and 3 step
    # plan_blocks for the genesis chunk alone (the uniform lane refuses
    # m0 = 0); the stepping channel-chunks in the lanes, a segment at a time
    assert c["chan_plans_per_channel"] == 16
    assert c["chan_plans_split"] == steps
    assert sum(c[f"chan_plans_{lane}"] for lane in
               ("periodic", "uniform", "per_channel")) == 4 * 16


def test_a_channel_tracking_another_satellite_is_not_correct(tmp_path):
    def swap(cfg):
        cfg["channels"][1]["tlename"] = cfg["channels"][2]["tlename"]

    _, _, failing = _drive(_small_root(tmp_path, swap), tmp_path)
    assert failing == ["rms_lsb"]


def test_a_truncated_channel_file_is_not_correct(tmp_path, monkeypatch):
    read = bench_drive._read_outputs

    def truncated(config, out_dir, sink):
        path = os.path.join(out_dir, f"{config['channels'][2]['name']}.iq")
        os.truncate(path, os.path.getsize(path) - 4 * 100)
        return read(config, out_dir, sink)

    monkeypatch.setattr(bench_drive, "_read_outputs", truncated)
    _, res, failing = _drive(_small_root(tmp_path), tmp_path)
    assert failing == ["count_gap"] and res["numbers"]["count_gap"] == 100
