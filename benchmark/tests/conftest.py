"""Fixtures of the benchmark's CPU tests: a benchmark folder with the
real cells' files cut to a size the CPU runs in seconds (the capture, the
chunk, the channel count), and the real metric readers.

Its ``BENCHMARK.json`` adds one cell that the real one does not time:
``estcube-track.replay``, config 3 replayed as fast as read, whose rate is
set by the host's speed and spreads wider than any bound allows.  The tests
drive it all the same, since it is the quickest run of the stream path
(track, cascade, encode) that the faults below are planted in."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark.cell import HERE


def write_tiny_root(dest: Path) -> Path:
    """``dest/benchmark`` (returned) with configs, traffic and readers, and
    ``dest/BENCHMARK.json``: the real cells at a small size."""
    root = dest / "benchmark"
    (root / "configs").mkdir(parents=True)
    shutil.copytree(HERE / "traffic", root / "traffic")
    shutil.copytree(HERE / "metrics", root / "metrics")
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "estcube-track.replay",
                              "config": "estcube-track", "traffic": "replay",
                              "chips": 1,
                              "why": "config 3 replayed: the stream path"})
    for m in spec["end_to_end"]:
        if m["name"] == "input_msps":
            m["workloads"].append("estcube-track.replay")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    est = json.loads((HERE / "configs" / "estcube-track.json").read_text())
    est["capture"]["samples"] = 1 << 16
    est["argv"] += ["--chunk-blocks", "8"]
    est["warm_samples"] = 8 * 2048 * 2 + 1000
    est["check"].update(regions=6, region_outputs=256)
    wide = json.loads((HERE / "configs" / "wideband-256ch.json").read_text())
    wide["capture"]["samples"] = 1 << 18
    wide["channels"]["grid"].update(count=4, spacing_hz=390625.0 * 64,
                                    first_hz=-390625.0 * 96)
    wide["argv"] += ["--chunk-blocks", "16"]
    wide["warm_samples"] = 16 * 2048 * 2 + 1000
    wide["check"].update(regions=3, region_outputs=64)
    for cfg in (est, wide):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return write_tiny_root(tmp_path_factory.mktemp("tiny"))
