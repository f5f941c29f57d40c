"""Times one group of the FIR register tile on a card, apart from the kernels.

``csrc/bench/fir_group.cu`` is a stand-alone program: the inner group of
``csrc/fir.cuh`` at the chain's geometry (4 loads of x, 3 warp-uniform 16-byte
loads of taps, 24 FFMA) with its loads taken away one kind at a time, at 4 to
16 resident warps an SM.  This tool builds it with ``nvcc`` for ``sm_90a``
into a temporary directory, runs it and passes its lines on, each with the
card's name and power limit.  It says what the dot of the chain and cascade
kernels is bound by: the clocks a group takes above the 7.25 of its
instructions are its shared-memory loads.  It measures a card and fails
without one.

    python -m doppler_tpu_torch.tools.fir_group_bench
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from doppler_tpu_torch.ops.cuda import build
from doppler_tpu_torch.runtime.timing import card_label

SOURCE = build.CSRC / "bench" / "fir_group.cu"


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures a card", file=sys.stderr)
        return 1
    label = card_label("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "fir_group"
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-o", str(exe), str(SOURCE)], check=True)
        res = subprocess.run([str(exe)], capture_output=True, text=True)
    for line in res.stdout.splitlines():
        print(f"{line} [{label}]")
    sys.stderr.write(res.stderr)
    return res.returncode


if __name__ == "__main__":
    raise SystemExit(main())
