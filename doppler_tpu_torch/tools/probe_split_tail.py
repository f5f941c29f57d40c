"""What share of a split-cascade chunk the tail stage costs, at the 100 Msps
→ 48 ksps route (one process, interleaved, best of N rounds).

Counterpart of ``tools/probe_split_tail.py``.  The ÷16·÷16 front fused in
``csrc/cascade.cu`` (``mix_cascade_stream(final_dense=True, outtype="f32")``,
float32 planes at 390.625 ksps), then the 384/3125 tail stage as
``runtime/pipeline.py`` runs it: the stage's ``RationalResampler.process``
(on the card the window kernel, ``csrc/window.cu``; on the CPU its plain
version), then the i16 encode.  Variants:

  full   front + tail + encode (the pipeline's split route)
  front  the front alone (planes out, tail elided)

``tail_share = 1 − t_front / t_full`` (ROADMAP queue 3, item 7, asks for
it).  Inputs: the tools' bench words (``tools/common.py``) with plan words
at 100 Msps.  One stderr line a round and variant, then one JSON line
``{"full_gsps", "front_gsps", "tail_share", "full_ms", "front_ms"}`` on
stdout (``*_ms`` for all K dispatches):

    python -m doppler_tpu_torch.tools.probe_split_tail --samples 33554432
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import cascade
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.tools import common

FS = 100_000_000        # BASELINE config 5's input rate
VARIANTS = ("full", "front")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_common_args(ap)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, exact names")
    args = ap.parse_args(argv)
    variants = set(args.variants.split(","))
    device, label = common.open_device(args.device)
    words, plans, B = common.bench_inputs(args.samples, device, fs=FS)
    N = B * common.L
    K = max(1, args.dispatches)
    ms = MultiStageResampler(FS, common.OUT_RATE, device=device)
    k = cascade.split_point(ms.stages)
    if not 0 < k < len(ms.stages):
        raise SystemExit(f"the {FS} sps route does not split: {ms.stages}")
    front = tuple((st.P, st.Q, st.T) for st in ms.stages[:k])
    tail = ms.stages[k:]
    print("split stages: " + " -> ".join(
        f"{st.P}/{st.Q}(T={st.T})" for st in ms.stages)
        + f"  (front {k} fused, tail the window resampler)", file=sys.stderr)
    banks = tuple(torch.from_numpy(st.bank).to(device) for st in ms.stages[:k])
    carries = tuple(torch.zeros(2, T - 1, device=device) for _, _, T in front)
    kw = dict(stages=front, outtype="f32", final_dense=True)

    def step_front():
        return cascade.mix_cascade_stream(words, plans, banks, carries, **kw)[0]

    def step_full():
        planes = step_front().reshape(2, -1)
        yi, yq, n_out = planes[0], planes[1], planes.shape[1]
        for st in tail:
            yi, yq, n_out = st.process(yi, yq, n_out,
                                       M=st.max_out_for(int(yi.shape[-1])))
        return codec.iq_to_i16_words(yi[:n_out], yq[:n_out])

    steps = {k: v for k, v in (("full", step_full), ("front", step_front))
             if k in variants}

    def on_time(it, name, dt):
        print(f"iter {it} {name}: {dt * 1e3:8.2f} ms/{K} disp "
              f"({N * K / dt / 1e9:6.2f} GS/s) [{label}]", file=sys.stderr)

    best = common.best_of(steps, args.iters, K, device, on_time)
    res = {f"{k}_gsps": N * K / v / 1e9 for k, v in best.items()}
    res.update({f"{k}_ms": v * 1e3 for k, v in best.items()})
    if len(best) == 2:
        res["tail_share"] = 1.0 - best["front"] / best["full"]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
