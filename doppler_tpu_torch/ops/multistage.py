"""Multi-stage resampler: ÷q decimation cascade + final rational stage.

The torch statement of ``doppler_tpu/ops/multistage.py``.  Heavy
decimation (1.024 Msps → 48 ksps is 3/64; 100 Msps → 48 ksps is 6/15625)
is factored into

    ÷q₀  →  ÷q₁  →  …  →  rational P/Q' (small Q'),   qᵢ ∈ {16, 8, 4, 2}

where every front stage only protects the final output band (a wide
transition, so few taps) and the sharp filter runs at the lowest rate.  The
stage design is NumPy and is the JAX package's term for term, so both
packages build the same stages with the same banks bit for bit.

Each stage is a :class:`~doppler_tpu_torch.ops.resample.RationalResampler`
on the cascade's ``device``, so streaming state, Bresenham output alignment
and checkpoint state compose.  The pipeline runs full chunks through the
fused cascade kernel (``ops.cuda.cascade``) and mirrors each fused stage's
history back into these stages; :meth:`MultiStageResampler.process` runs
the rest (the EOF chunk, the drain, and from its first unfused stage the
tail of a split cascade).
"""

from __future__ import annotations

import math

import torch

from doppler_tpu_torch.ops.resample import RationalResampler
from doppler_tpu_torch.runtime.telemetry import get_logger

__all__ = ["MultiStageResampler", "halfband_taps_needed",
           "stage_taps_needed", "make_resampler"]


def stage_taps_needed(stage_rate: float, q: int, pass_hz: float,
                      atten_db: float) -> int:
    """Kaiser length for a ÷q decimation stage protecting ``pass_hz``.

    Stopband edge = rate/q − pass_hz, so the transition is
    Δν = (rate/q − 2·pass_hz)/rate of the stage's input rate.  Odd length
    keeps the q = 2 true-halfband structure.
    """
    dv = (stage_rate / q - 2.0 * pass_hz) / stage_rate
    if dv <= 0.0:
        raise ValueError(f"passband too wide for a ÷{q} stage")
    n = (max(atten_db, 21.0) - 7.95) / (2.285 * 2.0 * math.pi * dv)
    n = max(7, int(math.ceil(n)))
    return n + 1 if n % 2 == 0 else n


def halfband_taps_needed(stage_rate: float, pass_hz: float,
                         atten_db: float) -> int:
    """Kaiser length for a ÷2 halfband (the q = 2 case of
    :func:`stage_taps_needed`)."""
    return stage_taps_needed(stage_rate, 2, pass_hz, atten_db)


class MultiStageResampler:
    """Streaming decimation cascade over planar IQ chunks on one device.

    Drop-in for :class:`RationalResampler` at the pipeline boundary (same
    ``process`` / ``out_count_for`` / ``max_out_for`` / ``state_dict`` /
    ``load_state`` surface, and the same ``channels=C`` batch form).
    Decimation only (``out_rate < in_rate``).
    ``P``/``Q`` are the overall reduced ratio and ``T`` the input-referred
    FIR span, ``1 + Σ (T_s − 1)·(in_rate / rate_s)``.  ``impl`` is every
    stage's resampler form (``RationalResampler(impl=)``), as in the JAX
    package.
    """

    def __init__(self, in_rate: int, out_rate: float, *,
                 atten_db: float = 70.0, channels: int | None = None,
                 max_denominator: int = 1 << 16, device="cpu",
                 impl: str = "auto"):
        if out_rate >= in_rate:
            raise ValueError(
                "MultiStageResampler is decimation-only; use "
                "RationalResampler (or make_resampler) for ratios ≥ 1")
        self.in_rate = int(in_rate)
        self.out_rate = float(out_rate)
        self.device = torch.device(device)
        self.channels = channels      # every stage batches the same C

        pass_hz = 0.5 * float(out_rate)       # protect the full output band
        self.stages: list[RationalResampler] = []
        rate = float(in_rate)
        # greedy ÷q stages, largest q first, while the divided rate still
        # holds the output band; each designed 10·log10(q) dB deeper for the
        # q−1 bands it folds, and capped at 129 taps (the JAX rule as is)
        while rate / 2.0 >= 2.0 * out_rate and float(rate / 2.0).is_integer():
            for q in (16, 8, 4, 2):
                if rate / q < 2.0 * out_rate:
                    continue
                if not float(rate / q).is_integer():
                    continue
                atten_s = atten_db + 10.0 * math.log10(q)
                try:
                    taps = stage_taps_needed(rate, q, pass_hz, atten_s)
                except ValueError:
                    continue
                if taps > 129:
                    continue
                break
            else:
                break
            self.stages.append(RationalResampler(
                int(rate), rate / q, taps_per_phase=taps, atten_db=atten_s,
                channels=channels, device=self.device, impl=impl))
            rate = rate / q
        fin_ratio = max(1.0, rate / float(out_rate))
        self.stages.append(RationalResampler(
            int(rate), out_rate, atten_db=atten_db + 10.0 * math.log10(fin_ratio),
            channels=channels, max_denominator=max_denominator,
            device=self.device, impl=impl))
        g = 1
        for st in self.stages[:-1]:
            g *= st.Q                     # P = 1 decimation front
        gg = math.gcd(self.stages[-1].P, self.stages[-1].Q * g)
        self.P = self.stages[-1].P // gg
        self.Q = self.stages[-1].Q * g // gg
        self.T = 1 + sum(
            (st.T - 1) * (self.in_rate // st.in_rate) for st in self.stages)

    # -- pipeline surface ----------------------------------------------------

    def out_count_for(self, n_new_inputs: int) -> int:
        """Outputs produced once ``n_new_inputs`` more samples arrive —
        stage by stage, not a closed ⌈n·P/Q⌉."""
        n = int(n_new_inputs)
        for st in self.stages:
            n = st.out_count_for(n)
        return n

    def max_out_for(self, chunk_capacity: int) -> int:
        cap = int(chunk_capacity)
        for st in self.stages:
            cap = st.max_out_for(cap)
        return cap

    def process(self, i: torch.Tensor, q: torch.Tensor, valid: int,
                M: int | None = None, start: int = 0):
        """Chain the stages from stage ``start`` on (a split cascade's tail
        takes the fused front's planes).  Each stage's capacity follows from
        its input's length; ``M`` is accepted for the RationalResampler
        surface and ignored.  Returns (yi, yq, n_valid_outputs)."""
        n = int(valid)
        for st in self.stages[start:]:
            i, q, n = st.process(i, q, n, st.max_out_for(int(i.shape[-1])))
        return i, q, n

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> dict:
        return {f"s{k}_{key}": val
                for k, st in enumerate(self.stages)
                for key, val in st.state_dict().items()}

    def load_state(self, state: dict) -> None:
        for k, st in enumerate(self.stages):
            st.load_state({key: state[f"s{k}_{key}"]
                           for key in ("m_next", "in_consumed", "hist_i", "hist_q")})


def make_resampler(in_rate: int, out_rate: float, *, stages: str = "single",
                   atten_db: float = 70.0, channels: int | None = None,
                   device="cpu", **kwargs):
    """``stages='single'`` → :class:`RationalResampler`; ``'auto'`` → the
    cascade when decimating by 4× or more; ``'multi'`` → the cascade.
    ``kwargs`` (``impl``, ``max_denominator``) go to the resampler."""
    if stages not in ("single", "auto", "multi"):
        raise ValueError(f"stages must be single|auto|multi, got {stages!r}")
    heavy = float(out_rate) * 4.0 <= float(in_rate)
    if stages == "multi" or (stages == "auto" and heavy):
        if stages == "auto":
            # 'auto' picks another filter chain than 'single': same SNR
            # grade, not the same bytes
            get_logger("resample").info(
                "resample-stages auto: %.0f → %.0f Hz decimates ≥4× — "
                "using the multi-stage cascade (pass --resample-stages "
                "single for the legacy single-stage filter response)",
                float(in_rate), float(out_rate))
        return MultiStageResampler(in_rate, out_rate, atten_db=atten_db,
                                   channels=channels, device=device, **kwargs)
    return RationalResampler(in_rate, out_rate, atten_db=atten_db,
                             channels=channels, device=device, **kwargs)
