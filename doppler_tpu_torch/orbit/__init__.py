"""Host orbital mechanics: TLE, SGP4, observer geometry, Doppler schedules."""

from doppler_tpu_torch.orbit.observer import Observer, Predictor, SatObs  # noqa: F401
from doppler_tpu_torch.orbit.schedule import (  # noqa: F401
    RealtimeTrackScheduler,
    SPEED_OF_LIGHT_M_S,
    TrackScheduler,
)
from doppler_tpu_torch.orbit.sgp4 import SGP4, SGP4Error, WGS72  # noqa: F401
from doppler_tpu_torch.orbit.tle import Tle, TleError  # noqa: F401

__all__ = [
    "Observer", "Predictor", "SatObs", "SGP4", "SGP4Error", "WGS72",
    "Tle", "TleError", "TrackScheduler", "RealtimeTrackScheduler",
    "SPEED_OF_LIGHT_M_S", "make_track_scheduler",
]


def make_track_scheduler(
    *,
    tlefile: str,
    tlename: str,
    lat: float,
    lon: float,
    alt: float,
    frequency_hz: float,
    offset_hz: float,
    samplerate: int,
    start_time: float | None,
    telemetry: bool = True,
    use_native="auto",
):
    """CLI glue: build the track-mode scheduler (recorded or realtime).
    ``use_native`` is the ``Predictor``'s (the C++ curve by default).

    Raises ``FileNotFoundError``/``TleError``/``SGP4Error`` (ValueError
    subclasses) for the CLI's exit(1) path, mirroring main.rs:141-147.
    """
    try:
        tle = Tle.from_file(tlename, tlefile)
    except OSError as e:
        raise FileNotFoundError(f"cannot read TLE file {tlefile!r}: {e}") from None
    predictor = Predictor(tle, Observer(lat, lon, alt), use_native=use_native)
    if start_time is not None:
        return TrackScheduler(
            predictor, frequency_hz, offset_hz, samplerate, start_time,
            telemetry=telemetry,
        )
    return RealtimeTrackScheduler(
        predictor, frequency_hz, offset_hz, samplerate, telemetry=telemetry
    )
