"""Observer geometry: geodetic site → TEME, topocentric az/el/range/range-rate.

Replaces libgpredict's observer chain (the reference consumes
``predict.sat.{az_deg, el_deg, range_km, range_rate_km_sec}`` at
``src/main.rs:170-173``).  Follows the classic PREDICT/SGP4-ecosystem
formulation: the site is rotated into the pseudo-inertial TEME frame by local
sidereal time (GMST + east longitude); range-rate is the line-of-sight
projection of the relative velocity — the quantity the Doppler shift needs
(``doppler = −(range_rate·1000/c)·f``, main.rs:163).

All functions are vectorized over time (NumPy f64).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from doppler_tpu_torch.orbit.sgp4 import SGP4, WGS72
from doppler_tpu_torch.orbit.tle import Tle

from doppler_tpu_torch.orbit.timebase import gmst_rad, unix_to_jd  # noqa: F401

__all__ = ["Observer", "Predictor", "SatObs", "gmst_rad", "unix_to_jd"]

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi
# Earth rotation rate, rad/min (sidereal, PREDICT's omega_E = 1.00273790934 rev/day)
_OMEGA_EARTH_RAD_MIN = 2.0 * math.pi * 1.00273790934 / 1440.0
_F = 1.0 / 298.26          # WGS-72 flattening


@dataclass
class SatObs:
    """One observation sample (all arrays broadcast over time)."""

    az_deg: np.ndarray
    el_deg: np.ndarray
    range_km: np.ndarray
    range_rate_km_sec: np.ndarray


class Observer:
    """A fixed geodetic site (degrees north/east, meters above sea level)."""

    def __init__(self, lat_deg: float, lon_deg: float, alt_m: float, grav=WGS72):
        self.lat = lat_deg * _DEG2RAD
        self.lon = lon_deg * _DEG2RAD
        self.alt_km = alt_m / 1000.0
        self.grav = grav

    def site_teme(self, jd):
        """Site position (km) and velocity (km/s) in TEME at julian date(s)."""
        g = self.grav
        jd = np.asarray(jd, dtype=np.float64)
        lst = np.mod(gmst_rad(jd) + self.lon, 2.0 * math.pi)
        sinlat = math.sin(self.lat)
        coslat = math.cos(self.lat)
        c = 1.0 / math.sqrt(1.0 + _F * (_F - 2.0) * sinlat * sinlat)
        s = (1.0 - _F) ** 2 * c
        achcp = (g.radiusearthkm * c + self.alt_km) * coslat
        x = achcp * np.cos(lst)
        y = achcp * np.sin(lst)
        z = np.broadcast_to(
            (g.radiusearthkm * s + self.alt_km) * sinlat, x.shape
        )
        r = np.stack([x, y, z], axis=-1)
        omega_kms = _OMEGA_EARTH_RAD_MIN / 60.0   # rad/s
        v = np.stack([-omega_kms * y, omega_kms * x, np.zeros_like(x)], axis=-1)
        return r, v, lst

    def topocentric(self, jd, r_sat, v_sat) -> SatObs:
        """TEME satellite state → az/el/range/range-rate at this site."""
        r_site, v_site, lst = self.site_teme(jd)
        rho = r_sat - r_site
        drho = v_sat - v_site
        rng = np.linalg.norm(rho, axis=-1)
        rate = np.sum(rho * drho, axis=-1) / rng

        sinlat = math.sin(self.lat)
        coslat = math.cos(self.lat)
        sinlst = np.sin(lst)
        coslst = np.cos(lst)
        top_s = sinlat * coslst * rho[..., 0] + sinlat * sinlst * rho[..., 1] \
            - coslat * rho[..., 2]
        top_e = -sinlst * rho[..., 0] + coslst * rho[..., 1]
        top_z = coslat * coslst * rho[..., 0] + coslat * sinlst * rho[..., 1] \
            + sinlat * rho[..., 2]
        az = np.mod(np.arctan2(top_e, -top_s), 2.0 * math.pi)
        el = np.arcsin(np.clip(top_z / rng, -1.0, 1.0))
        return SatObs(
            az_deg=az * _RAD2DEG,
            el_deg=el * _RAD2DEG,
            range_km=rng,
            range_rate_km_sec=rate,
        )


class Predictor:
    """TLE + site → observation at UTC time(s); the gpredict `Predict` analog.

    ``use_native='auto'`` (the default, as in the JAX package) evaluates the
    Doppler curve through the C++ SGP4 of ``runtime.native`` (``NativeSGP4``,
    ``native/src/sgp4_native.cpp``); a TLE the C++ code does not take (a
    deep-space satellite) runs the NumPy SGP4/SDP4 below.  ``True`` requires
    the C++ curve, ``False`` always runs NumPy.  The two implement the same
    math; unlike the JAX package, a native library that fails to build
    raises instead of falling back.
    """

    def __init__(self, tle: Tle, observer: Observer, use_native="auto"):
        if use_native not in ("auto", True, False):
            raise ValueError(
                f"use_native must be 'auto', True or False, got {use_native!r}")
        self.tle = tle
        self.observer = observer
        self.sgp4 = SGP4(tle)
        self._native = None
        if use_native is not False:
            from doppler_tpu_torch.runtime.native import (
                NativeInitError,
                NativeSGP4,
            )

            try:
                self._native = NativeSGP4(tle)
            except NativeInitError:
                if use_native is True:
                    raise

    @property
    def native(self) -> bool:
        """Does the C++ curve evaluate this predictor?"""
        return self._native is not None

    def observe_unix(self, unix_s) -> SatObs:
        if self._native is not None:
            _, obs = self._observe_native(unix_s, 0.0)
            return obs
        jd = unix_to_jd(unix_s)
        tsince_min = (jd - self.tle.epoch_jd) * 1440.0
        r, v = self.sgp4.propagate(tsince_min)
        return self.observer.topocentric(jd, r, v)

    def _observe_native(self, unix_s, frequency_hz):
        ts = np.asarray(unix_s, dtype=np.float64)
        shape = ts.shape
        o = self.observer
        dop, rng, rate, az, el = self._native.doppler_curve(
            ts.reshape(-1), math.degrees(o.lat), math.degrees(o.lon),
            o.alt_km * 1000.0, frequency_hz,
        )
        obs = SatObs(
            az_deg=az.reshape(shape), el_deg=el.reshape(shape),
            range_km=rng.reshape(shape),
            range_rate_km_sec=rate.reshape(shape),
        )
        return dop.reshape(shape), obs

    def doppler_hz(self, unix_s, frequency_hz: float, c_m_s: float = 299792458.0):
        """``−(range_rate·1000/c)·f`` exactly as main.rs:163 computes it."""
        if self._native is not None:
            return self._observe_native(unix_s, float(frequency_hz))
        obs = self.observe_unix(unix_s)
        return (obs.range_rate_km_sec * 1000.0 / c_m_s) * float(frequency_hz) * (-1.0), obs
