"""Time conversions shared by the propagator and observer geometry."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["unix_to_jd", "gmst_rad"]


def unix_to_jd(unix_s):
    """Unix seconds (UTC) → Julian date."""
    return np.asarray(unix_s, dtype=np.float64) / 86400.0 + 2440587.5


def gmst_rad(jd_ut1):
    """Greenwich mean sidereal time, radians (IAU-82, Vallado eq. 3-45)."""
    jd = np.asarray(jd_ut1, dtype=np.float64)
    t = (jd - 2451545.0) / 36525.0
    sec = (
        67310.54841
        + (876600.0 * 3600.0 + 8640184.812866) * t
        + 0.093104 * t * t
        - 6.2e-6 * t * t * t
    )
    # seconds of sidereal time → radians (86400 sid-sec = 2π)
    return np.mod(np.mod(sec, 86400.0) / 86400.0 * 2.0 * math.pi, 2.0 * math.pi)
