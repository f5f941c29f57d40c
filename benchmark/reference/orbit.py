"""The Doppler curve of a track cell, worked out again from its TLE.

A frozen copy of the port's NumPy orbit code (``Tle.from_lines``, the
near-earth SGP4 of Spacetrack Report #3 with Vallado's corrections and
WGS-72 constants, the observer geometry), so that the benchmark's yardstick
does not move when the program does.  The program evaluates the same curve
through its C++ SGP4; this copy is NumPy float64 and imports nothing of the
program.  Deep-space TLEs (period >= 225 min) are refused.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["Tle", "SGP4", "SGP4Error", "WGS72", "Observer", "doppler_hz",
           "checksum"]

_DEG2RAD = math.pi / 180.0
_TWO_PI = 2.0 * math.pi
_MIN_PER_DAY = 1440.0


def _parse_mantissa_exp(field: str) -> float:
    """Implied-decimal TLE field: ``' 66816-4'`` → 0.66816e-4, ``'-11606-4'``
    → -0.11606e-4 (bstar/nddot columns; leading sign, mantissa, signed exp)."""
    field = field.strip()
    if not field:
        return 0.0
    sign = 1.0
    if field[0] in "+-":
        if field[0] == "-":
            sign = -1.0
        field = field[1:].strip()
    for i in range(len(field) - 1, 0, -1):
        if field[i] in "+-":
            mant, exp = field[:i], field[i:]
            break
    else:
        mant, exp = field, "0"
    mant = mant.strip() or "0"
    return sign * float(f"0.{mant}") * 10.0 ** int(exp)


def checksum(line: str) -> int:
    total = 0
    for ch in line[:68]:
        if ch.isdigit():
            total += int(ch)
        elif ch == "-":
            total += 1
    return total % 10


def _epoch_to_jd(epoch_year: int, epoch_days: float) -> float:
    """TLE epoch (2-digit year + fractional day-of-year) → Julian date UTC."""
    year = 1900 + epoch_year if epoch_year >= 57 else 2000 + epoch_year
    # JD of Jan 0.0 of `year` (standard integer-arithmetic formula)
    a = (year - 1) // 100
    b = 2 - a + a // 4
    jd_jan0 = int(365.25 * (year - 1)) + int(30.6001 * 14) + 1720994.5 + b
    return jd_jan0 + epoch_days


@dataclass
class Tle:
    """Parsed TLE mean elements (angles in radians, mean motion rad/min)."""

    name: str
    satnum: int
    epoch_jd: float          # UTC Julian date of epoch
    ndot: float              # rad/min^2 (first derivative term /2 already applied)
    nddot: float             # rad/min^3 (/6 already applied)
    bstar: float             # 1/earth-radii
    inclo: float             # inclination, rad
    nodeo: float             # RAAN, rad
    ecco: float              # eccentricity
    argpo: float             # argument of perigee, rad
    mo: float                # mean anomaly, rad
    no_kozai: float          # mean motion, rad/min (Kozai convention)

    @classmethod
    def from_lines(cls, name: str, line1: str, line2: str) -> "Tle":
        if len(line1) < 69 or len(line2) < 69:
            raise ValueError(f"TLE lines too short for {name!r}")
        if line1[0] != "1" or line2[0] != "2":
            raise ValueError(f"bad TLE line numbers for {name!r}")
        for ln in (line1, line2):
            try:
                if int(ln[68]) != checksum(ln):
                    raise ValueError(f"TLE checksum mismatch for {name!r}: {ln!r}")
            except ValueError:
                raise ValueError(f"TLE checksum not a digit for {name!r}") from None
        try:
            satnum = int(line1[2:7])
            epoch_year = int(line1[18:20])
            epoch_days = float(line1[20:32])
            ndot_revday2 = float(line1[33:43])          # rev/day^2 /2
            nddot_revday3 = _parse_mantissa_exp(line1[44:52].strip() or "0")
            bstar = _parse_mantissa_exp(line1[53:61].strip() or "0")
            inclo = float(line2[8:16]) * _DEG2RAD
            nodeo = float(line2[17:25]) * _DEG2RAD
            ecco = float(f"0.{line2[26:33].strip() or '0'}")
            argpo = float(line2[34:42]) * _DEG2RAD
            mo = float(line2[43:51]) * _DEG2RAD
            no_revday = float(line2[52:63])
        except ValueError as e:
            raise ValueError(f"unparseable TLE field for {name!r}: {e}") from None
        return cls(
            name=name.strip(),
            satnum=satnum,
            epoch_jd=_epoch_to_jd(epoch_year, epoch_days),
            ndot=ndot_revday2 * _TWO_PI / (_MIN_PER_DAY ** 2),
            nddot=nddot_revday3 * _TWO_PI / (_MIN_PER_DAY ** 3),
            bstar=bstar,
            inclo=inclo,
            nodeo=nodeo,
            ecco=ecco,
            argpo=argpo,
            mo=mo,
            no_kozai=no_revday * _TWO_PI / _MIN_PER_DAY,
        )


class SGP4Error(ValueError):
    pass


class WGS72:
    """WGS-72 gravity model constants (Spacetrack Report #3 set)."""

    mu = 398600.8               # km^3/s^2
    radiusearthkm = 6378.135    # km
    xke = 60.0 / math.sqrt(radiusearthkm ** 3 / mu)   # ≈ 0.0743669161
    tumin = 1.0 / xke
    j2 = 0.001082616
    j3 = -0.00000253881
    j4 = -0.00000165597
    j3oj2 = j3 / j2


_TWO_PI = 2.0 * math.pi
_X2O3 = 2.0 / 3.0


def _fmod2p(x):
    return np.mod(x, _TWO_PI)


class SGP4:
    """Near-earth SGP4 initialized from a :class:`Tle`.

    ``propagate(tsince_min)`` accepts a scalar or array of minutes since the
    TLE epoch and returns ``(r, v)`` — TEME position km ``(..., 3)`` and
    velocity km/s ``(..., 3)``.
    """

    def __init__(self, tle: Tle, grav=WGS72):
        g = grav
        self.tle = tle
        self.grav = g

        no_kozai = tle.no_kozai
        ecco = tle.ecco
        inclo = tle.inclo
        if not (0.0 <= ecco < 1.0):
            raise SGP4Error(f"eccentricity {ecco} out of range")
        if no_kozai <= 0.0:
            raise SGP4Error("non-positive mean motion")

        # --- un-Kozai the mean motion -----------------------------------
        cosio = math.cos(inclo)
        cosio2 = cosio * cosio
        eccsq = ecco * ecco
        omeosq = 1.0 - eccsq
        rteosq = math.sqrt(omeosq)

        ak = (g.xke / no_kozai) ** _X2O3
        d1 = 0.75 * g.j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
        del_ = d1 / (ak * ak)
        adel = ak * (1.0 - del_ * del_ - del_ * (1.0 / 3.0 + 134.0 * del_ * del_ / 81.0))
        del_ = d1 / (adel * adel)
        no_unkozai = no_kozai / (1.0 + del_)

        ao = (g.xke / no_unkozai) ** _X2O3
        sinio = math.sin(inclo)
        po = ao * omeosq
        con42 = 1.0 - 5.0 * cosio2
        con41 = -con42 - 2.0 * cosio2   # = 3cos²i − 1
        posq = po * po
        rp = ao * (1.0 - ecco)

        period_min = _TWO_PI / no_unkozai
        self.deep = period_min >= 225.0   # SDP4 deep-space path
        if rp < 1.0:
            raise SGP4Error(f"{tle.name!r}: perigee below earth surface at epoch")

        self.no_unkozai = no_unkozai
        self.am0 = ao
        self.ecco = ecco
        self.inclo = inclo
        self.nodeo = tle.nodeo
        self.argpo = tle.argpo
        self.mo = tle.mo
        self.bstar = tle.bstar
        self.cosio = cosio
        self.sinio = sinio
        self.con41 = con41
        self.x1mth2 = 1.0 - cosio2
        self.x7thm1 = 7.0 * cosio2 - 1.0

        # --- near-earth initialization ----------------------------------
        ss = 78.0 / g.radiusearthkm + 1.0
        qzms2t = ((120.0 - 78.0) / g.radiusearthkm) ** 4

        self.isimp = rp < (220.0 / g.radiusearthkm + 1.0) or self.deep
        sfour = ss
        qzms24 = qzms2t
        perige = (rp - 1.0) * g.radiusearthkm
        if perige < 156.0:
            sfour = perige - 78.0
            if perige < 98.0:
                sfour = 20.0
            qzms24 = ((120.0 - sfour) / g.radiusearthkm) ** 4
            sfour = sfour / g.radiusearthkm + 1.0

        pinvsq = 1.0 / posq
        tsi = 1.0 / (ao - sfour)
        self.eta = eta = ao * ecco * tsi
        etasq = eta * eta
        eeta = ecco * eta
        psisq = abs(1.0 - etasq)
        coef = qzms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        cc2 = coef1 * no_unkozai * (
            ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.375 * g.j2 * tsi / psisq * con41
            * (8.0 + 3.0 * etasq * (8.0 + etasq))
        )
        self.cc1 = tle.bstar * cc2
        cc3 = 0.0
        if ecco > 1.0e-4:
            cc3 = -2.0 * coef * tsi * g.j3oj2 * no_unkozai * sinio / ecco
        self.cc4 = 2.0 * no_unkozai * coef1 * ao * omeosq * (
            eta * (2.0 + 0.5 * etasq)
            + ecco * (0.5 + 2.0 * etasq)
            - g.j2 * tsi / (ao * psisq) * (
                -3.0 * con41 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
                + 0.75 * self.x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
                * math.cos(2.0 * tle.argpo)
            )
        )
        self.cc5 = 2.0 * coef1 * ao * omeosq * (
            1.0 + 2.75 * (etasq + eeta) + eeta * etasq
        )
        cosio4 = cosio2 * cosio2
        temp1 = 1.5 * g.j2 * pinvsq * no_unkozai
        temp2 = 0.5 * temp1 * g.j2 * pinvsq
        temp3 = -0.46875 * g.j4 * pinvsq * pinvsq * no_unkozai
        self.mdot = (
            no_unkozai
            + 0.5 * temp1 * rteosq * con41
            + 0.0625 * temp2 * rteosq * (13.0 - 78.0 * cosio2 + 137.0 * cosio4)
        )
        self.argpdot = (
            -0.5 * temp1 * con42
            + 0.0625 * temp2 * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
            + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4)
        )
        xhdot1 = -temp1 * cosio
        self.nodedot = xhdot1 + (
            0.5 * temp2 * (4.0 - 19.0 * cosio2)
            + 2.0 * temp3 * (3.0 - 7.0 * cosio2)
        ) * cosio
        self.omgcof = tle.bstar * cc3 * math.cos(tle.argpo)
        self.xmcof = 0.0
        if ecco > 1.0e-4:
            self.xmcof = -_X2O3 * coef * tle.bstar / eeta
        self.nodecf = 3.5 * omeosq * xhdot1 * self.cc1
        self.t2cof = 1.5 * self.cc1
        if abs(cosio + 1.0) > 1.5e-12:
            self.xlcof = -0.25 * g.j3oj2 * sinio * (3.0 + 5.0 * cosio) / (1.0 + cosio)
        else:
            self.xlcof = -0.25 * g.j3oj2 * sinio * (3.0 + 5.0 * cosio) / 1.5e-12
        self.aycof = -0.5 * g.j3oj2 * sinio
        self.delmo = (1.0 + eta * math.cos(tle.mo)) ** 3
        self.sinmao = math.sin(tle.mo)

        # deep-space (SDP4): not part of this reference
        if self.deep:
            raise SGP4Error(f"{tle.name!r}: deep-space TLE (period >= 225 min)")

        self.d2 = self.d3 = self.d4 = 0.0
        self.t3cof = self.t4cof = self.t5cof = 0.0
        if not self.isimp:
            cc1sq = self.cc1 * self.cc1
            self.d2 = 4.0 * ao * tsi * cc1sq
            temp = self.d2 * tsi * self.cc1 / 3.0
            self.d3 = (17.0 * ao + sfour) * temp
            self.d4 = 0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * self.cc1
            self.t3cof = self.d2 + 2.0 * cc1sq
            self.t4cof = 0.25 * (3.0 * self.d3 + self.cc1 * (12.0 * self.d2 + 10.0 * cc1sq))
            self.t5cof = 0.2 * (
                3.0 * self.d4
                + 12.0 * self.cc1 * self.d3
                + 6.0 * self.d2 * self.d2
                + 15.0 * cc1sq * (2.0 * self.d2 + cc1sq)
            )

    # ------------------------------------------------------------------

    def propagate(self, tsince_min):
        """Minutes since epoch → (r_teme_km (...,3), v_teme_kms (...,3))."""
        g = self.grav
        t = np.asarray(tsince_min, dtype=np.float64)
        scalar = t.ndim == 0
        t = np.atleast_1d(t)

        xmdf = self.mo + self.mdot * t
        argpdf = self.argpo + self.argpdot * t
        nodedf = self.nodeo + self.nodedot * t
        argpm = argpdf
        mm = xmdf
        t2 = t * t
        nodem = nodedf + self.nodecf * t2
        tempa = 1.0 - self.cc1 * t
        tempe = self.bstar * self.cc4 * t
        templ = self.t2cof * t2

        if not self.isimp:
            delomg = self.omgcof * t
            delmtemp = 1.0 + self.eta * np.cos(xmdf)
            delm = self.xmcof * (delmtemp ** 3 - self.delmo)
            temp = delomg + delm
            mm = xmdf + temp
            argpm = argpdf - temp
            t3 = t2 * t
            t4 = t3 * t
            tempa = tempa - self.d2 * t2 - self.d3 * t3 - self.d4 * t4
            tempe = tempe + self.bstar * self.cc5 * (np.sin(mm) - self.sinmao)
            templ = templ + self.t3cof * t3 + t4 * (self.t4cof + t * self.t5cof)

        nm = np.full_like(t, self.no_unkozai)
        em = np.full_like(t, self.ecco)
        inclm = np.full_like(t, self.inclo)

        am = (g.xke / nm) ** _X2O3 * tempa * tempa
        nm = g.xke / am ** 1.5
        em = em - tempe
        if np.any(em >= 1.0) or np.any(am < 0.95):
            raise SGP4Error(f"{self.tle.name!r}: orbit decayed during propagation")
        em = np.clip(em, 1.0e-6, 0.999999)

        mm = mm + self.no_unkozai * templ
        xlm = mm + argpm + nodem
        nodem = _fmod2p(nodem)
        argpm = _fmod2p(argpm)
        mm = _fmod2p(xlm - argpm - nodem)

        ep, xincp, nodep, argpp, mp = em, inclm, nodem, argpm, mm
        sinip = math.sin(self.inclo)
        cosip = math.cos(self.inclo)
        con41 = self.con41
        x1mth2 = self.x1mth2
        x7thm1 = self.x7thm1
        aycof = self.aycof
        xlcof = self.xlcof

        # long-period periodics
        axnl = ep * np.cos(argpp)
        temp = 1.0 / (am * (1.0 - ep * ep))
        aynl = ep * np.sin(argpp) + temp * aycof
        xl = mp + argpp + nodep + temp * xlcof * axnl

        # Kepler's equation for E + ω
        u = _fmod2p(xl - nodep)
        eo1 = u.copy()
        for _ in range(10):
            sineo1 = np.sin(eo1)
            coseo1 = np.cos(eo1)
            denom = 1.0 - coseo1 * axnl - sineo1 * aynl
            tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / denom
            tem5 = np.clip(tem5, -0.95, 0.95)
            eo1 = eo1 + tem5
            if np.max(np.abs(tem5)) < 1.0e-12:
                break

        # short-period periodics
        sineo1 = np.sin(eo1)
        coseo1 = np.cos(eo1)
        ecose = axnl * coseo1 + aynl * sineo1
        esine = axnl * sineo1 - aynl * coseo1
        el2 = axnl * axnl + aynl * aynl
        pl = am * (1.0 - el2)
        if np.any(pl < 0.0):
            raise SGP4Error(f"{self.tle.name!r}: semi-latus rectum < 0")
        rl = am * (1.0 - ecose)
        rdotl = np.sqrt(am) * esine / rl
        rvdotl = np.sqrt(pl) / rl
        betal = np.sqrt(1.0 - el2)
        temp = esine / (1.0 + betal)
        sinu = am / rl * (sineo1 - aynl - axnl * temp)
        cosu = am / rl * (coseo1 - axnl + aynl * temp)
        su = np.arctan2(sinu, cosu)
        sin2u = (cosu + cosu) * sinu
        cos2u = 1.0 - 2.0 * sinu * sinu
        temp = 1.0 / pl
        temp1 = 0.5 * g.j2 * temp
        temp2 = temp1 * temp

        mrt = rl * (1.0 - 1.5 * temp2 * betal * con41) \
            + 0.5 * temp1 * x1mth2 * cos2u
        su = su - 0.25 * temp2 * x7thm1 * sin2u
        xnode = nodep + 1.5 * temp2 * cosip * sin2u
        xinc = xincp + 1.5 * temp2 * cosip * sinip * cos2u
        mvt = rdotl - nm * temp1 * x1mth2 * sin2u / g.xke
        rvdot = rvdotl + nm * temp1 * (x1mth2 * cos2u + 1.5 * con41) / g.xke

        # orientation vectors
        sinsu = np.sin(su)
        cossu = np.cos(su)
        snod = np.sin(xnode)
        cnod = np.cos(xnode)
        sini = np.sin(xinc)
        cosi = np.cos(xinc)
        xmx = -snod * cosi
        xmy = cnod * cosi
        ux = xmx * sinsu + cnod * cossu
        uy = xmy * sinsu + snod * cossu
        uz = sini * sinsu
        vx = xmx * cossu - cnod * sinsu
        vy = xmy * cossu - snod * sinsu
        vz = sini * cossu

        r = np.stack([mrt * ux, mrt * uy, mrt * uz], axis=-1) * g.radiusearthkm
        vkmpersec = g.radiusearthkm * g.xke / 60.0
        v = np.stack(
            [mvt * ux + rvdot * vx, mvt * uy + rvdot * vy, mvt * uz + rvdot * vz],
            axis=-1,
        ) * vkmpersec

        if np.any(mrt < 1.0):
            raise SGP4Error(f"{self.tle.name!r}: satellite decayed (r < 1 ER)")
        if scalar:
            return r[0], v[0]
        return r, v


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


def doppler_hz(tle: Tle, observer: Observer, unix_s, frequency_hz: float,
               c_m_s: float = 299792458.0) -> np.ndarray:
    """``-(range_rate * 1000 / c) * f`` at UTC seconds ``unix_s``."""
    jd = unix_to_jd(unix_s)
    r, v = SGP4(tle).propagate((jd - tle.epoch_jd) * 1440.0)
    obs = observer.topocentric(jd, r, v)
    return (obs.range_rate_km_sec * 1000.0 / c_m_s) * float(frequency_hz) * (-1.0)
