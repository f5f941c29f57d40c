"""SGP4 orbital propagator — from-scratch, vectorized NumPy f64.

Replaces the reference's native C libgpredict dependency (SURVEY §2 #9;
consumed at reference ``src/main.rs:141-201``).  Implements the standard
near-earth SGP4 model from Spacetrack Report #3 (Hoots & Roehrich 1980) with
the customary corrections from Vallado et al., "Revisiting Spacetrack Report
#3" (AIAA 2006-6753), using WGS-72 gravity constants — the constant set the
original model (and gpredict) uses.

Host-side by design: propagation is O(blocks), not O(samples) (SURVEY §2
"native components"), and is *vectorized over time* — one call evaluates an
entire Doppler curve, which is how the track scheduler amortizes host cost
for high-rate streams.

Deep-space (SDP4) satellites (period ≥ 225 min) are detected and routed
through the SDP4 corrections in ``orbit.deepspace`` (resonance + lunar/solar
periodics); near-earth propagation stays on the pure SGP4 path below.
"""

from __future__ import annotations

import math

import numpy as np

from doppler_tpu_torch.orbit.tle import Tle

__all__ = ["SGP4", "SGP4Error", "WGS72"]


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

        # deep-space (SDP4) initialization
        self.ds = None
        if self.deep:
            from doppler_tpu_torch.orbit import deepspace as dsx
            from doppler_tpu_torch.orbit.timebase import gmst_rad

            gsto = float(gmst_rad(tle.epoch_jd))
            epoch_d1950 = tle.epoch_jd - 2433281.5
            ds = dsx.dscom(epoch_d1950, ecco, tle.argpo, 0.0, inclo,
                           tle.nodeo, no_unkozai)
            dsx.dpper(ds, 0.0, ecco, inclo, tle.nodeo, tle.argpo, tle.mo,
                      init=True)
            dsx.dsinit(
                ds, xke=g.xke, cosim=cosio, sinim=sinio, emsq=eccsq,
                argpo=tle.argpo, inclm=inclo, no=no_unkozai,
                nodeo=tle.nodeo, mo=tle.mo, mdot=self.mdot,
                argpdot=self.argpdot, nodedot=self.nodedot,
                xpidot=self.argpdot + self.nodedot, eccm=ecco, gsto=gsto,
            )
            self.ds = ds

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

        # secular deep-space (SDP4): lunar-solar rates + resonance integration
        nm = np.full_like(t, self.no_unkozai)
        em = np.full_like(t, self.ecco)
        inclm = np.full_like(t, self.inclo)
        if self.deep:
            from doppler_tpu_torch.orbit import deepspace as dsx

            for k in range(t.size):
                (em[k], inclm[k], nodem[k], argpm[k],
                 mm[k], nm[k]) = dsx.dspace(
                    self.ds, float(t[k]), float(em[k]), float(inclm[k]),
                    float(nodem[k]), float(argpm[k]), float(mm[k]),
                )
            if np.any(nm <= 0.0):
                raise SGP4Error(f"{self.tle.name!r}: mean motion ≤ 0 (resonance)")

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

        # periodic deep-space corrections + inclination-dependent coefficients
        ep, xincp, nodep, argpp, mp = em, inclm, nodem, argpm, mm
        if self.deep:
            for k in range(t.size):
                (ep[k], xincp[k], nodep[k], argpp[k], mp[k]) = dsx.dpper(
                    self.ds, float(t[k]), float(ep[k]), float(xincp[k]),
                    float(nodep[k]), float(argpp[k]), float(mp[k]),
                )
            flip = xincp < 0.0
            xincp = np.where(flip, -xincp, xincp)
            nodep = np.where(flip, nodep + math.pi, nodep)
            argpp = np.where(flip, argpp - math.pi, argpp)
            ep = np.clip(ep, 1.0e-6, 0.999999)
            sinip = np.sin(xincp)
            cosip = np.cos(xincp)
            cosisq = cosip * cosip
            con41 = 3.0 * cosisq - 1.0
            x1mth2 = 1.0 - cosisq
            x7thm1 = 7.0 * cosisq - 1.0
            aycof = -0.5 * g.j3oj2 * sinip
            denom = np.where(np.abs(1.0 + cosip) > 1.5e-12, 1.0 + cosip, 1.5e-12)
            xlcof = -0.25 * g.j3oj2 * sinip * (3.0 + 5.0 * cosip) / denom
        else:
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
