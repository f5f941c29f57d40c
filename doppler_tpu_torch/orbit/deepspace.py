"""SDP4 deep-space extensions: lunar–solar perturbations and resonances.

Completes the orbital propagator for satellites with period ≥ 225 min
(GEO, Molniya, GPS...), which libgpredict served via SDP4 (SURVEY §2 #9).
Implements the standard deep-space model from Spacetrack Report #3 with the
corrections consolidated in Vallado et al., "Revisiting Spacetrack Report
#3" (AIAA 2006-6753):

- ``dscom``  — lunar & solar geometry common terms at epoch;
- ``dpper``  — periodic lunar–solar corrections to the mean elements;
- ``dsinit`` — secular rates + 12h/24h resonance coefficients;
- ``dspace`` — numerical integration of the resonance equations
               (720-minute steps from epoch, as the original does).

All host-side f64 scalar math (invoked per unique schedule time — O(seconds)
per stream, see ``orbit.schedule``).  Validated by physical invariants in
``tests/test_deepspace.py``: finite-difference velocity consistency, orbit
geometry for GEO/Molniya elements, and longitude stationarity for a
geostationary satellite.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

_TWO_PI = 2.0 * math.pi

# lunar-solar constants (Spacetrack Report #3)
ZES = 0.01675
ZEL = 0.05490
ZNS = 1.19459e-5
ZNL = 1.5835218e-4
C1SS = 2.9864797e-6
C1L = 4.7968065e-7
ZSINIS = 0.39785416
ZCOSIS = 0.91744867
ZCOSGS = 0.1945905
ZSINGS = -0.98088458

# resonance constants
Q22 = 1.7891679e-6
Q31 = 2.1460748e-6
Q33 = 2.2123015e-7
ROOT22 = 1.7891679e-6
ROOT32 = 3.7393792e-7
ROOT44 = 7.3636953e-9
ROOT52 = 1.1428639e-7
ROOT54 = 2.1765803e-9
RPTIM = 4.37526908801129966e-3   # earth rotation, rad/min
X2O3 = 2.0 / 3.0

FASX2 = 0.13130908
FASX4 = 2.8843198
FASX6 = 0.37448087
G22 = 5.7686396
G32 = 0.95240898
G44 = 1.8014998
G52 = 1.0508330
G54 = 4.4108898
STEP = 720.0
STEP2 = STEP * STEP / 2.0


@dataclass
class DeepSpaceState:
    """Everything dsinit/dscom produce that dpper/dspace consume."""

    # dscom outputs
    e3: float = 0.0
    ee2: float = 0.0
    se2: float = 0.0
    se3: float = 0.0
    sgh2: float = 0.0
    sgh3: float = 0.0
    sgh4: float = 0.0
    sh2: float = 0.0
    sh3: float = 0.0
    si2: float = 0.0
    si3: float = 0.0
    sl2: float = 0.0
    sl3: float = 0.0
    sl4: float = 0.0
    xgh2: float = 0.0
    xgh3: float = 0.0
    xgh4: float = 0.0
    xh2: float = 0.0
    xh3: float = 0.0
    xi2: float = 0.0
    xi3: float = 0.0
    xl2: float = 0.0
    xl3: float = 0.0
    xl4: float = 0.0
    zmol: float = 0.0
    zmos: float = 0.0
    # epoch-periodic offsets — kept zero (AFSPC lineage; see dpper)
    peo: float = 0.0
    pinco: float = 0.0
    plo: float = 0.0
    pgho: float = 0.0
    pho: float = 0.0
    # dsinit secular rates
    dedt: float = 0.0
    didt: float = 0.0
    dmdt: float = 0.0
    dnodt: float = 0.0
    domdt: float = 0.0
    # resonance
    irez: int = 0
    d2201: float = 0.0
    d2211: float = 0.0
    d3210: float = 0.0
    d3222: float = 0.0
    d4410: float = 0.0
    d4422: float = 0.0
    d5220: float = 0.0
    d5232: float = 0.0
    d5421: float = 0.0
    d5433: float = 0.0
    dell1: float = 0.0
    dell2: float = 0.0
    dell3: float = 0.0
    xlamo: float = 0.0
    xfact: float = 0.0
    gsto: float = 0.0
    no_unkozai: float = 0.0
    argpo: float = 0.0
    argpdot: float = 0.0
    # dscom intermediates needed by dsinit
    _scratch: dict = field(default_factory=dict)


def dscom(epoch_d1950: float, ep: float, argpp: float, tc: float,
          inclp: float, nodep: float, np_: float) -> DeepSpaceState:
    """Deep-space common terms (lunar & solar geometry at epoch)."""
    s = DeepSpaceState()
    nm, em = np_, ep
    snodm, cnodm = math.sin(nodep), math.cos(nodep)
    sinomm, cosomm = math.sin(argpp), math.cos(argpp)
    sinim, cosim = math.sin(inclp), math.cos(inclp)
    emsq = em * em
    betasq = 1.0 - emsq
    rtemsq = math.sqrt(betasq)

    day = epoch_d1950 + 18261.5 + tc / 1440.0
    xnodce = math.fmod(4.5236020 - 9.2422029e-4 * day, _TWO_PI)
    stem, ctem = math.sin(xnodce), math.cos(xnodce)
    zcosil = 0.91375164 - 0.03568096 * ctem
    zsinil = math.sqrt(1.0 - zcosil * zcosil)
    zsinhl = 0.089683511 * stem / zsinil
    zcoshl = math.sqrt(1.0 - zsinhl * zsinhl)
    gam = 5.8351514 + 0.0019443680 * day
    zx = 0.39785416 * stem / zsinil
    zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
    zx = math.atan2(zx, zy)
    zx = gam + zx - xnodce
    zcosgl, zsingl = math.cos(zx), math.sin(zx)

    zcosg, zsing = ZCOSGS, ZSINGS
    zcosi, zsini = ZCOSIS, ZSINIS
    zcosh, zsinh = cnodm, snodm
    cc = C1SS
    xnoi = 1.0 / nm

    ss = {}
    zz = {}
    for lsflg in (1, 2):
        a1 = zcosg * zcosh + zsing * zcosi * zsinh
        a3 = -zsing * zcosh + zcosg * zcosi * zsinh
        a7 = -zcosg * zsinh + zsing * zcosi * zcosh
        a8 = zsing * zsini
        a9 = zsing * zsinh + zcosg * zcosi * zcosh
        a10 = zcosg * zsini
        a2 = cosim * a7 + sinim * a8
        a4 = cosim * a9 + sinim * a10
        a5 = -sinim * a7 + cosim * a8
        a6 = -sinim * a9 + cosim * a10

        x1 = a1 * cosomm + a2 * sinomm
        x2 = a3 * cosomm + a4 * sinomm
        x3 = -a1 * sinomm + a2 * cosomm
        x4 = -a3 * sinomm + a4 * cosomm
        x5 = a5 * sinomm
        x6 = a6 * sinomm
        x7 = a5 * cosomm
        x8 = a6 * cosomm

        z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
        z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
        z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
        z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq
        z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq
        z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq
        z11 = -6.0 * a1 * a5 + emsq * (-24.0 * x1 * x7 - 6.0 * x3 * x5)
        z12 = (-6.0 * (a1 * a6 + a3 * a5)
               + emsq * (-24.0 * (x2 * x7 + x1 * x8) - 6.0 * (x3 * x6 + x4 * x5)))
        z13 = -6.0 * a3 * a6 + emsq * (-24.0 * x2 * x8 - 6.0 * x4 * x6)
        z21 = 6.0 * a2 * a5 + emsq * (24.0 * x1 * x5 - 6.0 * x3 * x7)
        z22 = (6.0 * (a4 * a5 + a2 * a6)
               + emsq * (24.0 * (x2 * x5 + x1 * x6) - 6.0 * (x4 * x7 + x3 * x8)))
        z23 = 6.0 * a4 * a6 + emsq * (24.0 * x2 * x6 - 6.0 * x4 * x8)
        z1 = z1 + z1 + betasq * z31
        z2 = z2 + z2 + betasq * z32
        z3 = z3 + z3 + betasq * z33
        s3 = cc * xnoi
        s2 = -0.5 * s3 / rtemsq
        s4 = s3 * rtemsq
        s1 = -15.0 * em * s4
        s5 = x1 * x3 + x2 * x4
        s6 = x2 * x3 + x1 * x4
        s7 = x2 * x4 - x1 * x3

        if lsflg == 1:
            ss = dict(s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6, s7=s7,
                      z1=z1, z2=z2, z3=z3, z11=z11, z12=z12, z13=z13,
                      z21=z21, z22=z22, z23=z23, z31=z31, z32=z32, z33=z33)
            zcosg, zsing = zcosgl, zsingl
            zcosi, zsini = zcosil, zsinil
            zcosh = zcoshl * cnodm + zsinhl * snodm
            zsinh = snodm * zcoshl - cnodm * zsinhl
            cc = C1L
        else:
            zz = dict(s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6, s7=s7,
                      z1=z1, z2=z2, z3=z3, z11=z11, z12=z12, z13=z13,
                      z21=z21, z22=z22, z23=z23, z31=z31, z32=z32, z33=z33)

    s.zmol = math.fmod(4.7199672 + 0.22997150 * day - gam, _TWO_PI)
    s.zmos = math.fmod(6.2565837 + 0.017201977 * day, _TWO_PI)

    # solar periodic coefficients
    s.se2 = 2.0 * ss["s1"] * ss["s6"]
    s.se3 = 2.0 * ss["s1"] * ss["s7"]
    s.si2 = 2.0 * ss["s2"] * ss["z12"]
    s.si3 = 2.0 * ss["s2"] * (ss["z13"] - ss["z11"])
    s.sl2 = -2.0 * ss["s3"] * ss["z2"]
    s.sl3 = -2.0 * ss["s3"] * (ss["z3"] - ss["z1"])
    s.sl4 = -2.0 * ss["s3"] * (-21.0 - 9.0 * emsq) * ZES
    s.sgh2 = 2.0 * ss["s4"] * ss["z32"]
    s.sgh3 = 2.0 * ss["s4"] * (ss["z33"] - ss["z31"])
    s.sgh4 = -18.0 * ss["s4"] * ZES
    s.sh2 = -2.0 * ss["s2"] * ss["z22"]
    s.sh3 = -2.0 * ss["s2"] * (ss["z23"] - ss["z21"])
    # lunar periodic coefficients
    s.ee2 = 2.0 * zz["s1"] * zz["s6"]
    s.e3 = 2.0 * zz["s1"] * zz["s7"]
    s.xi2 = 2.0 * zz["s2"] * zz["z12"]
    s.xi3 = 2.0 * zz["s2"] * (zz["z13"] - zz["z11"])
    s.xl2 = -2.0 * zz["s3"] * zz["z2"]
    s.xl3 = -2.0 * zz["s3"] * (zz["z3"] - zz["z1"])
    s.xl4 = -2.0 * zz["s3"] * (-21.0 - 9.0 * emsq) * ZEL
    s.xgh2 = 2.0 * zz["s4"] * zz["z32"]
    s.xgh3 = 2.0 * zz["s4"] * (zz["z33"] - zz["z31"])
    s.xgh4 = -18.0 * zz["s4"] * ZEL
    s.xh2 = -2.0 * zz["s2"] * zz["z22"]
    s.xh3 = -2.0 * zz["s2"] * (zz["z23"] - zz["z21"])

    s._scratch = dict(ss=ss, zz=zz, emsq=emsq, sinim=sinim, cosim=cosim,
                      em=em, nm=nm, rtemsq=rtemsq, snodm=snodm, cnodm=cnodm)
    return s


def dpper(s: DeepSpaceState, t: float, ep, inclp, nodep, argpp, mp,
          *, init: bool = False):
    """Lunar-solar periodics at time t (minutes since epoch).

    Returns updated (ep, inclp, nodep, argpp, mp).  The epoch periodic
    values are NOT subtracted (``peo…pho`` stay zero): the AFSPC/Vallado
    lineage applies the full periodic at every t including t=0, and the
    published SDP4 verification ephemerides (Spacetrack Report #3 sat
    11801) include the epoch periodic — subtracting it shifts a high-e
    deep-space orbit by ~40 km (caught by tests/test_deepspace.py's golden
    vectors, which now pin this to <0.1 km).
    """
    zm = s.zmos + ZNS * t
    zf = zm + 2.0 * ZES * math.sin(zm)
    sinzf = math.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * math.cos(zf)
    ses = s.se2 * f2 + s.se3 * f3
    sis = s.si2 * f2 + s.si3 * f3
    sls = s.sl2 * f2 + s.sl3 * f3 + s.sl4 * sinzf
    sghs = s.sgh2 * f2 + s.sgh3 * f3 + s.sgh4 * sinzf
    shs = s.sh2 * f2 + s.sh3 * f3

    zm = s.zmol + ZNL * t
    zf = zm + 2.0 * ZEL * math.sin(zm)
    sinzf = math.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * math.cos(zf)
    sel = s.ee2 * f2 + s.e3 * f3
    sil = s.xi2 * f2 + s.xi3 * f3
    sll = s.xl2 * f2 + s.xl3 * f3 + s.xl4 * sinzf
    sghl = s.xgh2 * f2 + s.xgh3 * f3 + s.xgh4 * sinzf
    shll = s.xh2 * f2 + s.xh3 * f3

    pe = ses + sel
    pinc = sis + sil
    pl = sls + sll
    pgh = sghs + sghl
    ph = shs + shll

    if init:
        s.peo = s.pinco = s.plo = s.pgho = s.pho = 0.0
        return ep, inclp, nodep, argpp, mp

    pe -= s.peo
    pinc -= s.pinco
    pl -= s.plo
    pgh -= s.pgho
    ph -= s.pho

    inclp = inclp + pinc
    ep = ep + pe
    sinip = math.sin(inclp)
    cosip = math.cos(inclp)

    if inclp >= 0.2:
        ph_ = ph / sinip
        pgh_ = pgh - cosip * ph_
        argpp = argpp + pgh_
        nodep = nodep + ph_
        mp = mp + pl
    else:
        # Lyddane modification for low inclination
        sinop, cosop = math.sin(nodep), math.cos(nodep)
        alfdp = sinip * sinop
        betdp = sinip * cosop
        dalf = ph * cosop + pinc * cosip * sinop
        dbet = -ph * sinop + pinc * cosip * cosop
        alfdp += dalf
        betdp += dbet
        nodep = math.fmod(nodep, _TWO_PI)
        if nodep < 0.0:
            nodep += _TWO_PI
        xls = mp + argpp + cosip * nodep \
            + pl + pgh - pinc * nodep * sinip
        xnoh = nodep
        nodep = math.atan2(alfdp, betdp)
        if nodep < 0.0:
            nodep += _TWO_PI
        if abs(xnoh - nodep) > math.pi:
            if nodep < xnoh:
                nodep += _TWO_PI
            else:
                nodep -= _TWO_PI
        mp = mp + pl
        argpp = xls - mp - cosip * nodep
    return ep, inclp, nodep, argpp, mp


def dsinit(s: DeepSpaceState, *, xke, cosim, sinim, emsq, argpo, inclm, no,
           nodeo, mo, mdot, argpdot, nodedot, xpidot, eccm, gsto) -> None:
    """Secular lunar-solar rates + resonance coefficients (mutates s)."""
    ss = s._scratch["ss"]
    zz = s._scratch["zz"]

    s.irez = 0
    nm = no
    if 0.0034906585 < nm < 0.0052359877:
        s.irez = 1
    if 8.26e-3 <= nm <= 9.24e-3 and eccm >= 0.5:
        s.irez = 2

    # solar secular rates
    ses = ss["s1"] * ZNS * ss["s5"]
    sis = ss["s2"] * ZNS * (ss["z11"] + ss["z13"])
    sls = -ZNS * ss["s3"] * (ss["z1"] + ss["z3"] - 14.0 - 6.0 * emsq)
    sghs = ss["s4"] * ZNS * (ss["z31"] + ss["z33"] - 6.0)
    shs = -ZNS * ss["s2"] * (ss["z21"] + ss["z23"])
    if inclm < 5.2359877e-2 or inclm > math.pi - 5.2359877e-2:
        shs = 0.0
    if sinim != 0.0:
        shs = shs / sinim
    sgs = sghs - cosim * shs

    # lunar secular rates
    s.dedt = ses + zz["s1"] * ZNL * zz["s5"]
    s.didt = sis + zz["s2"] * ZNL * (zz["z11"] + zz["z13"])
    s.dmdt = sls - ZNL * zz["s3"] * (zz["z1"] + zz["z3"] - 14.0 - 6.0 * emsq)
    sghl = zz["s4"] * ZNL * (zz["z31"] + zz["z33"] - 6.0)
    shll = -ZNL * zz["s2"] * (zz["z21"] + zz["z23"])
    if inclm < 5.2359877e-2 or inclm > math.pi - 5.2359877e-2:
        shll = 0.0
    s.domdt = sgs + sghl
    s.dnodt = shs
    if sinim != 0.0:
        s.domdt -= cosim / sinim * shll
        s.dnodt += shll / sinim

    s.gsto = gsto
    s.no_unkozai = no
    s.argpo = argpo
    s.argpdot = argpdot

    if s.irez == 0:
        return

    aonv = (nm / xke) ** X2O3
    cosisq = cosim * cosim
    em = eccm
    emsqd = emsq

    if s.irez == 2:
        eoc = em * emsqd
        g201 = -0.306 - (em - 0.64) * 0.440
        if em <= 0.65:
            g211 = 3.616 - 13.2470 * em + 16.2900 * emsqd
            g310 = -19.302 + 117.3900 * em - 228.4190 * emsqd + 156.5910 * eoc
            g322 = -18.9068 + 109.7927 * em - 214.6334 * emsqd + 146.5816 * eoc
            g410 = -41.122 + 242.6940 * em - 471.0940 * emsqd + 313.9530 * eoc
            g422 = -146.407 + 841.8800 * em - 1629.014 * emsqd + 1083.4350 * eoc
            g520 = -532.114 + 3017.977 * em - 5740.032 * emsqd + 3708.2760 * eoc
        else:
            g211 = -72.099 + 331.819 * em - 508.738 * emsqd + 266.724 * eoc
            g310 = -346.844 + 1582.851 * em - 2415.925 * emsqd + 1246.113 * eoc
            g322 = -342.585 + 1554.908 * em - 2366.899 * emsqd + 1215.972 * eoc
            g410 = -1052.797 + 4758.686 * em - 7193.992 * emsqd + 3651.957 * eoc
            g422 = -3581.690 + 16178.110 * em - 24462.770 * emsqd + 12422.520 * eoc
            if em > 0.715:
                g520 = -5149.66 + 29936.92 * em - 54087.36 * emsqd + 31324.56 * eoc
            else:
                g520 = 1464.74 - 4664.75 * em + 3763.64 * emsqd
        if em < 0.7:
            g533 = -919.22770 + 4988.6100 * em - 9064.7700 * emsqd + 5542.21 * eoc
            g521 = -822.71072 + 4568.6173 * em - 8491.4146 * emsqd + 5337.524 * eoc
            g532 = -853.66600 + 4690.2500 * em - 8624.7700 * emsqd + 5341.4 * eoc
        else:
            g533 = -37995.780 + 161616.52 * em - 229838.20 * emsqd + 109377.94 * eoc
            g521 = -51752.104 + 218913.95 * em - 309468.16 * emsqd + 146349.42 * eoc
            g532 = -40023.880 + 170470.89 * em - 242699.48 * emsqd + 115605.82 * eoc

        sini2 = sinim * sinim
        f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
        f221 = 1.5 * sini2
        f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
        f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
        f441 = 35.0 * sini2 * f220
        f442 = 39.3750 * sini2 * sini2
        f522 = 9.84375 * sinim * (sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq)
                                  + 0.33333333 * (-2.0 + 4.0 * cosim + 6.0 * cosisq))
        f523 = sinim * (4.92187512 * sini2 * (-2.0 - 4.0 * cosim + 10.0 * cosisq)
                        + 6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq))
        f542 = 29.53125 * sinim * (2.0 - 8.0 * cosim
                                   + cosisq * (-12.0 + 8.0 * cosim + 10.0 * cosisq))
        f543 = 29.53125 * sinim * (-2.0 - 8.0 * cosim
                                   + cosisq * (12.0 + 8.0 * cosim - 10.0 * cosisq))
        xno2 = nm * nm
        ainv2 = aonv * aonv          # aonv = (n/ke)^(2/3) is 1/a in ER
        temp1 = 3.0 * xno2 * ainv2
        temp = temp1 * ROOT22
        s.d2201 = temp * f220 * g201
        s.d2211 = temp * f221 * g211
        temp1 = temp1 * aonv
        temp = temp1 * ROOT32
        s.d3210 = temp * f321 * g310
        s.d3222 = temp * f322 * g322
        temp1 = temp1 * aonv
        temp = 2.0 * temp1 * ROOT44
        s.d4410 = temp * f441 * g410
        s.d4422 = temp * f442 * g422
        temp1 = temp1 * aonv
        temp = temp1 * ROOT52
        s.d5220 = temp * f522 * g520
        s.d5232 = temp * f523 * g532
        temp = 2.0 * temp1 * ROOT54
        s.d5421 = temp * f542 * g521
        s.d5433 = temp * f543 * g533
        s.xlamo = math.fmod(mo + nodeo + nodeo - gsto - gsto, _TWO_PI)
        s.xfact = mdot + s.dmdt + 2.0 * (nodedot + s.dnodt - RPTIM) - no

    if s.irez == 1:
        g200 = 1.0 + emsqd * (-2.5 + 0.8125 * emsqd)
        g310 = 1.0 + 2.0 * emsqd
        g300 = 1.0 + emsqd * (-6.0 + 6.60937 * emsqd)
        f220 = 0.75 * (1.0 + cosim) * (1.0 + cosim)
        f311 = 0.9375 * sinim * sinim * (1.0 + 3.0 * cosim) - 0.75 * (1.0 + cosim)
        f330 = 1.0 + cosim
        f330 = 1.875 * f330 * f330 * f330
        dell1 = 3.0 * nm * nm * aonv * aonv
        s.dell2 = 2.0 * dell1 * f220 * g200 * Q22
        s.dell3 = 3.0 * dell1 * f330 * g300 * Q33 * aonv
        s.dell1 = dell1 * f311 * g310 * Q31 * aonv
        s.xlamo = math.fmod(mo + nodeo + argpo - gsto, _TWO_PI)
        s.xfact = mdot + xpidot - RPTIM + s.dmdt + s.domdt + s.dnodt - no


def dspace(s: DeepSpaceState, t: float, em, inclm, nodem, argpm, mm):
    """Deep-space secular + resonance effects at time t (minutes).

    Returns updated (em, inclm, nodem, argpm, mm, nm).  Re-integrates the
    resonance equations from epoch every call (matching the reference
    restart behavior; cost |t|/720 steps).
    """
    em = em + s.dedt * t
    inclm = inclm + s.didt * t
    argpm = argpm + s.domdt * t
    nodem = nodem + s.dnodt * t
    mm = mm + s.dmdt * t
    nm = s.no_unkozai

    if s.irez == 0:
        return em, inclm, nodem, argpm, mm, nm

    # integrate from epoch in 720-min steps (restart-per-call semantics)
    atime = 0.0
    xli = s.xlamo
    xni = s.no_unkozai
    delt = STEP if t > 0.0 else -STEP

    def derivs(xli_, xni_, atime_):
        if s.irez == 1:
            xndt = (s.dell1 * math.sin(xli_ - FASX2)
                    + s.dell2 * math.sin(2.0 * (xli_ - FASX4))
                    + s.dell3 * math.sin(3.0 * (xli_ - FASX6)))
            xldot = xni_ + s.xfact
            xnddt = (s.dell1 * math.cos(xli_ - FASX2)
                     + 2.0 * s.dell2 * math.cos(2.0 * (xli_ - FASX4))
                     + 3.0 * s.dell3 * math.cos(3.0 * (xli_ - FASX6)))
            return xndt, xldot, xnddt * xldot
        xomi = s.argpo + s.argpdot * atime_
        x2omi = xomi + xomi
        x2li = xli_ + xli_
        xndt = (s.d2201 * math.sin(x2omi + xli_ - G22)
                + s.d2211 * math.sin(xli_ - G22)
                + s.d3210 * math.sin(xomi + xli_ - G32)
                + s.d3222 * math.sin(-xomi + xli_ - G32)
                + s.d4410 * math.sin(x2omi + x2li - G44)
                + s.d4422 * math.sin(x2li - G44)
                + s.d5220 * math.sin(xomi + xli_ - G52)
                + s.d5232 * math.sin(-xomi + xli_ - G52)
                + s.d5421 * math.sin(xomi + x2li - G54)
                + s.d5433 * math.sin(-xomi + x2li - G54))
        xldot = xni_ + s.xfact
        xnddt = (s.d2201 * math.cos(x2omi + xli_ - G22)
                 + s.d2211 * math.cos(xli_ - G22)
                 + s.d3210 * math.cos(xomi + xli_ - G32)
                 + s.d3222 * math.cos(-xomi + xli_ - G32)
                 + s.d5220 * math.cos(xomi + xli_ - G52)
                 + s.d5232 * math.cos(-xomi + xli_ - G52)
                 + 2.0 * (s.d4410 * math.cos(x2omi + x2li - G44)
                          + s.d4422 * math.cos(x2li - G44)
                          + s.d5421 * math.cos(xomi + x2li - G54)
                          + s.d5433 * math.cos(-xomi + x2li - G54)))
        return xndt, xldot, xnddt * xldot

    xndt, xldot, xnddt = derivs(xli, xni, atime)
    while abs(t - atime) >= STEP:
        xli = xli + xldot * delt + xndt * STEP2
        xni = xni + xndt * delt + xnddt * STEP2
        atime = atime + delt
        xndt, xldot, xnddt = derivs(xli, xni, atime)

    ft = t - atime
    xl = xli + xldot * ft + xndt * ft * ft * 0.5
    nm = xni + xndt * ft + xnddt * ft * ft * 0.5

    theta = math.fmod(s.gsto + t * RPTIM, _TWO_PI)
    if s.irez == 1:
        mm = xl - nodem - argpm + theta
    else:
        mm = xl - 2.0 * nodem + 2.0 * theta
    return em, inclm, nodem, argpm, mm, nm
