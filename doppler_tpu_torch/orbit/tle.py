"""TLE (two-line element) parsing.

Replaces the reference's use of the gpredict crate's ``Tle::from_file(name,
file)`` (reference ``src/main.rs:141-147``): reads a multi-satellite TLE text
file, selects an entry by its name line, and exposes the mean elements the
SGP4 propagator consumes.  Field positions follow the standard NORAD TLE
column layout (Spacetrack Report #3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["Tle", "TleError"]

_DEG2RAD = math.pi / 180.0
_TWO_PI = 2.0 * math.pi
_MIN_PER_DAY = 1440.0


_file_cache: dict = {}   # (abspath, mtime_ns, size) → (lines, candidates)


class TleError(ValueError):
    pass


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


def _checksum(line: str) -> int:
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
            raise TleError(f"TLE lines too short for {name!r}")
        if line1[0] != "1" or line2[0] != "2":
            raise TleError(f"bad TLE line numbers for {name!r}")
        for ln in (line1, line2):
            try:
                if int(ln[68]) != _checksum(ln):
                    raise TleError(f"TLE checksum mismatch for {name!r}: {ln!r}")
            except ValueError:
                raise TleError(f"TLE checksum not a digit for {name!r}") from None
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
            raise TleError(f"unparseable TLE field for {name!r}: {e}") from None
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

    @classmethod
    def from_file(cls, name: str, path: str) -> "Tle":
        """Find ``name`` in a celestrak-style TLE file (main.rs:141 contract).

        Matches the trimmed name line exactly, falling back to prefix match.
        The parsed file is cached by (path, mtime, size) — channels configs
        commonly point hundreds of channels at one celestrak file.
        """
        import os

        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        cached = _file_cache.get(key)
        if cached is None:
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                lines = [ln.rstrip("\n\r") for ln in f]
            candidates = []
            for idx in range(len(lines) - 2):
                ln = lines[idx].strip()
                if not ln or ln.startswith(("1 ", "2 ")):
                    continue
                if (lines[idx + 1].startswith("1 ")
                        and lines[idx + 2].startswith("2 ")):
                    candidates.append((ln, idx))
            if len(_file_cache) > 16:
                _file_cache.clear()
            _file_cache[key] = (lines, candidates)
        else:
            lines, candidates = cached
        want = name.strip()
        for ln, idx in candidates:
            if ln == want:
                return cls.from_lines(ln, lines[idx + 1], lines[idx + 2])
        for ln, idx in candidates:
            if ln.startswith(want):
                return cls.from_lines(ln, lines[idx + 1], lines[idx + 2])
        raise TleError(f"satellite {name!r} not found in {path}")
