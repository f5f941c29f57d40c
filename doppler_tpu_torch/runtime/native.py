"""The native host library: C++ codecs, the reference NCO and SGP4.

The port of ``doppler_tpu/runtime/native.py``, with the same functions and
names, over the same C++ sources (``native/src/doppler_native.cpp`` and
``native/src/sgp4_native.cpp``, read and never edited).  At first use they
are compiled with ``g++`` and the flags of ``native/Makefile``
(``-O3 -fPIC -std=c++17 -fno-math-errno -shared``) into
``doppler_tpu_torch/_build/native-<hash>/libdoppler_native.so`` (git-ignored;
the hash is of the sources and the flags), built under a temporary name
and renamed into place, so processes that build at once never load a
half-written file.  The library ``make -C native`` writes is never run or
loaded.

Unlike the JAX package, nothing falls back to NumPy when the library cannot
be built: a failed build raises with the compiler's output, because a
silent fallback would hide a broken host path.  :func:`available` is False
only where there is no ``g++`` and no library built before.  A deep-space
TLE (``dt_sgp4_init`` returns −3) is the one case the C++ SGP4 does not
take: :class:`NativeSGP4` raises :class:`NativeInitError` and
``orbit.observer.Predictor`` runs the NumPy SDP4, as the JAX package does.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

__all__ = [
    "CXX_FLAGS",
    "available",
    "build_info",
    "i16_to_planar",
    "planar_to_i16",
    "f32_pairs_to_planar_into",
    "planar_to_f32_pairs",
    "reference_mix",
    "reference_counter_blocks",
    "NativeInitError",
    "NativeSGP4",
]

_REPO = Path(__file__).resolve().parents[2]
SOURCES = (_REPO / "native" / "src" / "doppler_native.cpp",
           _REPO / "native" / "src" / "sgp4_native.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-fno-math-errno", "-shared")

_vp = ctypes.c_void_p
_sz = ctypes.c_size_t
_u32 = ctypes.c_uint32
_f64 = ctypes.c_double


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libdoppler_native.so"


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """Compile the library if it is not built yet; returns its path,
    whether this call compiled it and the seconds that took."""
    lib = _lib_path()
    if lib.exists():
        return {"path": str(lib), "built": False, "seconds": 0.0}
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library "
                           f"({', '.join(s.name for s in SOURCES)}) needs it")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=lib.parent))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp / "lib.so"), *map(str, SOURCES), "-lm"],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"g++ failed to build the native host library:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp / "lib.so", lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"path": str(lib), "built": True, "seconds": seconds}


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_info()["path"])
    for name, args in (("dt_i16_to_planar_f32", [_vp, _sz, _vp, _vp]),
                       ("dt_planar_f32_to_i16", [_vp, _vp, _sz, _vp]),
                       ("dt_f32_to_planar_f32", [_vp, _sz, _vp, _vp]),
                       ("dt_planar_f32_to_f32", [_vp, _vp, _sz, _vp])):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = args
    lib.dt_reference_mix.restype = _u32
    lib.dt_reference_mix.argtypes = [_vp, _vp, _sz, _u32, ctypes.c_float,
                                     _u32, _vp, _vp]
    lib.dt_reference_counter_blocks.restype = _u32
    lib.dt_reference_counter_blocks.argtypes = [_vp, _vp, _sz, _u32, _u32, _vp]
    lib.dt_sgp4_init.restype = ctypes.c_int
    lib.dt_sgp4_init.argtypes = [_vp, _vp]
    lib.dt_sgp4_propagate.restype = ctypes.c_int
    lib.dt_sgp4_propagate.argtypes = [_vp, _vp, _sz, _vp, _vp]
    lib.dt_doppler_curve.restype = ctypes.c_int
    lib.dt_doppler_curve.argtypes = [_vp, _f64, _f64, _f64, _f64, _vp, _sz,
                                     _f64, _vp, _vp, _vp, _vp, _vp]
    return lib


def available() -> bool:
    """True when the library is built or ``g++`` can build it (a failing
    build raises)."""
    if not _lib_path().exists() and shutil.which("g++") is None:
        return False
    _load()
    return True


def i16_to_planar(buf: bytes | np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """LE interleaved i16 bytes → planar (i, q) float32."""
    raw = (np.frombuffer(buf, dtype="<i2")
           if isinstance(buf, (bytes, bytearray, memoryview))
           else np.ascontiguousarray(buf, dtype="<i2"))
    n = raw.size // 2
    raw = np.ascontiguousarray(raw[: 2 * n])
    i = np.empty(n, dtype=np.float32)
    q = np.empty(n, dtype=np.float32)
    _load().dt_i16_to_planar_f32(raw.ctypes.data, n, i.ctypes.data, q.ctypes.data)
    return i, q


def f32_pairs_to_planar_into(pairs: np.ndarray, i_out: np.ndarray,
                             q_out: np.ndarray) -> None:
    """Interleaved f32 ``(n, 2)`` → the given contiguous planar f32 buffers
    (the f32 staging of ``runtime.pipeline.stage_chunk``).

    The C call writes n floats through each pointer, so it runs only on
    contiguous float32 buffers that hold them; any other destination takes
    NumPy's assignment, which raises where the call would write past it.
    """
    pairs = np.ascontiguousarray(pairs, dtype=np.float32)
    n = pairs.shape[0]
    if (i_out.flags.c_contiguous and q_out.flags.c_contiguous
            and i_out.dtype == np.float32 and q_out.dtype == np.float32
            and i_out.size >= n and q_out.size >= n):
        _load().dt_f32_to_planar_f32(pairs.ctypes.data, n, i_out.ctypes.data,
                                     q_out.ctypes.data)
        return
    i_out[:n] = pairs[:, 0]
    q_out[:n] = pairs[:, 1]


def _planes(i, q):
    """Two contiguous float32 planes of one size (the C calls read
    ``i.size`` values from each)."""
    i = np.ascontiguousarray(i, dtype=np.float32)
    q = np.ascontiguousarray(q, dtype=np.float32)
    if i.size != q.size:
        raise ValueError(f"planes of {i.size} and {q.size} samples")
    return i, q


def planar_to_f32_pairs(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Planar f32 → interleaved ``(n, 2)`` f32 (main.rs:89-93 layout)."""
    i, q = _planes(i, q)
    out = np.empty((i.size, 2), dtype="<f4")
    _load().dt_planar_f32_to_f32(i.ctypes.data, q.ctypes.data, i.size,
                                 out.ctypes.data)
    return out


def planar_to_i16(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Planar float32 → interleaved LE i16 with the reference's cast
    (truncate toward zero, saturate, NaN → 0)."""
    i, q = _planes(i, q)
    out = np.empty(2 * i.size, dtype="<i2")
    _load().dt_planar_f32_to_i16(i.ctypes.data, q.ctypes.data, i.size,
                                 out.ctypes.data)
    return out


def reference_mix(i: np.ndarray, q: np.ndarray, samplenum: int,
                  shift_hz: float, samplerate: int
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """The reference's sequential NCO loop (dsp.rs:117-134) in C++, bit for
    bit but for libm's sinf/cosf against NumPy's (≤ 1 ulp).  Returns
    ``(i, q, samplenum after)``."""
    i, q = _planes(i, q)
    oi = np.empty(i.size, dtype=np.float32)
    oq = np.empty(i.size, dtype=np.float32)
    sn = _load().dt_reference_mix(
        i.ctypes.data, q.ctypes.data, i.size, _u32(samplenum),
        ctypes.c_float(shift_hz), _u32(samplerate), oi.ctypes.data,
        oq.ctypes.data)
    return oi, oq, int(sn)


def reference_counter_blocks(shifts: np.ndarray, counts: np.ndarray,
                             samplenum: int, samplerate: int
                             ) -> tuple[np.ndarray, int]:
    """Advance the reference's samplenum counter through a per-block shift
    schedule (the counter-only dsp.rs:117-134 loop).  Returns
    ``(per-block start counters, end counter)``."""
    shifts = np.ascontiguousarray(shifts, dtype=np.float32)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    if counts.size != shifts.size:
        raise ValueError(f"{shifts.size} shifts for {counts.size} blocks")
    out = np.empty(shifts.size, dtype=np.uint32)
    end = _load().dt_reference_counter_blocks(
        shifts.ctypes.data, counts.ctypes.data, shifts.size, _u32(samplenum),
        _u32(samplerate), out.ctypes.data)
    return out, int(end)


# dt_sgp4_propagate / dt_doppler_curve return codes → the messages of the
# NumPy propagator's SGP4Error (orbit/sgp4.py), so callers see one
# exception type whichever SGP4 ran
_SGP4_RC = {
    -1: "invalid elements",
    -4: "orbit decayed during propagation",
    -5: "semi-latus rectum < 0",
    -6: "satellite decayed (r < 1 ER)",
}


def _sgp4_error(tle, rc: int):
    from doppler_tpu_torch.orbit.sgp4 import SGP4Error

    return SGP4Error(f"{tle.name!r}: "
                     f"{_SGP4_RC.get(rc, f'propagation failed (rc {rc})')}")


class NativeInitError(RuntimeError):
    """``dt_sgp4_init`` refused the elements: ``rc`` −3 is a deep-space
    satellite (the NumPy SDP4 takes it), any other a failure."""

    def __init__(self, msg: str, rc: int):
        super().__init__(msg)
        self.rc = rc


class NativeSGP4:
    """C++ near-earth SGP4 and the Doppler curve a ``Predictor`` computes.

    Mirrors ``orbit.sgp4.SGP4`` / ``orbit.observer.Predictor.doppler_hz``.
    Building the library may raise ``RuntimeError``; elements the C++ code
    does not take raise :class:`NativeInitError`.
    """

    def __init__(self, tle):
        self._lib = _load()
        self.tle = tle
        self._ctx = np.zeros(64, dtype=np.float64)
        el = np.array(
            [tle.no_kozai, tle.ecco, tle.inclo, tle.nodeo, tle.argpo,
             tle.mo, tle.bstar, tle.epoch_jd, 0.0, 0.0], dtype=np.float64)
        rc = self._lib.dt_sgp4_init(el.ctypes.data, self._ctx.ctypes.data)
        if rc == -3:
            raise NativeInitError(
                "deep-space satellite: use the Python SDP4 path", rc)
        if rc:
            raise NativeInitError(f"dt_sgp4_init failed ({rc})", rc)

    def propagate(self, tsince_min):
        t = np.ascontiguousarray(np.atleast_1d(tsince_min), dtype=np.float64)
        r = np.empty((t.size, 3), dtype=np.float64)
        v = np.empty((t.size, 3), dtype=np.float64)
        rc = self._lib.dt_sgp4_propagate(self._ctx.ctypes.data, t.ctypes.data,
                                         t.size, r.ctypes.data, v.ctypes.data)
        if rc:
            raise _sgp4_error(self.tle, rc)
        return r, v

    def doppler_curve(self, unix_s, lat_deg, lon_deg, alt_m, frequency_hz):
        """unix times → (doppler_hz, range_km, range_rate, az_deg, el_deg)."""
        ts = np.ascontiguousarray(np.atleast_1d(unix_s), dtype=np.float64)
        out = [np.empty(ts.size, dtype=np.float64) for _ in range(5)]
        rc = self._lib.dt_doppler_curve(
            self._ctx.ctypes.data, _f64(self.tle.epoch_jd), _f64(lat_deg),
            _f64(lon_deg), _f64(alt_m), ts.ctypes.data, ts.size,
            _f64(frequency_hz), *[o.ctypes.data for o in out])
        if rc:
            raise _sgp4_error(self.tle, rc)
        return tuple(out)
