"""Build and load the hand-written CUDA kernels of ``doppler_tpu_torch/csrc``.

At first use the ``.cu`` sources are compiled by ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.
The library lands in ``doppler_tpu_torch/_build/<hash>/`` (git-ignored),
keyed by a hash of the sources and the flags, so a fresh checkout builds
once and later processes load the cached file.  Delete ``_build/`` to force
a rebuild.

Nothing here runs at import time: the package imports, and its plain
versions run, on machines without a CUDA toolkit.
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

__all__ = ["NVCC_FLAGS", "load", "check", "build_info", "shared_memory_limit",
           "sm_count"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# -fmad=false: no float contraction outside the explicit __fmaf_rn of the
# FIR dot (see csrc/nco.cuh for the policy); -Xptxas -v reports registers,
# shared memory and spills of every kernel into the build log.
# DOPPLER_NVCC_FLAGS in the environment adds flags (and so keys another
# library), e.g. -DDOPPLER_CHANNEL_MAJOR to time the other grid schedule.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
              *os.environ.get("DOPPLER_NVCC_FLAGS", "").split())

_vp = ctypes.c_void_p
_i = ctypes.c_int
_vpp = ctypes.POINTER(ctypes.c_void_p)   # an array of pointers
_ip = ctypes.POINTER(ctypes.c_int)      # an array of ints
_ll = ctypes.c_longlong


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """Compile the library if it is not cached; returns its path, whether
    this call compiled it, the seconds that took and nvcc's output."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libdoppler_kernels.so"
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "built": False, "seconds": 0.0, "log": log}
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile into a private directory, then rename the library: concurrent
    # first users never load a half-written file
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [
        (src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in _sources()
    ]
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    link = [nvcc, "-shared", "-o", str(tmp / "lib.so"),
            *(str(tmp / f"{src.stem}.o") for src, _ in procs)]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp / "lib.so", lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"path": str(lib), "built": True, "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call; C signatures declared."""
    lib = ctypes.CDLL(build_info()["path"])
    lib.doppler_mix_blocks.restype = _i
    # in, out, plans, C, B, L, in_f32, out_f32, G, stream
    lib.doppler_mix_blocks.argtypes = [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp]
    lib.doppler_mixer_group.restype = _i
    # C, B, L
    lib.doppler_mixer_group.argtypes = [_i, _i, _i]
    lib.doppler_mix_blocks_q15.restype = _i
    # in, out, plans, B, L, stream
    lib.doppler_mix_blocks_q15.argtypes = [_vp, _vp, _vp, _i, _i, _vp]
    lib.doppler_probe_elementwise.restype = _i
    # in, out, n, codec, vec, stream
    lib.doppler_probe_elementwise.argtypes = [_vp, _vp, ctypes.c_longlong, _i,
                                              _i, _vp]
    lib.doppler_chain_shape.restype = _i
    # in, out, side, plans, B, L, tile, keep, mode, warps, split, depth,
    # stream
    lib.doppler_chain_shape.argtypes = [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                                        _i, _i, _i, _vp]
    lib.doppler_chain.restype = _i
    # in, out, plans, bank, carry_in, carry_out, C, B, L, P, Q, T, tile,
    # threads, R, tap_stride, tap_off, buf_off, smem, in_f32, out_f32, stream
    lib.doppler_chain.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                                  _i, _i, _i, _i, _i, _i, _i, _i,
                                  ctypes.c_longlong, _i, _i, _vp]
    lib.doppler_chain_fast.restype = _i
    # in, out, plans, taps, carry_in, carry_out, C, B, L, P, Q, T, D,
    # windows, threads, plane, g_off, x_off, smem, in_f32, out_f32, passes,
    # stream
    lib.doppler_chain_fast.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
                                       _i, _i, _i, _i, _i, _i, _i, _i, _i,
                                       ctypes.c_longlong, _i, _i, _i, _vp]
    lib.doppler_chain_fast_part.restype = _i
    # doppler_chain_fast's arguments but in_f32, out_f32 and passes; part,
    # side, stream
    lib.doppler_chain_fast_part.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _i,
                                            _i, _i, _i, _i, _i, _i, _i, _i, _i,
                                            _i, _i, ctypes.c_longlong, _i, _vp,
                                            _vp]
    lib.doppler_cascade.restype = _i
    # in, out, plans, banks, carry_in, carry_out, layout, S, C, B, L, tile,
    # threads, smem, in_f32, out_f32, stream
    lib.doppler_cascade.argtypes = [_vp, _vp, _vp, _vpp, _vpp, _vpp, _ip, _i,
                                    _i, _i, _i, _i, _i, ctypes.c_longlong, _i,
                                    _i, _vp]
    lib.doppler_cascade_fast.restype = _i
    # in, out, plans, taps, carry_in, carry_out, layout, S, B, L, windows,
    # slab, threads, smem, in_f32, out_f32, passes, stream
    lib.doppler_cascade_fast.argtypes = [_vp, _vp, _vp, _vpp, _vpp, _vpp, _ip,
                                         _i, _i, _i, _i, _i, _i,
                                         ctypes.c_longlong, _i, _i, _i, _vp]
    lib.doppler_cascade_fast_part.restype = _i
    # doppler_cascade_fast's arguments up to smem; out_f32, part, side,
    # stream
    lib.doppler_cascade_fast_part.argtypes = [_vp, _vp, _vp, _vpp, _vpp, _vpp,
                                              _ip, _i, _i, _i, _i, _i, _i,
                                              ctypes.c_longlong, _i, _i, _vp, _vp]
    lib.doppler_conv.restype = _i
    # xi, xq, taps, yi, yq, C, len, x_stride, M, start0, p0, P, Q, R, w_len,
    # layout (7 ints, geometry.ConvLayout.args), threads, smem, stream
    lib.doppler_conv.argtypes = [_vp, _vp, _vp, _vp, _vp, _i, _ll, _ll, _ll,
                                 _ll, _i, _i, _i, _i, _i, _ip, _i, _ll, _vp]
    lib.doppler_window.restype = _i
    # xi, xq, bank_rev, yi, yq, C, len, x_stride, M, rem0, off0, P, Q, T,
    # layout (9 ints, geometry.WindowLayout.args), threads, smem, stream
    lib.doppler_window.argtypes = [_vp, _vp, _vp, _vp, _vp, _i, _ll, _ll, _ll,
                                   _i, _ll, _i, _i, _i, _ip, _i, _ll, _vp]
    lib.doppler_error_string.restype = ctypes.c_char_p
    lib.doppler_error_string.argtypes = [_i]
    return lib


@functools.lru_cache(maxsize=None)
def shared_memory_limit(index: int | None) -> int:
    """Bytes of shared memory one CTA may take on CUDA device ``index``
    (None: the current device)."""
    import torch

    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def sm_count(index: int | None) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (None: the
    current device)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if rc != 0:
        name = load().doppler_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} ({name})")
