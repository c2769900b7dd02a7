"""Build and load the port's CUDA kernels.

The sources under ``shiftnet_tpu_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, writes into ``shiftnet_tpu_torch/_build/`` (git-ignored)
and is keyed on a hash of the sources and flags, so a fresh checkout builds
everything on its first call and a changed source rebuilds.  A missing
``nvcc`` or a failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / 'csrc'
BUILD_DIR = PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: each returns the cudaError_t of its launch.
SIGNATURES = {
    'shiftnet_cab_front': [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    'shiftnet_cab_back': [_I, _P, _P, _P, _P, _I, ctypes.c_longlong, _P],
    'shiftnet_conv': [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    'shiftnet_up_skip': [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA '
                       'kernels cannot be built')


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libshiftnet_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
           *[str(s) for s in sorted(CSRC.glob('*.cu'))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{res.stderr}')
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')
