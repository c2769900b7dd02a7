"""Build and load the port's CUDA kernels.

The sources under ``shiftnet_tpu_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``: one ``nvcc``
process per source, all started together, then one link.  The build runs at
first use, writes into ``shiftnet_tpu_torch/_build/`` (git-ignored) and is
keyed on a hash of the sources and flags, so a fresh checkout builds
everything on its first call and a changed source rebuilds.  A missing
``nvcc`` or a failed build raises; nothing falls back to the plain versions.
``ptxas`` reports each kernel's registers and spills (``-Xptxas -v``) into a
text file beside the library, which ``ptxas_report`` reads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / 'csrc'
BUILD_DIR = PKG / '_build'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = [*ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas',
              '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
# C entry points: each returns the cudaError_t of its launch.
SIGNATURES = {
    'shiftnet_cab_front': [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P],
    'shiftnet_cab_back': [_I, _P, _P, _P, _P, _I, _LL, _I, _P],
    'shiftnet_conv': [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P],
    'shiftnet_up_skip': [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    'shiftnet_shift_round': [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    'shiftnet_naf_gate': [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _I, ctypes.c_float, _P],
    'shiftnet_naf_rep': [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    'shiftnet_naf_back': [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          ctypes.c_longlong, _I, _P],
    'shiftnet_conv_cat': [_I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P],
    'shiftnet_mm_loop': [_P, _P, _P, _I, _I, _I, _I, _LLP, _P],
    'shiftnet_block_copy': [_P, _P, _LLP, _I, _I, _LL, _LL, _I, _I, _I, _P],
    'shiftnet_param_probe': [_I, _P, _P, _I, _P],
    'shiftnet_block_copy_staged': [_P, _P, _LLP, _I, _I, _LL, _LL, _I,
                                   ctypes.c_float, _P],
    'shiftnet_block_copy_tma': [_P, _P, _LLP, _LLP, _I, _LLP, _I,
                                ctypes.c_float, _P, _P],
    'shiftnet_strided_copy': [_P, _P, _I, _I, _I, _I, _P],
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
    """Compile the kernels unless a library for these sources exists: every
    source in its own ``nvcc`` process, all in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob('*.cu')):
            obj = Path(tmp) / f'{src.stem}.o'
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed, logs = [], []
        for src, _, proc in jobs:  # wait for every compile, failed or not
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f'{src.name} ({proc.returncode}):\n{err}')
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        ptxas_log(out).write_text(''.join(logs))
        lib = Path(tmp) / 'lib.so'
        res = subprocess.run([nvcc, *ARCH, '-shared', '-o', str(lib),
                              *[str(obj) for _, obj, _ in jobs]],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                               f'{res.stderr}')
        os.replace(lib, out)
    return out


def ptxas_log(lib: Path) -> Path:
    """The ptxas report written beside a built library."""
    return lib.with_suffix('.ptxas.txt')


def ptxas_report() -> dict[str, dict]:
    """{mangled function: {'registers', 'spill' (bytes of spill stores and
    loads), 'serial' (ptxas serialized its wgmma instructions)}} from the
    built library's ptxas report."""
    report, name = {}, None
    for line in ptxas_log(library_path()).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            report[name] = {'registers': 0, 'spill': 0, 'serial': False}
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            report[name]['spill'] = int(m.group(1)) + int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            report[name]['registers'] = int(m.group(1))
        if 'wgmma' in line and 'serialized' in line:
            m = re.search(r"function '([^']+)'", line)
            for key in ([m.group(1)] if m else list(report)):
                report.setdefault(key, {'registers': 0, 'spill': 0,
                                        'serial': False})['serial'] = True
    return report


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
