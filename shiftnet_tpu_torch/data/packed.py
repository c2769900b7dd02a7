"""Packed dataset format (.snpk): zero-decode video storage + native reader.

Counterpart of ``shiftnet_tpu/data/packed.py`` (the reference's LMDB
pipeline, ``basicsr/utils/lmdb_util.py``): frames are decoded once at pack
time and stored raw; training reads are memory-mapped gathers served by the
port's own copy of the C++ reader (``shiftnet_tpu_torch/native/
packed_reader.cpp``, host code) through ctypes, with a numpy-memmap
fallback where no C++ compiler is found.  The reader builds with ``g++`` at
first use into ``shiftnet_tpu_torch/_build/``, keyed on a hash of its
source.  The file format is the JAX package's, so either package reads the
other's packs.

  python -m shiftnet_tpu_torch.data.packed --pack ROOT OUT.snpk
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

from shiftnet_tpu_torch.data.video_dataset import _imread, finish_sample

MAGIC = 0x534E504B
_HEADER = struct.Struct('<II')
_VIDEO = struct.Struct('<QQQQQ')

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / 'native' / 'packed_reader.cpp'
BUILD_DIR = PKG / '_build'
CXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17', '-pthread']


def library_path() -> Path:
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f'libpackedreader_{h.hexdigest()[:16]}.so'


def build_native() -> Path | None:
    """Compile the C++ reader unless a library for this source exists;
    None where no C++ compiler is found or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        obj = Path(tmp) / out.name
        res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), '-o', str(obj)],
                             capture_output=True)
        if res.returncode != 0:
            return None
        os.replace(obj, out)  # atomic: concurrent builds race harmlessly
    return out


_lib: ctypes.CDLL | None = None


def _load_lib() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.snpk_open.restype = ctypes.c_void_p
    lib.snpk_open.argtypes = [ctypes.c_char_p]
    lib.snpk_close.argtypes = [ctypes.c_void_p]
    lib.snpk_close.restype = None
    i64p = np.ctypeslib.ndpointer(np.int64, flags='C')
    u8p = np.ctypeslib.ndpointer(np.uint8, flags='C,WRITEABLE')
    lib.snpk_read_clip_crop.restype = ctypes.c_int
    lib.snpk_read_clip_crop.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int64] * 7 + [u8p]
    lib.snpk_read_batch.restype = ctypes.c_int
    lib.snpk_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i64p, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u8p, ctypes.c_int64]
    _lib = lib
    return lib


def pack_video_folder(root: str, out_path: str, *,
                      n_frames_per_video: int | None = None) -> None:
    """Pack ``<root>/<video>/*`` image folders into one .snpk file."""
    videos = sorted(glob.glob(os.path.join(root, '*')))
    if not videos:
        raise FileNotFoundError(f'no videos under {root}')
    metas, frames_per_video = [], []
    for v in videos:
        frames = sorted(glob.glob(os.path.join(v, '*')))
        if n_frames_per_video:
            frames = frames[:n_frames_per_video]
        h, w, c = _imread(frames[0]).shape
        frames_per_video.append(frames)
        metas.append([len(frames), h, w, c, 0])
    offset = _HEADER.size + 8 + _VIDEO.size * len(metas)
    for m in metas:
        m[4] = offset
        offset += m[0] * m[1] * m[2] * m[3]
    with open(out_path, 'wb') as f:
        f.write(_HEADER.pack(MAGIC, 1))
        f.write(struct.pack('<Q', len(metas)))
        for m in metas:
            f.write(_VIDEO.pack(*m))
        for frames, m in zip(frames_per_video, metas):
            for p in frames:
                img = _imread(p)
                if img.shape != (m[1], m[2], m[3]):
                    raise ValueError(f'{p}: {img.shape}, video frames '
                                     f'{tuple(m[1:4])}')
                f.write(np.ascontiguousarray(img, np.uint8).tobytes())


class PackedVideoReader:
    """Random-access reader over a .snpk file: the native library, or the
    numpy memmap (``prefer_native=False``, or no C++ compiler).
    ``reader`` says which one reads."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        self._lib = _load_lib() if prefer_native else None
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.snpk_open(path.encode())
            if not self._handle:
                self._lib = None
        self.reader = 'native' if self._lib is not None else 'memmap'
        with open(path, 'rb') as f:
            magic, version = _HEADER.unpack(f.read(_HEADER.size))
            if (magic, version) != (MAGIC, 1):
                raise ValueError(f'{path}: not a version-1 .snpk file')
            (n_videos,) = struct.unpack('<Q', f.read(8))
            self.metas = [_VIDEO.unpack(f.read(_VIDEO.size))
                          for _ in range(n_videos)]
        self._mmap = np.memmap(path, np.uint8, 'r')

    def __len__(self):
        return len(self.metas)

    def video_shape(self, video: int) -> tuple[int, int, int, int]:
        n, h, w, c, _ = self.metas[video]
        return n, h, w, c

    def _check(self, video, frame0, n_seq, y, x, ph, pw):
        """The bounds the C++ reader checks (its return codes -1, -2, -3)."""
        if not 0 <= video < len(self.metas):
            raise IndexError(f'{self.path}: no video {video}')
        n, h, w, _, _ = self.metas[video]
        if frame0 < 0 or frame0 + n_seq > n:
            raise IndexError(f'frames {frame0}..{frame0 + n_seq} of {n}')
        if y < 0 or x < 0 or y + ph > h or x + pw > w:
            raise IndexError(f'crop ({y}, {x}) {ph}x{pw} of {h}x{w}')

    def read_clip_crop(self, video: int, frame0: int, n_seq: int,
                       y: int, x: int, ph: int, pw: int) -> np.ndarray:
        self._check(video, frame0, n_seq, y, x, ph, pw)
        n, h, w, c, off = self.metas[video]
        out = np.empty((n_seq, ph, pw, c), np.uint8)
        if self._lib is not None:
            rc = self._lib.snpk_read_clip_crop(
                self._handle, video, frame0, n_seq, y, x, ph, pw, out)
            if rc:
                raise IndexError(f'snpk_read_clip_crop: {rc}')
            return out
        frames = self._mmap[off:off + n * h * w * c].reshape(n, h, w, c)
        out[...] = frames[frame0:frame0 + n_seq, y:y + ph, x:x + pw]
        return out

    def read_batch(self, videos: Sequence[int], frame0s: Sequence[int],
                   ys: Sequence[int], xs: Sequence[int], n_seq: int,
                   ph: int, pw: int, n_threads: int = 4) -> np.ndarray:
        for args in zip(videos, frame0s, ys, xs):
            self._check(args[0], args[1], n_seq, args[2], args[3], ph, pw)
        c = self.metas[videos[0]][3]
        out = np.empty((len(videos), n_seq, ph, pw, c), np.uint8)
        if self._lib is not None:
            rc = self._lib.snpk_read_batch(
                self._handle, len(videos),
                np.asarray(videos, np.int64), np.asarray(frame0s, np.int64),
                np.asarray(ys, np.int64), np.asarray(xs, np.int64),
                n_seq, ph, pw, c, out.reshape(-1), n_threads)
            if rc:
                raise IndexError(f'snpk_read_batch: {rc}')
            return out
        for i in range(len(videos)):
            out[i] = self.read_clip_crop(videos[i], frame0s[i], n_seq,
                                         ys[i], xs[i], ph, pw)
        return out

    def close(self):
        if self._lib is not None and self._handle:
            self._lib.snpk_close(self._handle)
            self._handle = None


class PackedVideoDataset:
    """Training dataset over packed .snpk files (drop-in for
    ``VideoFolderDataset``): flat window index, random-crop reads,
    flip/rot augmentation; pass both gt and lq packs for paired tasks.
    ``reader``: 'native' or 'memmap'."""

    def __init__(self, gt_path: str, lq_path: str | None = None, *,
                 n_seq: int, patch_size: int = 256, size_must_mode: int = 4,
                 augment: bool = True):
        self.gt = PackedVideoReader(gt_path)
        self.lq = PackedVideoReader(lq_path) if lq_path else None
        if self.lq is not None and len(self.gt) != len(self.lq):
            raise ValueError(f'{gt_path}: {len(self.gt)} videos, {lq_path}: '
                             f'{len(self.lq)}')
        self.reader = self.gt.reader
        self.n_seq = n_seq
        self.patch_size = patch_size
        self.size_must_mode = size_must_mode
        self.augment = augment
        self.index = [(v, f0) for v in range(len(self.gt))
                      for f0 in range(self.gt.video_shape(v)[0] - n_seq + 1)]

    def __len__(self):
        return len(self.index)

    def load(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        v, f0 = self.index[idx]
        _, h, w, _ = self.gt.video_shape(v)
        p = self.patch_size - self.patch_size % self.size_must_mode
        iy = int(rng.integers(0, h - self.patch_size + 1))
        ix = int(rng.integers(0, w - self.patch_size + 1))
        gt = self.gt.read_clip_crop(v, f0, self.n_seq, iy, ix, p, p)
        lq = (self.lq.read_clip_crop(v, f0, self.n_seq, iy, ix, p, p)
              if self.lq is not None else None)
        return finish_sample(gt, lq, self.augment, rng)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--build', action='store_true', help='build the reader')
    ap.add_argument('--pack', nargs=2, metavar=('ROOT', 'OUT'),
                    help='pack <root>/<video>/* into OUT.snpk')
    args = ap.parse_args()
    if args.build:
        print(build_native() or 'build failed')
    if args.pack:
        pack_video_folder(args.pack[0], args.pack[1])
        print(f'packed {args.pack[0]} -> {args.pack[1]}')
