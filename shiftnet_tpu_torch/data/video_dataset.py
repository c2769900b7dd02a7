"""Video clip datasets over frame folders, NHWC numpy.

Counterpart of ``shiftnet_tpu/data/video_dataset.py`` (the reference's
``VideoImageDataset``, ``basicsr/data/video_image_dataset.py``): a flat
index over all length-``n_seq`` windows of every video, joint random crop,
mod-crop, and 8-way flip/rot augmentation
(``basicsr/data/data_util.py:19-67``).

Frames are read with Pillow (the GPU machine has no imageio).  The numpy
draws for the crop and the augmentation come in the JAX package's order, so
one ``np.random.Generator`` state gives both packages byte-identical clips.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np


def _imread(path: str) -> np.ndarray:
    """An RGB uint8 frame, grey and alpha dropped as in
    ``shiftnet_tpu/data/video_dataset.py:_imread``.  Read with Pillow, the
    decoder imageio uses there for PNG and JPEG."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def augment_clip(img: np.ndarray, hflip: bool, vflip: bool,
                 rot90: bool) -> np.ndarray:
    """Flip / rotate a (T, H, W, C) clip, in the JAX package's order."""
    if hflip:
        img = img[:, :, ::-1]
    if vflip:
        img = img[:, ::-1]
    if rot90:
        img = np.rot90(img, axes=(1, 2))
    return img


def finish_sample(gt: np.ndarray, lq: np.ndarray | None, augment: bool,
                  rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Augment a cropped uint8 (gt, lq) pair with the same draw, and scale
    to float32 in [0, 1]."""
    if augment:
        flags = [rng.random() < 0.5 for _ in range(3)]
        gt = augment_clip(gt, *flags)
        if lq is not None:
            lq = augment_clip(lq, *flags)
    out = {'gt': np.ascontiguousarray(gt, dtype=np.float32) / 255.0}
    if lq is not None:
        out['lq'] = np.ascontiguousarray(lq, dtype=np.float32) / 255.0
    return out


@dataclasses.dataclass
class ClipRecord:
    lq_paths: tuple[str, ...] | None
    gt_paths: tuple[str, ...]
    video: str
    frame0: int


class VideoFolderDataset:
    """Flat window index over ``<root>/<gt_dir>/<video>/*`` (+ optional
    ``<lq_dir>``) frame folders."""

    def __init__(self, root: str, n_seq: int, *, gt_dir: str = 'gt',
                 lq_dir: str | None = 'blur', patch_size: int = 256,
                 size_must_mode: int = 4, augment: bool = True,
                 n_frames_per_video: int | None = None):
        self.n_seq = n_seq
        self.patch_size = patch_size
        self.size_must_mode = size_must_mode
        self.augment = augment
        gt_videos = sorted(glob.glob(os.path.join(root, gt_dir, '*')))
        if not gt_videos:
            raise FileNotFoundError(f'no videos under {root}/{gt_dir}')
        lq_videos = (sorted(glob.glob(os.path.join(root, lq_dir, '*')))
                     if lq_dir else [None] * len(gt_videos))
        if lq_dir and len(gt_videos) != len(lq_videos):
            raise ValueError(f'{root}: {len(gt_videos)} videos in {gt_dir}, '
                             f'{len(lq_videos)} in {lq_dir}')
        self.records: list[ClipRecord] = []
        for gv, lv in zip(gt_videos, lq_videos):
            gt_frames = sorted(glob.glob(os.path.join(gv, '*')))
            if n_frames_per_video:
                gt_frames = gt_frames[:n_frames_per_video]
            lq_frames = None
            if lv is not None:
                lq_frames = sorted(glob.glob(os.path.join(lv, '*')))
                if n_frames_per_video:
                    lq_frames = lq_frames[:n_frames_per_video]
                if len(lq_frames) != len(gt_frames):
                    raise ValueError(f'{gv}: {len(gt_frames)} frames, {lv}: '
                                     f'{len(lq_frames)}')
            name = os.path.basename(gv)
            for f0 in range(len(gt_frames) - n_seq + 1):
                self.records.append(ClipRecord(
                    tuple(lq_frames[f0:f0 + n_seq]) if lq_frames else None,
                    tuple(gt_frames[f0:f0 + n_seq]), name, f0))

    def __len__(self) -> int:
        return len(self.records)

    def load(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        """One training sample: random-crop + augmented clip windows,
        {'lq': (T, p, p, 3) float32 in [0, 1] or absent, 'gt': ...}."""
        rec = self.records[idx]
        gt = np.stack([_imread(p) for p in rec.gt_paths])  # (T, H, W, 3)
        lq = (np.stack([_imread(p) for p in rec.lq_paths])
              if rec.lq_paths else None)
        _, h, w, _ = gt.shape
        p = self.patch_size
        iy = int(rng.integers(0, h - p + 1))
        ix = int(rng.integers(0, w - p + 1))
        pm = p - p % self.size_must_mode
        gt = gt[:, iy:iy + pm, ix:ix + pm]
        if lq is not None:
            lq = lq[:, iy:iy + pm, ix:ix + pm]
        return finish_sample(gt, lq, self.augment, rng)


class ShardedEpochSampler:
    """Epoch-seeded shuffled index stream with per-host sharding
    (``EnlargedSampler``, ``basicsr/data/data_sampler.py:37-50``): a
    permutation of a ``ratio``-enlarged index space mod dataset size,
    strided by host."""

    def __init__(self, n: int, *, ratio: int = 1, num_shards: int = 1,
                 shard: int = 0, seed: int = 0):
        self.n = n
        self.num_samples = -(-n * ratio // num_shards)
        self.total = self.num_samples * num_shards
        self.num_shards = num_shards
        self.shard = shard
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        idx = rng.permutation(self.total) % self.n
        return idx[self.shard::self.num_shards]
