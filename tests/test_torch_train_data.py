"""The port's training data layer against the JAX package's, on the CPU:
the window index, the crops and augmentation (byte for byte for one numpy
seed), the sampler's shards and enlarge ratio, the loader's batch stream
and its ``start_batch`` skip, the device staging, and the ``.snpk`` packs
(each package reads the other's; the port's native reader equals its
memmap fallback and checks bounds)."""
import numpy as np
import pytest
from PIL import Image

from shiftnet_tpu.data import packed as jpacked
from shiftnet_tpu.data.loader import PrefetchLoader as JaxLoader
from shiftnet_tpu.data.video_dataset import (
    ShardedEpochSampler as JaxSampler, VideoFolderDataset as JaxDataset)
from shiftnet_tpu.train.trainer import staged_batches as jax_staged
from shiftnet_tpu_torch.data import packed
from shiftnet_tpu_torch.data.loader import (DeviceStager, PrefetchLoader,
                                            staged_batches)
from shiftnet_tpu_torch.data.video_dataset import (ShardedEpochSampler,
                                                   VideoFolderDataset)


@pytest.fixture(scope='module')
def video_root(tmp_path_factory):
    """Two videos of 9 frames, 40x48, gt and blur of different content."""
    root = tmp_path_factory.mktemp('videos')
    rng = np.random.default_rng(0)
    for sub in ('gt', 'blur'):
        for v in ('vid_a', 'vid_b'):
            d = root / sub / v
            d.mkdir(parents=True)
            for i in range(9):
                img = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / f'{i:03d}.png')
    return str(root)


def assert_samples_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_window_index_matches_jax(video_root):
    kw = dict(n_seq=5, patch_size=32, n_frames_per_video=8)
    port, jax_ds = VideoFolderDataset(video_root, **kw), JaxDataset(
        video_root, **kw)
    assert len(port) == len(jax_ds) == 2 * (8 - 5 + 1)
    assert ([vars(r) for r in port.records]
            == [vars(r) for r in jax_ds.records])
    denoise = VideoFolderDataset(video_root, n_seq=3, lq_dir=None)
    assert all(r.lq_paths is None for r in denoise.records)


@pytest.mark.parametrize('augment', [True, False])
@pytest.mark.parametrize('patch', [16, 30])
def test_joint_crops_match_jax(video_root, augment, patch):
    """Crop, mod-crop and flip/rot from the same generator state: the
    port's clips equal JAX's byte for byte, gt and lq alike."""
    kw = dict(n_seq=3, patch_size=patch, augment=augment)
    port, jax_ds = VideoFolderDataset(video_root, **kw), JaxDataset(
        video_root, **kw)
    for idx, seed in ((0, 1), (4, 7), (9, 12), (13, 3)):
        got = port.load(idx, np.random.default_rng(seed))
        want = jax_ds.load(idx, np.random.default_rng(seed))
        assert got['gt'].shape == (3, patch - patch % 4, patch - patch % 4, 3)
        assert_samples_equal(got, want)


@pytest.mark.parametrize('n,ratio,shards', [(10, 1, 1), (10, 3, 1),
                                            (10, 1, 2), (7, 2, 3)])
def test_sampler_shards_and_ratio_match_jax(n, ratio, shards):
    for shard in range(shards):
        kw = dict(ratio=ratio, num_shards=shards, shard=shard, seed=5)
        port, jax_s = ShardedEpochSampler(n, **kw), JaxSampler(n, **kw)
        for epoch in range(3):
            np.testing.assert_array_equal(port.epoch_indices(epoch),
                                          jax_s.epoch_indices(epoch))
    full = np.concatenate([ShardedEpochSampler(
        n, ratio=ratio, num_shards=shards, shard=s, seed=5).epoch_indices(0)
        for s in range(shards)])
    assert len(full) == shards * -(-n * ratio // shards)


def take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    loader.stop()
    return out


@pytest.mark.parametrize('start', [0, 3, 7])
def test_loader_stream_and_start_batch_match_jax(video_root, start):
    """Batches 0..n of both loaders agree byte for byte, and start_batch k
    resumes each at batch k of the uninterrupted stream (7: into the second
    epoch of 7 windows / 2 per batch = 3 batches an epoch)."""
    ds = VideoFolderDataset(video_root, n_seq=3, patch_size=16,
                            n_frames_per_video=5)
    jds = JaxDataset(video_root, n_seq=3, patch_size=16,
                     n_frames_per_video=5)

    def loaders(k):
        return (PrefetchLoader(ds, ShardedEpochSampler(len(ds), seed=5),
                               batch_size=2, seed=5, start_batch=k),
                JaxLoader(jds, JaxSampler(len(jds), seed=5), batch_size=2,
                          seed=5, start_batch=k))

    full = take(loaders(0)[0], start + 2)
    port, jax_loader = loaders(start)
    got, want = take(port, 2), take(jax_loader, 2)
    for a, b, c in zip(got, want, full[start:]):
        assert a['gt'].shape == (2, 3, 16, 16, 3)
        assert_samples_equal(a, b)
        assert_samples_equal(a, c)


def test_staged_batches_order_and_lookahead():
    """As the JAX package's ``staged_batches`` (same test): every batch once,
    in order, batch N+1 staged before batch N is consumed."""
    for fn in (staged_batches, jax_staged):
        log = []

        def put(b):
            log.append(b['x'])
            return {'x': b['x'] * 10}

        seen = []
        for host, dev in fn(iter([{'x': i} for i in range(5)]), put):
            assert log[:len(seen) + 2] == list(range(min(len(seen) + 2, 5)))
            assert dev == {'x': host['x'] * 10}
            seen.append(host['x'])
        assert seen == log == [0, 1, 2, 3, 4]
        assert list(fn(iter([]), put)) == []


def test_device_stager_layout_on_cpu():
    batch = {'gt': np.random.default_rng(1).random((2, 3, 8, 12, 3),
                                                   np.float32)}
    stager = DeviceStager('cpu')
    out = stager.ready(stager.put(batch))
    assert out['gt'].shape == (2, 3, 3, 8, 12) and out['gt'].is_contiguous()
    np.testing.assert_array_equal(out['gt'].numpy(),
                                  batch['gt'].transpose(0, 1, 4, 2, 3))


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp('pack_src')
    rng = np.random.default_rng(3)
    truth = {}
    for v in ('a', 'b'):
        (root / v).mkdir()
        truth[v] = rng.integers(0, 255, (6, 24, 32, 3), dtype=np.uint8)
        for i, img in enumerate(truth[v]):
            Image.fromarray(img).save(root / v / f'{i:03d}.png')
    return root, truth


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_packs_read_across_packages(frames, tmp_path, writer):
    """A pack written by either package reads back the frames in the
    other's reader (memmap) and in the port's readers."""
    root, truth = frames
    path = str(tmp_path / 'ds.snpk')
    (packed if writer == 'port' else jpacked).pack_video_folder(str(root),
                                                                path)
    readers = [jpacked.PackedVideoReader(path, prefer_native=False),
               packed.PackedVideoReader(path, prefer_native=False),
               packed.PackedVideoReader(path)]
    assert [r.reader for r in readers[1:]] == ['memmap', 'native']
    for r in readers:
        assert len(r) == 2 and r.video_shape(1) == (6, 24, 32, 3)
        np.testing.assert_array_equal(r.read_clip_crop(0, 1, 3, 4, 6, 16, 16),
                                      truth['a'][1:4, 4:20, 6:22])
        np.testing.assert_array_equal(r.read_clip_crop(1, 0, 6, 0, 0, 24, 32),
                                      truth['b'])


def test_native_reader_matches_memmap_and_checks_bounds(frames, tmp_path):
    root, _ = frames
    path = str(tmp_path / 'ds.snpk')
    packed.pack_video_folder(str(root), path)
    assert packed.build_native().parent == packed.BUILD_DIR
    native = packed.PackedVideoReader(path)
    memmap = packed.PackedVideoReader(path, prefer_native=False)
    assert native.reader == 'native' and memmap.reader == 'memmap'
    args = ([0, 1, 0], [0, 2, 1], [0, 4, 8], [0, 2, 1])
    np.testing.assert_array_equal(
        native.read_batch(*args, n_seq=2, ph=12, pw=12, n_threads=3),
        memmap.read_batch(*args, n_seq=2, ph=12, pw=12))
    np.testing.assert_array_equal(native.read_clip_crop(1, 2, 4, 3, 5, 9, 11),
                                  memmap.read_clip_crop(1, 2, 4, 3, 5, 9, 11))
    for r in (native, memmap):
        for bad in ((0, 5, 3, 0, 0, 8, 8),     # frame overrun
                    (0, 0, 1, 20, 30, 8, 8),   # crop overrun
                    (2, 0, 1, 0, 0, 8, 8)):    # no such video
            with pytest.raises(IndexError):
                r.read_clip_crop(*bad)
    # the C++ reader's own check (its return code), past the Python one
    out = np.empty((3, 8, 8, 3), np.uint8)
    assert native._lib.snpk_read_clip_crop(native._handle, 0, 5, 3, 0, 0, 8,
                                           8, out) == -2
    native.close()


def test_packed_dataset_matches_jax(frames, tmp_path):
    root, _ = frames
    path = str(tmp_path / 'ds.snpk')
    packed.pack_video_folder(str(root), path)
    kw = dict(n_seq=3, patch_size=14)
    port = packed.PackedVideoDataset(path, path, **kw)
    jax_ds = jpacked.PackedVideoDataset(path, path, **kw)
    assert port.reader == 'native' and len(port) == len(jax_ds) == 8
    for idx, seed in ((0, 2), (5, 9), (7, 4)):
        assert_samples_equal(port.load(idx, np.random.default_rng(seed)),
                             jax_ds.load(idx, np.random.default_rng(seed)))
    fallback = packed.PackedVideoDataset(path, **kw)
    fallback.gt = packed.PackedVideoReader(path, prefer_native=False)
    assert fallback.gt.reader == 'memmap'
    np.testing.assert_array_equal(
        fallback.load(3, np.random.default_rng(1))['gt'],
        port.load(3, np.random.default_rng(1))['gt'])

