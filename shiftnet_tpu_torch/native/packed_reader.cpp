// Packed video dataset reader — the native data plane.
//
// The port's own copy of native/packed_reader.cpp (same format, same C ABI),
// built with g++ at first use into shiftnet_tpu_torch/_build/.
//
// Replaces the reference's LMDB pipeline (basicsr/utils/lmdb_util.py,
// create_lmdb.py + file_client.py lmdb backend) with a simpler, faster
// memory-mapped format: one .snpk file holds all frames of a dataset as raw
// uint8 HWC, with a header index. Training reads are random (clip, window,
// crop) gathers; this library serves them via mmap + row-wise memcpy with a
// std::thread pool, bypassing image decoding entirely (decode happens once
// at pack time). Exposed through a C ABI consumed via ctypes
// (shiftnet_tpu_torch/data/packed.py).
//
// Format (little endian):
//   magic  u32 = 0x534E504B ('SNPK')
//   version u32 = 1
//   n_videos u64
//   per video: n_frames u64, height u64, width u64, channels u64, offset u64
//     (offset = byte offset of the video's first frame in the file)
//   frame data: raw uint8, frame-major, HWC
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct VideoMeta {
  uint64_t n_frames, h, w, c, offset;
};

struct PackedFile {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<VideoMeta> videos;
};

}  // namespace

extern "C" {

// Open a packed file; returns an opaque handle or nullptr on failure.
void* snpk_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(base, st.st_size, MADV_RANDOM);

  auto* pf = new PackedFile;
  pf->fd = fd;
  pf->base = static_cast<const uint8_t*>(base);
  pf->size = st.st_size;

  const uint8_t* p = pf->base;
  uint32_t magic, version;
  memcpy(&magic, p, 4); p += 4;
  memcpy(&version, p, 4); p += 4;
  if (magic != 0x534E504Bu || version != 1) {
    munmap(base, st.st_size); ::close(fd); delete pf; return nullptr;
  }
  uint64_t n_videos;
  memcpy(&n_videos, p, 8); p += 8;
  pf->videos.resize(n_videos);
  for (uint64_t i = 0; i < n_videos; ++i) {
    memcpy(&pf->videos[i], p, sizeof(VideoMeta));
    p += sizeof(VideoMeta);
  }
  return pf;
}

void snpk_close(void* handle) {
  auto* pf = static_cast<PackedFile*>(handle);
  if (!pf) return;
  munmap(const_cast<uint8_t*>(pf->base), pf->size);
  ::close(pf->fd);
  delete pf;
}

int64_t snpk_num_videos(void* handle) {
  return static_cast<PackedFile*>(handle)->videos.size();
}

// meta_out: [n_frames, h, w, c] for the given video.
int snpk_video_meta(void* handle, int64_t video, int64_t* meta_out) {
  auto* pf = static_cast<PackedFile*>(handle);
  if (video < 0 || video >= (int64_t)pf->videos.size()) return -1;
  const VideoMeta& m = pf->videos[video];
  meta_out[0] = m.n_frames; meta_out[1] = m.h;
  meta_out[2] = m.w; meta_out[3] = m.c;
  return 0;
}

// Copy a (n_seq, ph, pw, c) crop window starting at frame `frame0`, top-left
// (y, x), into `out` (caller-allocated, contiguous uint8).
int snpk_read_clip_crop(void* handle, int64_t video, int64_t frame0,
                        int64_t n_seq, int64_t y, int64_t x,
                        int64_t ph, int64_t pw, uint8_t* out) {
  auto* pf = static_cast<PackedFile*>(handle);
  if (video < 0 || video >= (int64_t)pf->videos.size()) return -1;
  const VideoMeta& m = pf->videos[video];
  if (frame0 < 0 || frame0 + n_seq > (int64_t)m.n_frames) return -2;
  if (y < 0 || x < 0 || y + ph > (int64_t)m.h || x + pw > (int64_t)m.w)
    return -3;
  const size_t frame_bytes = (size_t)m.h * m.w * m.c;
  const size_t row_bytes = (size_t)m.w * m.c;
  const size_t crop_row = (size_t)pw * m.c;
  for (int64_t f = 0; f < n_seq; ++f) {
    const uint8_t* src = pf->base + m.offset + (frame0 + f) * frame_bytes +
                         (size_t)y * row_bytes + (size_t)x * m.c;
    uint8_t* dst = out + (size_t)f * ph * crop_row;
    for (int64_t r = 0; r < ph; ++r) {
      memcpy(dst + (size_t)r * crop_row, src + (size_t)r * row_bytes, crop_row);
    }
  }
  return 0;
}

// Batched variant: `n` independent (video, frame0, y, x) gathers of identical
// window geometry into one output buffer, parallelized over a thread pool.
int snpk_read_batch(void* handle, int64_t n, const int64_t* videos,
                    const int64_t* frame0s, const int64_t* ys,
                    const int64_t* xs, int64_t n_seq, int64_t ph, int64_t pw,
                    int64_t channels, uint8_t* out, int64_t n_threads) {
  const size_t sample_bytes = (size_t)n_seq * ph * pw * channels;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> pool;
  std::vector<int> rc(n, 0);
  for (int64_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        rc[i] = snpk_read_clip_crop(handle, videos[i], frame0s[i], n_seq,
                                    ys[i], xs[i], ph, pw,
                                    out + (size_t)i * sample_bytes);
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int64_t i = 0; i < n; ++i)
    if (rc[i] != 0) return rc[i];
  return 0;
}

}  // extern "C"
