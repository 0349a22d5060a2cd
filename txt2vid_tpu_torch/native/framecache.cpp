// Packed video frame-cache reader: the native data-path component of
// txt2vid_tpu_torch (the port's own copy of txt2vid_tpu/native/framecache.cpp,
// the same file format and C interface).
//
// An mmap'd single-file cache with O(1) frame addressing and a thread pool
// that assembles (B, F, H, W, C) uint8 batches into caller-provided buffers
// without holding the Python GIL (ctypes releases it around the call). The
// host side of the input path (gather and batch assembly) runs here; the
// trainer copies the batch to the GPU from pinned memory.
//
// Built with g++ on first use by txt2vid_tpu_torch/data/packed.py.
//
// File format "T2VC1\0\0\0" (little-endian):
//   u64 magic, u64 num_videos,
//   per video: u64 data_offset, u32 T, u32 H, u32 W, u32 C
//   raw uint8 frame data, video-major, frame-minor.
//
// Exposed C ABI (ctypes): fc_open, fc_close, fc_num_videos, fc_video_shape,
// fc_read_batch.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>
#include <thread>
#include <atomic>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x0000314356325400ULL;  // "\0T2VC1\0\0" LE

struct VideoMeta {
    uint64_t offset;
    uint32_t t, h, w, c;
};

struct Cache {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t size = 0;
    std::vector<VideoMeta> videos;
};

}  // namespace

extern "C" {

void* fc_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { ::close(fd); return nullptr; }
    madvise(base, st.st_size, MADV_WILLNEED);

    auto* cache = new Cache();
    cache->fd = fd;
    cache->base = static_cast<const uint8_t*>(base);
    cache->size = st.st_size;

    const uint8_t* p = cache->base;
    uint64_t magic, n;
    memcpy(&magic, p, 8); p += 8;
    if (magic != kMagic) { delete cache; munmap(base, st.st_size); ::close(fd); return nullptr; }
    memcpy(&n, p, 8); p += 8;
    cache->videos.resize(n);
    for (uint64_t i = 0; i < n; ++i) {
        memcpy(&cache->videos[i].offset, p, 8); p += 8;
        memcpy(&cache->videos[i].t, p, 4); p += 4;
        memcpy(&cache->videos[i].h, p, 4); p += 4;
        memcpy(&cache->videos[i].w, p, 4); p += 4;
        memcpy(&cache->videos[i].c, p, 4); p += 4;
    }
    return cache;
}

void fc_close(void* handle) {
    auto* cache = static_cast<Cache*>(handle);
    if (!cache) return;
    munmap(const_cast<uint8_t*>(cache->base), cache->size);
    ::close(cache->fd);
    delete cache;
}

int64_t fc_num_videos(void* handle) {
    return static_cast<Cache*>(handle)->videos.size();
}

// out_shape: int64[4] receives {T, H, W, C} of video `idx`.
int fc_video_shape(void* handle, int64_t idx, int64_t* out_shape) {
    auto* cache = static_cast<Cache*>(handle);
    if (idx < 0 || static_cast<size_t>(idx) >= cache->videos.size()) return -1;
    const VideoMeta& m = cache->videos[idx];
    out_shape[0] = m.t; out_shape[1] = m.h; out_shape[2] = m.w; out_shape[3] = m.c;
    return 0;
}

// Gather `num_frames` frames for each of `batch` videos into `out`
// (batch, num_frames, H, W, C) uint8. frame_idx is (batch, num_frames).
// All videos must share (H, W, C). Returns 0 on success.
int fc_read_batch(void* handle, const int64_t* video_ids,
                  const int64_t* frame_idx, int64_t batch, int64_t num_frames,
                  uint8_t* out, int num_threads) {
    auto* cache = static_cast<Cache*>(handle);
    if (cache->videos.empty() || batch <= 0) return -1;
    const VideoMeta& m0 = cache->videos[video_ids[0]];
    const size_t frame_bytes = size_t(m0.h) * m0.w * m0.c;
    const size_t video_out_bytes = size_t(num_frames) * frame_bytes;

    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);
    auto worker = [&]() {
        for (int64_t b = next.fetch_add(1); b < batch; b = next.fetch_add(1)) {
            int64_t vid = video_ids[b];
            if (vid < 0 || static_cast<size_t>(vid) >= cache->videos.size()) {
                err.store(-2); continue;
            }
            const VideoMeta& m = cache->videos[vid];
            if (size_t(m.h) * m.w * m.c != frame_bytes) { err.store(-3); continue; }
            const uint8_t* src = cache->base + m.offset;
            uint8_t* dst = out + size_t(b) * video_out_bytes;
            for (int64_t f = 0; f < num_frames; ++f) {
                int64_t fi = frame_idx[b * num_frames + f];
                if (fi < 0 || fi >= m.t) { err.store(-4); break; }
                memcpy(dst + size_t(f) * frame_bytes,
                       src + size_t(fi) * frame_bytes, frame_bytes);
            }
        }
    };

    int nt = num_threads > 0 ? num_threads : 1;
    if (nt == 1 || batch == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nt);
        for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }
    return err.load();
}

}  // extern "C"
