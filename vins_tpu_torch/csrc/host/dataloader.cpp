// Native dataset loader: threaded PNG decode + prefetch queue.
//
// The port's copy of native/dataloader.cpp, with its in-order delivery
// deadlock repaired. There a decoded frame was admitted while the heap held
// fewer than queue_cap + workers frames; a worker that fetched a later
// index could fill the heap, and the worker holding the next in-order
// frame then waited for room that only delivering its own frame would
// free. Here frame i is admitted once i < next_deliver + queue_cap +
// n_workers, so the next in-order frame always fits and the heap still
// holds at most queue_cap + n_workers frames. n_workers is fixed before
// any thread starts (the original's threads read workers.size() while
// start() was still growing it). The C API is unchanged, and so is the
// PNG decoder but for its last step: a pixel is k / 255.0f, not
// k * (1/255), so the frames equal the port's Python decoder's exactly.
//
// The reference's IO path is iOS AVCapture + its record/playback reader
// (ViewController.mm:1555-1714). The offline equivalent here feeds the
// TPU pipeline from disk; pure-Python PNG decoding of 752x480 frames
// costs tens of milliseconds per image (unfiltering is serial per
// scanline), which would starve a >100 fps device pipeline. This loader
// decodes 8-bit grayscale PNGs (EuRoC cam0 format) on worker threads
// into float32 [0,1] buffers and hands them over through a bounded
// ring of slots, overlapping disk+decode with device compute.
//
// C API (ctypes-friendly, no pybind11 dependency):
//   vl_open(paths, n_paths, width, height, n_workers, queue_cap) -> handle
//   vl_next(handle, out_float32)  -> index of the frame written (or -1)
//   vl_close(handle)
//
// Build (vins_tpu_torch/io/native_build.py):
//   g++ -O3 -shared -fPIC dataloader.cpp -o libvinsloader.so -lz -lpthread
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Frame {
  long index = -1;
  std::vector<float> pixels;
};

// ---------------------------------------------------------------------------
// Minimal PNG (8-bit grayscale, non-interlaced) decoder.
// ---------------------------------------------------------------------------

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns true on success; fills `out` (w*h float32 in [0,1]).
static bool decode_png_gray8(const std::string& path, int want_w, int want_h,
                             float* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(sz);
  if (fread(data.data(), 1, sz, f) != size_t(sz)) {
    fclose(f);
    return false;
  }
  fclose(f);
  if (sz < 8 || memcmp(data.data(), "\x89PNG\r\n\x1a\n", 8) != 0) return false;

  uint32_t W = 0, H = 0;
  int bit_depth = 0, color_type = -1;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    const uint8_t* tag = &data[pos + 4];
    const uint8_t* chunk = &data[pos + 8];
    if (pos + 12 + len > data.size()) break;
    if (!memcmp(tag, "IHDR", 4)) {
      W = be32(chunk);
      H = be32(chunk + 4);
      bit_depth = chunk[8];
      color_type = chunk[9];
    } else if (!memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), chunk, chunk + len);
    } else if (!memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (bit_depth != 8 || color_type != 0) return false;  // gray8 only
  if (int(W) != want_w || int(H) != want_h) return false;

  const size_t stride = W + 1;
  std::vector<uint8_t> raw(stride * H);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;

  std::vector<uint8_t> prev(W, 0), line(W);
  for (uint32_t y = 0; y < H; ++y) {
    const uint8_t ft = raw[y * stride];
    const uint8_t* src = &raw[y * stride + 1];
    switch (ft) {
      case 0:
        memcpy(line.data(), src, W);
        break;
      case 1:  // Sub
        line[0] = src[0];
        for (uint32_t x = 1; x < W; ++x) line[x] = src[x] + line[x - 1];
        break;
      case 2:  // Up
        for (uint32_t x = 0; x < W; ++x) line[x] = src[x] + prev[x];
        break;
      case 3:  // Average
        line[0] = src[0] + (prev[0] >> 1);
        for (uint32_t x = 1; x < W; ++x)
          line[x] = src[x] + ((int(line[x - 1]) + int(prev[x])) >> 1);
        break;
      case 4:  // Paeth
        line[0] = src[0] + prev[0];
        for (uint32_t x = 1; x < W; ++x)
          line[x] = src[x] + paeth(line[x - 1], prev[x], prev[x - 1]);
        break;
      default:
        return false;
    }
    float* dst = out + size_t(y) * W;
    // A correctly rounded division, as numpy's uint8 / 255.0 in float32:
    // the frames equal the Python decoder's bit for bit (the original's
    // multiply by 1/255 is 1 ulp off on about half the values).
    for (uint32_t x = 0; x < W; ++x) dst[x] = float(line[x]) / 255.0f;
    prev = line;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Prefetching loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  long queue_cap = 4;
  long n_workers = 2;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  // Min-heap by index so frames are delivered in order.
  struct Cmp {
    bool operator()(const Frame* a, const Frame* b) const {
      return a->index > b->index;
    }
  };
  std::priority_queue<Frame*, std::vector<Frame*>, Cmp> ready;
  std::atomic<long> next_fetch{0};
  long next_deliver = 0;
  std::atomic<bool> stop{false};

  ~Loader() { shutdown(); }

  // Call once, after queue_cap and n_workers are set.
  void start() {
    workers.reserve(size_t(n_workers));
    for (long i = 0; i < n_workers; ++i)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    for (;;) {
      if (stop.load()) return;
      long idx = next_fetch.fetch_add(1);
      if (idx >= long(paths.size())) return;
      auto* fr = new Frame;
      fr->index = idx;
      fr->pixels.resize(size_t(width) * height);
      if (!decode_png_gray8(paths[idx], width, height, fr->pixels.data()))
        std::fill(fr->pixels.begin(), fr->pixels.end(), 0.0f);
      std::unique_lock<std::mutex> lk(mu);
      // Admission by index: the frame next() waits for is always
      // admitted.
      cv_push.wait(lk, [this, idx] {
        return stop.load() || idx < next_deliver + queue_cap + n_workers;
      });
      if (stop.load()) {
        delete fr;
        return;
      }
      ready.push(fr);
      cv_pop.notify_all();
    }
  }

  // Blocks until the next in-order frame is ready; returns its index or -1.
  long next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_deliver >= long(paths.size())) return -1;
    cv_pop.wait(lk, [this] {
      return stop.load() ||
             (!ready.empty() && ready.top()->index == next_deliver);
    });
    if (stop.load()) return -1;
    Frame* fr = ready.top();
    ready.pop();
    long idx = fr->index;
    ++next_deliver;
    cv_push.notify_all();
    lk.unlock();
    memcpy(out, fr->pixels.data(), fr->pixels.size() * sizeof(float));
    delete fr;
    return idx;
  }

  void shutdown() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    while (!ready.empty()) {
      delete ready.top();
      ready.pop();
    }
  }
};

}  // namespace

extern "C" {

void* vl_open(const char** paths, long n_paths, int width, int height,
              int n_workers, int queue_cap) {
  auto* l = new Loader;
  l->paths.assign(paths, paths + n_paths);
  l->width = width;
  l->height = height;
  l->queue_cap = queue_cap > 0 ? queue_cap : 4;
  l->n_workers = n_workers > 0 ? n_workers : 2;
  l->start();
  return l;
}

long vl_next(void* handle, float* out) {
  return static_cast<Loader*>(handle)->next(out);
}

void vl_close(void* handle) { delete static_cast<Loader*>(handle); }

// Standalone single-image decode (for tests / simple use).
int vl_decode_png(const char* path, int width, int height, float* out) {
  return decode_png_gray8(path, width, height, out) ? 0 : -1;
}

}  // extern "C"
