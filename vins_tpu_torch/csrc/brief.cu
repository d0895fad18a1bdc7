// BRIEF words of keypoints (K3) for Hopper (sm_90a): from the raw frame,
// the Gaussian blur fused in, or from a frame blurred beforehand; and the
// patch entry, K3's own [N, win, win] output at any window (below, before
// the launchers).
//
// Replaces the Pallas TPU kernel _patches_kernel (vins_tpu/ops/
// klt_pallas.py:329), called through extract_patches_pallas (:358) by
// vins_tpu/ops/brief.extract_brief (brief.py:71-101), and, in the raw-frame
// entry, the full-frame Gaussian blur that extract_brief runs before it
// (vins_tpu/ops/image.gaussian_blur, image.py:70). On the TPU the patch
// kernel cuts a subpixel-aligned 49x49 bilinear patch per keypoint and a
// [N, 2401] x [2401, 256] one-hot difference matmul turns the patches into
// the 256 test bits. The matmul is exact (one +1, one -1, zeros), so here
// the two taps of each test pair are sampled directly and compared: the
// patch is never materialised, only the 512 taps the pattern reads.
//
// Semantics, as _bilinear_patch (klt_pallas.py:27-64) cuts the patch:
//   corner cx = clip(px - 24, 0, W - 49 - 1.001), x0 = floor(cx),
//   fx = cx - x0 (and the same in y); the tap at patch (row, col) is the
//   fp32 blend (1-fy)*((1-fx)*a + fx*b) + fy*((1-fx)*c + fx*d) of the four
//   blurred pixels at (y0+row, x0+col) .. (y0+row+1, x0+col+1), in that
//   order. Bit k = tap(b_k) > tap(a_k), with the pattern's integer offsets
//   added to the patch centre (24, 24). Word w holds bits 32w .. 32w+31,
//   bit j of the word being bit 32w + j (brief._pack_bits). Rows with
//   valid = false are written as 0.
// The blur is the port's plain one (ops/image._sep_filter with
// image.gaussian_taps(2.0, 2)): a 5-tap reflect-101 correlation along H,
// then along W, each output k0*x0 + k1*x1 + ... + k4*x4 summed left to
// right. Every multiply and add, of the blur and of the blend, is an
// explicitly rounded __fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*b + c into one fused multiply-add, change the rounding, and flip test
// pairs that tie to the last bit. With the explicit roundings both entries
// equal their plain PyTorch versions (ops/brief_cuda.extract_brief_raw_plain
// and extract_brief_words_plain) bit for bit.
//
// Work layout: one block of 256 threads per keypoint. The taps of a
// keypoint read the 50x50 blurred pixels [y0, y0 + 49] x [x0, x0 + 49],
// which are always inside the frame (x0 <= W - 51). The raw-frame entry
// stages the 54x54 raw window around them, rows y0-2 .. y0+51 and columns
// x0-2 .. x0+51, into shared memory with cp.async, each row or column
// outside the frame mapped through reflect-101 (-j below 0, 2n-2-j past
// the end, as image._reflect_index maps it). That per-axis reflection is
// exact for both passes: the vertical pass over the reflected raw rows
// gives the full-frame vertical pass at the window's rows, and its
// reflected columns are the vertical pass applied to the reflected raw
// columns, which is what the horizontal pass reflects. The vertical pass
// writes 50x54 values, the horizontal pass the 50x50 blurred window (into
// the raw window's buffer, free by then); then thread k owns test pair k,
// blends its two taps from shared memory, and the 32 comparisons of a warp
// become word (warp id) through __ballot_sync, whose bit j is lane j. The
// blurred-input entry runs the same kernel with the blur stage off: it
// stages the 50x50 blurred window directly.
//
// Staging: rows whose 54 (or 50) columns lie inside the frame, in a frame
// whose base is 16-byte aligned and whose width is a multiple of 4, are
// copied in whole 16-byte chunks from the aligned column at or left of the
// window's first, row r landing at r * kRS + (x0 & 3) in rows of kRS = 60
// floats; a reflected row index costs nothing (it is still one frame row).
// Other rows (reflected columns, a misaligned base) take 4-byte copies into
// the same layout, so the blur reads the same offsets whatever the path.
//
// What bounds it on this card: per valid keypoint the raw window is 11.7
// KB (read through L2, windows of nearby keypoints overlap) and the blur
// 47k rounded operations (9 per output of each pass), the taps 4.9k more;
// at the main path's N = 512 (keyframe insert) and N = 128 (ride-time
// attach) both bounds are under a microsecond (chip_smoke.py computes them
// from the run's inputs), so the kernel is bound by latency: one round
// trip to L2 for the window, two barrier-separated passes, the taps and
// the ballot. The design's gain is in what it removes: the full-frame blur
// of 640x480 pixels (28 eager launches and a 1.2 MB intermediate written
// and read back) becomes the few pixels the taps need, in the same launch.
// Tensor cores do not apply: the blur is exact fp32 in a fixed order.
// Resources (nvcc -Xptxas -v): the raw-frame entry 23,760 B of shared
// memory a block (54 rows of 60 floats, then the 50x54 vertical pass), the
// blurred-input entry 12,016 B, both 31 registers a thread; with 256
// threads a block, 8 blocks fit an SM (by threads), so every block of
// N = 512 is resident in one wave on 132 SMs.
//
// Built by vins_tpu_torch/ops/native.py (nvcc -gencode
// arch=compute_90a,code=sm_90a) and bound with ctypes: the extern "C"
// launchers enqueue on the given stream, do not synchronize, and return
// cudaGetLastError().

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBits = 256;            // threads a block, one per test pair
constexpr int kHalf = 24;             // brief.PATCH_HALF
constexpr int kWin = 2 * kHalf + 1;   // 49x49 patch
constexpr int kSide = kWin + 1;       // blurred pixels the taps read, per axis
constexpr int kTaps = 5;              // blur taps
constexpr int kRad = kTaps / 2;
constexpr int kRaw = kSide + 2 * kRad;  // raw window side, 54
// Staged row stride: whole 16-byte chunks from the aligned column at or
// left of the window's first, at most kRaw + 3 pixels, rounded up.
constexpr int kRS = (kRaw + 3 + 3) / 4 * 4;  // 60 floats
constexpr int kChunks = kRS / 4;
constexpr int kMaxPatchWin = 128;     // the patch entry's windows, 1..128

struct BlurTaps {
  float k[kTaps];
};

template <bool kBlur>
struct Smem {
  static constexpr int kStage = kBlur ? kRaw : kSide;  // staged window side
  alignas(16) float win[kStage * kRS];  // staged; then the blurred window
  float vert[kBlur ? kSide * kRaw : 1];  // the vertical pass
};

__device__ __forceinline__ int reflect101(int j, int n) {
  j = j < 0 ? -j : j;
  return j >= n ? 2 * n - 2 - j : j;
}

// Issue the S x S window of img with top-left (x0, y0), rows and columns
// outside the frame reflected, into dst with cp.async and commit it. Row r
// lands at dst + r * kRS + (x0 & 3).
template <int S>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ img, int H,
                                      int W, int x0, int y0) {
  const int sx = x0 & 3;
  const bool cols_in = x0 >= 0 && x0 + S <= W;
  if (cols_in && (reinterpret_cast<size_t>(img) & 15) == 0 && (W & 3) == 0) {
    // The chunks never pass a row's end: x0 + S <= W and W % 4 == 0.
    const int c0 = x0 & ~3;
    const int n = (((x0 + S + 3) & ~3) - c0) / 4;  // chunks a row
    for (int e = threadIdx.x; e < S * kChunks; e += kBits) {
      const int row = e / kChunks;
      const int ch = e - row * kChunks;
      if (ch < n) {
        const float* src = img + (size_t)reflect101(y0 + row, H) * W + c0;
        __pipeline_memcpy_async(dst + row * kRS + 4 * ch, src + 4 * ch,
                                4 * sizeof(float));
      }
    }
  } else {
    for (int e = threadIdx.x; e < S * S; e += kBits) {
      const int row = e / S;
      const int col = e - row * S;
      __pipeline_memcpy_async(
          dst + row * kRS + sx + col,
          img + (size_t)reflect101(y0 + row, H) * W + reflect101(x0 + col, W),
          sizeof(float));
    }
  }
  __pipeline_commit();
}

// k0*x[0] + k1*x[s] + ... + k4*x[4s], left to right, each step rounded.
__device__ __forceinline__ float blur5(const float* x, int s,
                                       BlurTaps t) {
  float acc = __fmul_rn(t.k[0], x[0]);
#pragma unroll
  for (int i = 1; i < kTaps; ++i) {
    acc = __fadd_rn(acc, __fmul_rn(t.k[i], x[i * s]));
  }
  return acc;
}

// The bilinear tap at p (top-left pixel) in rows of `stride` floats.
__device__ __forceinline__ float tap(const float* p, int stride, float fx,
                                     float fy, float gx, float gy) {
  const float top = __fmul_rn(gy, __fadd_rn(__fmul_rn(gx, p[0]),
                                            __fmul_rn(fx, p[1])));
  const float bot = __fmul_rn(fy, __fadd_rn(__fmul_rn(gx, p[stride]),
                                            __fmul_rn(fx, p[stride + 1])));
  return __fadd_rn(top, bot);
}

template <bool kBlur>
__global__ void __launch_bounds__(kBits)
brief_words_kernel(const float* __restrict__ img, int H, int W,
                   const float* __restrict__ pts,
                   const bool* __restrict__ valid,
                   const int* __restrict__ pattern, int N, BlurTaps taps,
                   int* __restrict__ words) {
  __shared__ Smem<kBlur> sm;
  const int i = blockIdx.x;
  const int k = threadIdx.x;
  if (i >= N) return;
  if (!valid[i]) {  // block-uniform: no copy, no barrier
    if (k < kBits / 32) words[i * (kBits / 32) + k] = 0;
    return;
  }
  // Corner clamp of _bilinear_patch; fmaxf/fminf send a NaN corner to 0.
  const float hx = (float)((double)(W - kWin) - 1.001);
  const float hy = (float)((double)(H - kWin) - 1.001);
  const float cx = fminf(fmaxf(__fsub_rn(pts[2 * i], (float)kHalf), 0.0f),
                         hx);
  const float cy = fminf(fmaxf(__fsub_rn(pts[2 * i + 1], (float)kHalf),
                               0.0f), hy);
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  const int x0 = (int)flx;
  const int y0 = (int)fly;
  const float fx = __fsub_rn(cx, flx);
  const float fy = __fsub_rn(cy, fly);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int4 pk = reinterpret_cast<const int4*>(pattern)[k];

  const float* blurred;  // the 50x50 blurred window
  int stride;
  if constexpr (kBlur) {
    const int wx = x0 - kRad;
    stage<kRaw>(sm.win, img, H, W, wx, y0 - kRad);
    const float* raw = sm.win + (wx & 3);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int e = k; e < kSide * kRaw; e += kBits) {  // along H
      const int r = e / kRaw;
      const int c = e - r * kRaw;
      sm.vert[e] = blur5(raw + r * kRS + c, kRS, taps);
    }
    __syncthreads();
    for (int e = k; e < kSide * kSide; e += kBits) {  // along W
      const int r = e / kSide;
      const int c = e - r * kSide;
      sm.win[e] = blur5(sm.vert + r * kRaw + c, 1, taps);
    }
    __syncthreads();
    blurred = sm.win;
    stride = kSide;
  } else {
    stage<kSide>(sm.win, img, H, W, x0, y0);
    __pipeline_wait_prior(0);
    __syncthreads();
    blurred = sm.win + (x0 & 3);
    stride = kRS;
  }
  const float ta = tap(blurred + (kHalf + pk.y) * stride + kHalf + pk.x,
                       stride, fx, fy, gx, gy);
  const float tb = tap(blurred + (kHalf + pk.w) * stride + kHalf + pk.z,
                       stride, fx, fy, gx, gy);
  const unsigned word = __ballot_sync(0xffffffffu, tb > ta);
  if ((k & 31) == 0) words[i * (kBits / 32) + (k >> 5)] = (int)word;
}

// The [win, win] patch of keypoint i (extract_patches_pallas's output):
// the corner clamped once, as above, each tap the same rounded blend as
// `tap`, so the patches equal extract_patches_plain bit for bit. One block
// of kBits threads a keypoint, each thread its taps j = threadIdx.x +
// kBits * k, read from L2: a patch is written once and read by nothing
// else in the launch, so staging it would only add a barrier.
__global__ void __launch_bounds__(kBits)
patches_kernel(const float* __restrict__ img, int H, int W,
               const float* __restrict__ pts, int win,
               float* __restrict__ out) {
  const int i = blockIdx.x;
  const float r = (win - 1) / 2.0f;
  const float hx = (float)((double)(W - win) - 1.001);
  const float hy = (float)((double)(H - win) - 1.001);
  const float cx = fminf(fmaxf(__fsub_rn(pts[2 * i], r), 0.0f), hx);
  const float cy = fminf(fmaxf(__fsub_rn(pts[2 * i + 1], r), 0.0f), hy);
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  const float fx = __fsub_rn(cx, flx);
  const float fy = __fsub_rn(cy, fly);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float* base = img + (size_t)(int)fly * W + (int)flx;
  float* o = out + (size_t)i * win * win;
  for (int j = threadIdx.x; j < win * win; j += kBits) {
    const int row = j / win;
    const int col = j - row * win;
    o[j] = tap(base + (size_t)row * W + col, W, fx, fy, gx, gy);
  }
}

template <bool kBlur>
int launch(const void* img, int H, int W, const void* pts, const void* valid,
           const void* pattern, int N, const BlurTaps& taps, void* words,
           void* stream) {
  if (N <= 0) return 0;
  if (H < kWin + 2 || W < kWin + 2) return (int)cudaErrorInvalidValue;
  brief_words_kernel<kBlur><<<N, kBits, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(pts),
      static_cast<const bool*>(valid), static_cast<const int*>(pattern), N,
      taps, static_cast<int*>(words));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: [H, W] f32 (the blurred frame); pts: [N, 2] f32 pixel (x, y);
// valid: [N] bool; pattern: [256, 4] int32 (ax, ay, bx, by) offsets in
// [-24, 24]; words: [N, 8] int32 bit patterns of the packed descriptors.
int vins_brief_words(const void* img, int H, int W, const void* pts,
                     const void* valid, const void* pattern, int N,
                     void* words, void* stream) {
  return launch<false>(img, H, W, pts, valid, pattern, N, BlurTaps{}, words,
                       stream);
}

// The same words from the raw frame img [H, W] f32, blurred in the kernel
// with the 5 taps at `taps` (host memory, float32; image.gaussian_taps).
int vins_brief_raw_words(const void* img, int H, int W, const void* pts,
                         const void* valid, const void* pattern,
                         const float* taps, int N, void* words,
                         void* stream) {
  BlurTaps t;
  for (int j = 0; j < kTaps; ++j) t.k[j] = taps[j];
  return launch<true>(img, H, W, pts, valid, pattern, N, t, words, stream);
}

// img: [H, W] f32; pts: [N, 2] f32 pixel (x, y); 1 <= win <= 128 and
// H, W >= win + 2; out: [N, win, win] f32 bilinear patches centred at pts.
int vins_extract_patches(const void* img, int H, int W, const void* pts,
                         int N, int win, void* out, void* stream) {
  if (win < 1 || win > kMaxPatchWin || H < win + 2 || W < win + 2)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  patches_kernel<<<N, kBits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(pts),
      win, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
