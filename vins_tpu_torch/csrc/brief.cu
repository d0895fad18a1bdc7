// BRIEF words of keypoints on a blurred frame (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _patches_kernel (vins_tpu/ops/
// klt_pallas.py:329), called through extract_patches_pallas (:358) by
// vins_tpu/ops/brief.extract_brief (brief.py:89-101). On the TPU that
// kernel cuts a subpixel-aligned 49x49 bilinear patch per keypoint and a
// [N, 2401] x [2401, 256] one-hot difference matmul turns the patches into
// the 256 test bits. The matmul is exact (one +1, one -1, zeros), so here
// the two taps of each test pair are sampled directly and compared: the
// patch is never materialised, only the 512 taps the pattern reads.
//
// Semantics, as _bilinear_patch (klt_pallas.py:27-64) cuts the patch:
//   corner cx = clip(px - 24, 0, W - 49 - 1.001), ix = floor(cx),
//   fx = cx - ix (and the same in y); the tap at patch (row, col) is the
//   fp32 blend (1-fy)*((1-fx)*a + fx*b) + fy*((1-fx)*c + fx*d) of the four
//   pixels at (iy+row, ix+col) .. (iy+row+1, ix+col+1), in that order.
//   Bit k = tap(b_k) > tap(a_k), with the pattern's integer offsets added
//   to the patch centre (24, 24). Word w holds bits 32w .. 32w+31, bit j of
//   the word being bit 32w + j (brief._pack_bits). Rows with valid = false
//   are written as 0.
// Every blend step is an explicitly rounded __fmul_rn / __fadd_rn: nvcc
// would otherwise contract a*b + c into one fused multiply-add, change the
// rounding, and flip test pairs that tie to the last bit. With the
// explicit roundings the kernel equals its plain PyTorch version
// (ops/brief_cuda.extract_brief_words_plain) bit for bit.
//
// Work layout: one block of 256 threads per keypoint, thread k owning test
// pair k; the 32 comparisons of a warp become word (warp id) through
// __ballot_sync, whose bit j is lane j.
//
// What bounds it on this card: the work is a few MFLOP and the bytes are
// the pixels under the taps of the valid keypoints (about 0.49 MB of the
// 1.2 MB blurred plane at N = 512 and 0.2 MB at N = 128 on the main
// path's frames; read through L2 with __ldg) plus 32 B of output per
// keypoint; both bounds are well under a microsecond at the main path's
// N = 512 (keyframe insert) and N = 128 (ride-time attach), so the kernel
// is launch-bound there.
//
// Built by vins_tpu_torch/ops/native.py (nvcc -gencode
// arch=compute_90a,code=sm_90a) and bound with ctypes: the extern "C"
// launcher enqueues on the given stream, does not synchronize, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBits = 256;
constexpr int kHalf = 24;             // brief.PATCH_HALF
constexpr int kWin = 2 * kHalf + 1;   // 49x49 patch

__device__ __forceinline__ float tap(const float* __restrict__ img, int W,
                                     int x, int y, float fx, float fy,
                                     float gx, float gy) {
  const float* p = img + (size_t)y * W + x;
  const float a = __ldg(p);
  const float b = __ldg(p + 1);
  const float c = __ldg(p + W);
  const float d = __ldg(p + W + 1);
  const float top = __fmul_rn(gy, __fadd_rn(__fmul_rn(gx, a),
                                            __fmul_rn(fx, b)));
  const float bot = __fmul_rn(fy, __fadd_rn(__fmul_rn(gx, c),
                                            __fmul_rn(fx, d)));
  return __fadd_rn(top, bot);
}

__global__ void __launch_bounds__(kBits)
brief_words_kernel(const float* __restrict__ img, int H, int W,
                   const float* __restrict__ pts,
                   const bool* __restrict__ valid,
                   const int* __restrict__ pattern, int N,
                   int* __restrict__ words) {
  const int i = blockIdx.x;
  const int k = threadIdx.x;
  if (i >= N) return;
  // Corner clamp of _bilinear_patch; fmaxf/fminf send a NaN corner to 0.
  const float hx = (float)((double)(W - kWin) - 1.001);
  const float hy = (float)((double)(H - kWin) - 1.001);
  const float cx = fminf(fmaxf(__fsub_rn(pts[2 * i], (float)kHalf), 0.0f),
                         hx);
  const float cy = fminf(fmaxf(__fsub_rn(pts[2 * i + 1], (float)kHalf),
                               0.0f), hy);
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  const int ix = (int)flx + kHalf;
  const int iy = (int)fly + kHalf;
  const float fx = __fsub_rn(cx, flx);
  const float fy = __fsub_rn(cy, fly);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int4 pk = reinterpret_cast<const int4*>(pattern)[k];
  const float ta = tap(img, W, ix + pk.x, iy + pk.y, fx, fy, gx, gy);
  const float tb = tap(img, W, ix + pk.z, iy + pk.w, fx, fy, gx, gy);
  const unsigned word = __ballot_sync(0xffffffffu, tb > ta);
  if ((k & 31) == 0) {
    words[i * (kBits / 32) + (k >> 5)] = valid[i] ? (int)word : 0;
  }
}

}  // namespace

extern "C" {

// img: [H, W] f32 (the blurred frame); pts: [N, 2] f32 pixel (x, y);
// valid: [N] bool; pattern: [256, 4] int32 (ax, ay, bx, by) offsets in
// [-24, 24]; words: [N, 8] int32 bit patterns of the packed descriptors.
int vins_brief_words(const void* img, int H, int W, const void* pts,
                     const void* valid, const void* pattern, int N,
                     void* words, void* stream) {
  if (N <= 0) return 0;
  if (H < kWin + 2 || W < kWin + 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  brief_words_kernel<<<N, kBits, 0, s>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(pts),
      static_cast<const bool*>(valid), static_cast<const int*>(pattern), N,
      static_cast<int*>(words));
  return (int)cudaGetLastError();
}

}  // extern "C"
