// Pyramidal inverse-compositional LK (K1 and its one-level entry K4) and
// zero-mean patch NCC (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vins_tpu/ops/klt_pallas.py:
//   K1 klt_pyramid_kernel  <- _klt_pyramid_kernel (klt_pallas.py:191),
//                             called through track_pyramid_pallas (:302)
//   K4 klt_pyramid_kernel at L = 1 (vins_klt_level)
//                          <- _klt_kernel (klt_pallas.py:67), called
//                             through track_level_pallas (:167): one level,
//                             a per-slot guess in that level's pixels, and
//                             the flow written out instead of pts + flow
//                             ((pts + flow) - pts is not exact in fp32)
//   K2 patch_ncc_kernel    <- _ncc_kernel (klt_pallas.py:368),
//                             called through patch_ncc_pallas (:401)
// Both share clamped_corner/read_patch, the port of _bilinear_patch
// (klt_pallas.py:27): the patch corner is clamped to [0, W-win-1.001]
// and every tap is a hand-written fp32 bilinear blend (texture filtering
// would round the fractions to 8 bits and break parity with the
// reference).
//
// Work layout: one warp per feature slot; lane l holds taps l, l+32, ...
// of the win x win patch (14 taps at win = 21). The template and its two
// gradient patches stay in registers for the whole level; the three
// per-iteration sums are xor-butterfly warp shuffles, which leave the
// bitwise-identical total in every lane, so the early-exit loop
// (|delta|^2 <= eps^2, at most `iters` updates) is warp-uniform and never
// diverges. Dead input slots skip every level's loop; slots that fail the
// min-eigenvalue gate still iterate, as in the Pallas kernel.
//
// What bounds it on this card: at the main path's M = 128 slots the
// launch is 128 warps on 132 SMs, each a chain of dependent bilinear
// gathers (4 loads per tap) from the 12 pyramid planes (~6.5 MB of fp32
// at 640x480, 3 levels, of which the windows of the live slots touch
// about 0.7 MB: the byte bound chip_smoke.py counts is 0.2 us). The
// planes stay in device memory and are read
// through the 50 MB L2 with __ldg; nothing is staged in shared memory.
// The kernel is bound by gather latency, not by bytes or FLOPs; fusing
// the forward pass, the backward pass and K2 into one launch is later
// work.
//
// Built by vins_tpu_torch/ops/native.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: each extern "C" launcher enqueues on the given
// stream, does not synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLevels = 8;

struct Pyramid {
  const float* prev[kMaxLevels];
  const float* gx[kMaxLevels];
  const float* gy[kMaxLevels];
  const float* next[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, m);
  }
  return v;
}

// Clamp a patch corner like _bilinear_patch: x in [0, W-win-1.001]. A NaN
// corner (a diverged track) reads the patch at 0; its slot fails the
// caller's finiteness test either way.
template <int WIN>
__device__ __forceinline__ void clamped_corner(float cx, float cy, int H,
                                               int W, int& ix, int& iy,
                                               float& fx, float& fy) {
  const float hx = (float)((double)(W - WIN) - 1.001);
  const float hy = (float)((double)(H - WIN) - 1.001);
  cx = fminf(fmaxf(cx, 0.0f), hx);
  cy = fminf(fmaxf(cy, 0.0f), hy);
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  ix = (int)flx;
  iy = (int)fly;
  fx = cx - flx;
  fy = cy - fly;
}

// This lane's taps of the [WIN, WIN] bilinear patch with top-left at
// (ix + fx, iy + fy). Taps past WIN*WIN are 0.
template <int WIN, int NT>
__device__ __forceinline__ void read_patch(const float* __restrict__ img,
                                           int W, int ix, int iy, float fx,
                                           float fy, int lane,
                                           float (&out)[NT]) {
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int j = lane + kWarp * k;
    if (j < WIN * WIN) {
      const int row = j / WIN;
      const int col = j - row * WIN;
      const float* p = img + (size_t)(iy + row) * W + (ix + col);
      const float a = __ldg(p);
      const float b = __ldg(p + 1);
      const float c = __ldg(p + W);
      const float d = __ldg(p + W + 1);
      const float top = gy * (gx * a + fx * b);
      const float bot = fy * (gx * c + fx * d);
      out[k] = top + bot;
    } else {
      out[k] = 0.0f;
    }
  }
}

// kFlowOut = false: K1, init_flow is a level-0 prior scaled down to the
// coarsest level and pts_out = pts + flow. kFlowOut = true: K4, init_flow
// is the guess in the (single) level's pixels and pts_out = flow.
template <int WIN, bool kFlowOut>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
klt_pyramid_kernel(const float* __restrict__ pts,
                   const float* __restrict__ init_flow,
                   const bool* __restrict__ valid, Pyramid pyr, int L,
                   int M, int iters, float eps2, float* __restrict__ pts_out,
                   bool* __restrict__ ok_out, float* __restrict__ err_out) {
  constexpr int NT = (WIN * WIN + kWarp - 1) / kWarp;
  constexpr float kArea = (float)(WIN * WIN);
  const int lane = threadIdx.x & (kWarp - 1);
  const int slot = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (slot >= M) return;  // whole warp exits together

  const float r = (WIN - 1) / 2.0f;
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  float flx = 0.0f;
  float fly = 0.0f;
  if (init_flow != nullptr) {
    const float coarse = kFlowOut ? 1.0f : (float)(1 << (L - 1));
    flx = init_flow[2 * slot] / coarse;
    fly = init_flow[2 * slot + 1] / coarse;
  }
  const bool alive = valid[slot];
  bool ok = alive;
  float err = 0.0f;

  float t[NT], tx[NT], ty[NT], cur[NT];
  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const int H = pyr.H[lvl];
    const int W = pyr.W[lvl];
    const float scale = (float)(1 << lvl);
    const float plx = px / scale;
    const float ply = py / scale;

    int ix, iy;
    float fx, fy;
    clamped_corner<WIN>(plx - r, ply - r, H, W, ix, iy, fx, fy);
    read_patch<WIN, NT>(pyr.prev[lvl], W, ix, iy, fx, fy, lane, t);
    read_patch<WIN, NT>(pyr.gx[lvl], W, ix, iy, fx, fy, lane, tx);
    read_patch<WIN, NT>(pyr.gy[lvl], W, ix, iy, fx, fy, lane, ty);
    float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      sa += tx[k] * tx[k];
      sb += tx[k] * ty[k];
      sc += ty[k] * ty[k];
    }
    const float a = warp_sum(sa);
    const float b = warp_sum(sb);
    const float c = warp_sum(sc);
    const float det = a * c - b * b;
    const float tr = a + c;
    const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det,
                                                   0.0f)));
    ok = ok && (min_eig / kArea > 1e-4f);
    const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
    const float i00 = c * inv_det;
    const float i01 = -b * inv_det;
    const float i11 = a * inv_det;

    int it = 0;
    float d2 = alive ? INFINITY : 0.0f;
    float err_l = 0.0f;
    while (it < iters && d2 > eps2) {
      clamped_corner<WIN>(plx + flx - r, ply + fly - r, H, W, ix, iy, fx,
                          fy);
      read_patch<WIN, NT>(pyr.next[lvl], W, ix, iy, fx, fy, lane, cur);
      float srx = 0.0f, sry = 0.0f, sad = 0.0f;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const float diff = cur[k] - t[k];
        srx += diff * tx[k];
        sry += diff * ty[k];
        sad += fabsf(diff);
      }
      const float rx = warp_sum(srx);
      const float ry = warp_sum(sry);
      const float sabs = warp_sum(sad);
      const float dx = -(i00 * rx + i01 * ry);
      const float dy = -(i01 * rx + i11 * ry);
      flx += dx;
      fly += dy;
      err_l = sabs / kArea;
      d2 = dx * dx + dy * dy;
      ++it;
    }
    err = err_l;
    if (lvl > 0) {
      flx *= 2.0f;
      fly *= 2.0f;
    }
  }
  if (lane == 0) {
    pts_out[2 * slot] = kFlowOut ? flx : px + flx;
    pts_out[2 * slot + 1] = kFlowOut ? fly : py + fly;
    ok_out[slot] = ok && alive;
    err_out[slot] = err;
  }
}

template <int WIN>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
patch_ncc_kernel(const float* __restrict__ img_a,
                 const float* __restrict__ img_b, int H, int W,
                 const float* __restrict__ pts_a,
                 const float* __restrict__ pts_b, int M,
                 float* __restrict__ out) {
  constexpr int NT = (WIN * WIN + kWarp - 1) / kWarp;
  constexpr float kArea = (float)(WIN * WIN);
  const int lane = threadIdx.x & (kWarp - 1);
  const int slot = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (slot >= M) return;

  const float r = (WIN - 1) / 2.0f;
  float ta[NT], tb[NT];
  int ix, iy;
  float fx, fy;
  clamped_corner<WIN>(pts_a[2 * slot] - r, pts_a[2 * slot + 1] - r, H, W,
                      ix, iy, fx, fy);
  read_patch<WIN, NT>(img_a, W, ix, iy, fx, fy, lane, ta);
  clamped_corner<WIN>(pts_b[2 * slot] - r, pts_b[2 * slot + 1] - r, H, W,
                      ix, iy, fx, fy);
  read_patch<WIN, NT>(img_b, W, ix, iy, fx, fy, lane, tb);
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    sa += ta[k];
    sb += tb[k];
  }
  const float ma = warp_sum(sa) / kArea;
  const float mb = warp_sum(sb) / kArea;
  float saa = 0.0f, sbb = 0.0f, sab = 0.0f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (lane + kWarp * k < WIN * WIN) {
      const float da = ta[k] - ma;
      const float db = tb[k] - mb;
      saa += da * da;
      sbb += db * db;
      sab += da * db;
    }
  }
  const float aa = warp_sum(saa);
  const float bb = warp_sum(sbb);
  const float ab = warp_sum(sab);
  if (lane == 0) out[slot] = ab * rsqrtf(aa * bb + 1e-12f);
}

inline dim3 grid_for(int M) {
  return dim3((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// pts, init_flow (may be null): [M, 2] f32; valid: [M] bool.
// planes: host array of 4*L device pointers, per level (prev, gx, gy,
// next), finest first; Hs, Ws: host arrays of L ints.
// Outputs: pts_out [M, 2] f32 = pts + flow, ok_out [M] bool (gates &
// valid), err_out [M] f32.
int vins_klt_pyramid(const void* pts, const void* init_flow,
                     const void* valid, const void* planes, const void* Hs,
                     const void* Ws, int L, int M, int win, int iters,
                     float eps2, void* pts_out, void* ok_out, void* err_out,
                     void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  Pyramid pyr;
  const float* const* pl = static_cast<const float* const*>(planes);
  const int* h = static_cast<const int*>(Hs);
  const int* w = static_cast<const int*>(Ws);
  for (int l = 0; l < L; ++l) {
    pyr.prev[l] = pl[4 * l + 0];
    pyr.gx[l] = pl[4 * l + 1];
    pyr.gy[l] = pl[4 * l + 2];
    pyr.next[l] = pl[4 * l + 3];
    pyr.H[l] = h[l];
    pyr.W[l] = w[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarp * kWarpsPerBlock);
  const float* p = static_cast<const float*>(pts);
  const float* g = static_cast<const float*>(init_flow);
  const bool* v = static_cast<const bool*>(valid);
  float* po = static_cast<float*>(pts_out);
  bool* oo = static_cast<bool*>(ok_out);
  float* eo = static_cast<float*>(err_out);
  switch (win) {
    case 21:  // FrontendConfig.klt_window, the only window in use
      klt_pyramid_kernel<21, false><<<grid_for(M), block, 0, s>>>(
          p, g, v, pyr, L, M, iters, eps2, po, oo, eo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4: one level. prev, gx, gy, next: [H, W] f32; pts, guess (may be
// null): [M, 2] f32 in this level's pixels; valid: [M] bool. Outputs:
// flow_out [M, 2] f32, ok_out [M] bool (gate & valid), err_out [M] f32.
int vins_klt_level(const void* prev, const void* gx, const void* gy,
                   const void* next, int H, int W, const void* pts,
                   const void* guess, const void* valid, int M, int win,
                   int iters, float eps2, void* flow_out, void* ok_out,
                   void* err_out, void* stream) {
  if (M <= 0) return 0;
  Pyramid pyr;
  pyr.prev[0] = static_cast<const float*>(prev);
  pyr.gx[0] = static_cast<const float*>(gx);
  pyr.gy[0] = static_cast<const float*>(gy);
  pyr.next[0] = static_cast<const float*>(next);
  pyr.H[0] = H;
  pyr.W[0] = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarp * kWarpsPerBlock);
  switch (win) {
    case 21:
      klt_pyramid_kernel<21, true><<<grid_for(M), block, 0, s>>>(
          static_cast<const float*>(pts), static_cast<const float*>(guess),
          static_cast<const bool*>(valid), pyr, 1, M, iters, eps2,
          static_cast<float*>(flow_out), static_cast<bool*>(ok_out),
          static_cast<float*>(err_out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// img_a, img_b: [H, W] f32; pts_a, pts_b: [M, 2] f32; out: [M] f32.
int vins_patch_ncc(const void* img_a, const void* img_b, int H, int W,
                   const void* pts_a, const void* pts_b, int M, int win,
                   void* out, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarp * kWarpsPerBlock);
  const float* a = static_cast<const float*>(img_a);
  const float* b = static_cast<const float*>(img_b);
  const float* pa = static_cast<const float*>(pts_a);
  const float* pb = static_cast<const float*>(pts_b);
  float* o = static_cast<float*>(out);
  switch (win) {
    case 21:
      patch_ncc_kernel<21><<<grid_for(M), block, 0, s>>>(a, b, H, W, pa, pb,
                                                         M, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
