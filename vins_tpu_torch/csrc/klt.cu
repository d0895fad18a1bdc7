// Pyramidal inverse-compositional LK (K1, its one-level entry K4, and the
// fused forward-backward-NCC tracking kernel) and zero-mean patch NCC (K2)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vins_tpu/ops/klt_pallas.py:
//   vins_klt_pyramid (K1)  <- _klt_pyramid_kernel (klt_pallas.py:191),
//                             pallas_call :281, via track_pyramid_pallas
//   vins_klt_level (K4)    <- _klt_kernel (klt_pallas.py:67), pallas_call
//                             :134, via track_level_pallas: K1's code at
//                             L = 1 with a per-slot guess in that level's
//                             pixels, the flow written out instead of
//                             pts + flow ((pts + flow) - pts is not exact)
//   vins_patch_ncc (K2)    <- _ncc_kernel (klt_pallas.py:368), pallas_call
//                             :387, via patch_ncc_pallas
//   vins_klt_fb_ncc        <- the three launches vins_tpu/ops/klt.py:171-203
//                             makes on the TPU (K1 forward, K1 backward
//                             seeded with the negated forward flow, K2 on
//                             the forward result) with the post-filter of
//                             klt.py:147-153 after each pass and the gate
//                             of :203, in one launch
// Every window read is the port of _bilinear_patch (klt_pallas.py:27): the
// corner clamped to [0, W-win-1.001], a NaN corner read at 0, each tap a
// hand-written fp32 bilinear blend (texture filtering would round the
// fractions to 8 bits and break parity with the reference).
//
// What bounds this work on the card. Per slot and frame, tracking is up
// to 10 iterations x 3 levels x 2 directions of LK, each a 441-tap
// bilinear read of the next frame around the current flow, three sums
// over the window, and a 2x2 solve whose result gives the next read's
// address. The pixels all slots need are about 1 MB (chip_smoke.py
// counts them: a bound well under 1 us at 3.35 TB/s) and the operations
// under 0.1 us at the fp32 rate. What sets the time is the latency of
// that chain of dependent iterations: the kernel waits for its slowest
// slot, and some slots run all 30 iterations of a pass. One iteration is
// a chain of corner arithmetic, the tile taps, five shuffle stages, a
// block barrier, the exchange of the warp totals and the 2x2 solve; on an
// H100 the cross-warp exchange is its largest part
// (tools/torch_klt_ablation.py cuts each part out and times the rest;
// PERF.md has the numbers). For a caller that launches eagerly, the host
// work of the wrapper exceeds the kernel (chip_smoke.py's call_ms).
//
// The design against that latency:
// - One thread block of 256 threads per slot (M = 128 slots fill 128 of
//   the 132 SMs); thread t holds taps t and t + 256 of the 21x21 window.
//   256 is the smallest power of two that covers 441 taps in two, so the
//   per-iteration reduction runs over 8 warps.
// - Template windows staged ahead: each level's (win+1)^2 windows of the
//   template frame and its two gradients depend only on the points, so
//   at block start all levels' windows are issued into shared memory with
//   cp.async (16-byte copies of aligned chunks, 4-byte ones where a plane
//   is not 16-byte aligned; one commit group per level, coarsest first)
//   and each level waits only for its own group when it begins.
// - The next frame is read from a shared-memory tile of (win+1+2m)^2
//   pixels, m = kMargin = 8, staged around the level's starting corner
//   (its loads are in flight while the level waits for its templates)
//   and staged anew, block-wide, only when the clamped corner leaves it.
//   A restage costs one round trip to L2 whatever its size (6 loads a
//   thread, all in flight), so the wide margin is cheap, and an LK level
//   rarely moves its corner 8 px from where it started.
// - Reductions: the values are halved across a warp's lanes by shuffles
//   (Reducer), the 8 warp totals meet in shared memory, and every thread
//   adds them in one fixed order. Every thread so holds the same total,
//   the early exit (at most `iters` updates, |delta|^2 <= eps^2) is
//   block-uniform, and the result does not change from run to run. The
//   totals alternate between two buffers, so one barrier a reduction
//   suffices.
// - The fused kernel runs the forward pyramid, the post-filter, the
//   backward pyramid (its templates the next frame's windows around the
//   forward result, issued into the same buffers) and the NCC of the two
//   level-0 templates that each thread already holds in registers: K2's
//   two windows are exactly those templates, so no pixel is read twice
//   and tracking is one launch per frame instead of three.
// Gates as in the Pallas kernels: the min-eigenvalue gate sets `ok`,
// gated slots still iterate, dead input slots skip every level's loop.
//
// Neither wgmma nor TMA: each slot's sums are 441-long dot products over
// data-dependent windows, so there is no matrix product for wgmma; the
// windows are 22 floats wide (88 B rows) at arbitrary offsets, and a TMA
// tensor map would have to be encoded on the host for each of 24 planes
// every frame, while cp.async takes any 4-byte-aligned address.
//
// Built by vins_tpu_torch/ops/native.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: each extern "C" launcher enqueues on the given
// stream, does not synchronize, and returns cudaGetLastError().

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;           // one block per slot
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxLevels = 4;           // levels whose templates are staged
constexpr int kMargin = 8;              // next-frame tile margin, px
constexpr int kRed = 4;                 // values one reduction carries

template <int WIN>
struct Geom {
  static constexpr int kW1 = WIN + 1;                // bilinear window side
  // A staged window's rows: whole 16-byte chunks from the aligned column
  // at or left of the window's first (at most kW1 + 3 pixels).
  static constexpr int kWS = (kW1 + 3 + 3) / 4 * 4;  // row stride, floats
  static constexpr int kChunks = kWS / 4;            // chunks a row
  static constexpr int kWinPix = kW1 * kWS;          // staged floats
  static constexpr int kTile = kW1 + 2 * kMargin;    // tile side
  // Tile row stride = WIN (mod 32), so tap j's pixel sits in bank j: the
  // 32 taps of a warp read 32 banks.
  static constexpr int kTS = kTile + ((WIN - kTile) % 32 + 32) % 32;
  static constexpr int kTilePix = kTile * kTile;
  static constexpr int kTileLoads = (kTilePix + kThreads - 1) / kThreads;
  static constexpr int kTaps = WIN * WIN;
  static constexpr int kNT = (kTaps + kThreads - 1) / kThreads;  // taps/thread
};

template <int WIN>
struct Smem {
  alignas(16) float tmpl[kMaxLevels][3][Geom<WIN>::kWinPix];  // t, gx, gy
  float tile[Geom<WIN>::kTile * Geom<WIN>::kTS];  // next-frame tile
  alignas(16) float red[2][kWarps * kRed];        // reduction totals
};

template <int WIN>
struct NccSmem {
  alignas(16) float win[2][Geom<WIN>::kWinPix];
  alignas(16) float red[2][kWarps * kRed];
};

// One direction's planes, finest level first: the template frame and its
// gradients, and the frame it tracks into.
struct Planes {
  const float* tmpl[kMaxLevels];
  const float* gx[kMaxLevels];
  const float* gy[kMaxLevels];
  const float* next[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

// Block-wide sums of N <= kRed values; every thread returns the same
// totals, in a fixed order. Within a warp the four values are halved
// across the lanes (xor 16 and 8 trade two and one values, xor 4, 2, 1
// one each: 6 shuffles where a butterfly per value takes 20), so lane
// 8i ends with the warp's total of value i; the warp totals meet in
// shared memory, value-major, and every thread reads each value's eight
// as two 16-byte loads and adds them as a tree. Alternates between
// the two buffers of `red`, so the next call may write while slow
// threads still read this one's totals: one barrier a reduction.
struct Reducer {
  float (*red)[kWarps * kRed];
  int parity;

  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
    static_assert(N <= kRed && kRed == 4 && kWarps == 8,
                  "the reduction is written for 4 values and 8 warps");
    constexpr unsigned kAll = 0xffffffffu;
    float w[kRed];
#pragma unroll
    for (int i = 0; i < kRed; ++i) w[i] = i < N ? v[i] : 0.0f;
    const int lane = threadIdx.x & (kWarp - 1);
    const bool h16 = lane & 16;  // keeps values 2, 3; else 0, 1
    float k0 = h16 ? w[2] : w[0];
    float k1 = h16 ? w[3] : w[1];
    k0 += __shfl_xor_sync(kAll, h16 ? w[0] : w[2], 16);
    k1 += __shfl_xor_sync(kAll, h16 ? w[1] : w[3], 16);
    const bool h8 = lane & 8;    // keeps the odd value of its pair
    float k = h8 ? k1 : k0;
    k += __shfl_xor_sync(kAll, h8 ? k0 : k1, 8);
    k += __shfl_xor_sync(kAll, k, 4);
    k += __shfl_xor_sync(kAll, k, 2);
    k += __shfl_xor_sync(kAll, k, 1);
    float* buf = red[parity];
    parity ^= 1;
    if ((lane & 7) == 0) buf[(lane >> 3) * kWarps + threadIdx.x / kWarp] = k;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 a = reinterpret_cast<const float4*>(buf)[2 * i];
      const float4 b = reinterpret_cast<const float4*>(buf)[2 * i + 1];
      v[i] = ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w));
    }
  }
};

// The largest patch corner along an axis of n pixels, as _bilinear_patch
// clamps it: n - win - 1.001.
template <int WIN>
__device__ __forceinline__ float corner_limit(int n) {
  return (float)((double)(n - WIN) - 1.001);
}

// Clamp a patch corner to [0, (hx, hy)] and split it into integer and
// fractional parts. A NaN corner (a diverged track) reads the patch at 0;
// its slot fails the caller's finiteness test either way.
__device__ __forceinline__ void corner(float cx, float cy, float hx,
                                       float hy, int& ix, int& iy, float& fx,
                                       float& fy) {
  cx = fminf(fmaxf(cx, 0.0f), hx);
  cy = fminf(fmaxf(cy, 0.0f), hy);
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  ix = (int)flx;
  iy = (int)fly;
  fx = cx - flx;
  fy = cy - fly;
}

template <int WIN>
__device__ __forceinline__ void clamped_corner(float cx, float cy, int H,
                                               int W, int& ix, int& iy,
                                               float& fx, float& fy) {
  corner(cx, cy, corner_limit<WIN>(W), corner_limit<WIN>(H), ix, iy, fx,
         fy);
}

// The bilinear tap at p (top-left pixel) in rows of `stride` floats.
__device__ __forceinline__ float blend(const float* p, int stride, float fx,
                                       float fy) {
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float top = gy * (gx * p[0] + fx * p[1]);
  const float bot = fy * (gx * p[stride] + fx * p[stride + 1]);
  return top + bot;
}

// This thread's taps: their offsets in a window and in the tile, and
// whether they lie inside the WIN x WIN patch.
template <int WIN>
struct Taps {
  int win[Geom<WIN>::kNT];
  int tile[Geom<WIN>::kNT];
  bool on[Geom<WIN>::kNT];

  __device__ __forceinline__ Taps() {
#pragma unroll
    for (int k = 0; k < Geom<WIN>::kNT; ++k) {
      const int j = threadIdx.x + kThreads * k;
      on[k] = j < Geom<WIN>::kTaps;
      const int row = on[k] ? j / WIN : 0;
      const int col = on[k] ? j - row * WIN : 0;
      win[k] = row * Geom<WIN>::kWS + col;
      tile[k] = row * Geom<WIN>::kTS + col;
    }
  }
};

// Issue the (WIN+1)^2 window at (ix, iy) of `plane` into dst with
// cp.async (the caller commits). Row r of the window lands at
// dst + r * kWS + (ix & 3), so a tap reads the same offsets whatever the
// path: 16-byte copies of whole aligned chunks where the plane's rows
// are 16-byte aligned (the chunks never pass a row's end, since
// ix + WIN + 1 < W), 4-byte copies of the pixels elsewhere.
template <int WIN>
__device__ __forceinline__ void issue_window(float* dst,
                                             const float* __restrict__ plane,
                                             int W, int ix, int iy) {
  using G = Geom<WIN>;
  const float* src = plane + (size_t)iy * W;
  if ((reinterpret_cast<size_t>(plane) & 15) == 0 && (W & 3) == 0) {
    const int c0 = ix & ~3;
    const int n = (((ix + G::kW1 + 3) & ~3) - c0) / 4;  // chunks a row
    for (int e = threadIdx.x; e < G::kW1 * G::kChunks; e += kThreads) {
      const int row = e / G::kChunks;
      const int ch = e - row * G::kChunks;
      if (ch < n) {
        __pipeline_memcpy_async(dst + row * G::kWS + 4 * ch,
                                src + (size_t)row * W + c0 + 4 * ch,
                                4 * sizeof(float));
      }
    }
  } else {
    const int sx = ix & 3;
    for (int e = threadIdx.x; e < G::kW1 * G::kW1; e += kThreads) {
      const int row = e / G::kW1;
      const int col = e - row * G::kW1;
      __pipeline_memcpy_async(dst + row * G::kWS + sx + col,
                              src + (size_t)row * W + ix + col,
                              sizeof(float));
    }
  }
}

// Issue every level's template windows around (px, py) (level-0 pixels),
// coarsest level first, one commit group per level.
template <int WIN>
__device__ __forceinline__ void issue_templates(Smem<WIN>& sm,
                                                const Planes& P, int L,
                                                float px, float py) {
  const float r = (WIN - 1) / 2.0f;
  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const float scale = (float)(1 << lvl);
    int ix, iy;
    float fx, fy;
    clamped_corner<WIN>(px / scale - r, py / scale - r, P.H[lvl], P.W[lvl],
                        ix, iy, fx, fy);
    issue_window<WIN>(sm.tmpl[lvl][0], P.tmpl[lvl], P.W[lvl], ix, iy);
    issue_window<WIN>(sm.tmpl[lvl][1], P.gx[lvl], P.W[lvl], ix, iy);
    issue_window<WIN>(sm.tmpl[lvl][2], P.gy[lvl], P.W[lvl], ix, iy);
    __pipeline_commit();
  }
}

// Wait until at most `pending` of this thread's newest commit groups are
// still in flight (the finer levels' templates).
__device__ __forceinline__ void wait_templates(int pending) {
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    default: __pipeline_wait_prior(3); break;
  }
}

// The next-frame tile: kTile x kTile pixels (fewer where the plane is
// smaller) with its origin clamped into the plane, read around a corner.
template <int WIN>
struct Tile {
  int ox = 0, oy = 0, tw = 0, th = 0;
  float v[Geom<WIN>::kTileLoads];

  // Origin for corner (ix, iy), and this thread's loads into registers.
  __device__ __forceinline__ void load(const float* __restrict__ plane,
                                       int H, int W, int ix, int iy) {
    constexpr int kT = Geom<WIN>::kTile;
    tw = min(kT, W);
    th = min(kT, H);
    ox = min(max(ix - kMargin, 0), W - tw);
    oy = min(max(iy - kMargin, 0), H - th);
#pragma unroll
    for (int i = 0; i < Geom<WIN>::kTileLoads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int row = e / kT;
      const int col = e - row * kT;
      v[i] = (row < th && col < tw)
                 ? __ldg(plane + (size_t)(oy + row) * W + (ox + col))
                 : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* tile) const {
#pragma unroll
    for (int i = 0; i < Geom<WIN>::kTileLoads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      if (e < Geom<WIN>::kTilePix) {
        const int row = e / Geom<WIN>::kTile;
        tile[e + row * (Geom<WIN>::kTS - Geom<WIN>::kTile)] = v[i];
      }
    }
  }

  // Whether the window with corner (ix, iy) lies inside the tile.
  __device__ __forceinline__ bool holds(int ix, int iy) const {
    constexpr int kW1 = Geom<WIN>::kW1;
    return ix >= ox && iy >= oy && ix - ox <= tw - kW1 &&
           iy - oy <= th - kW1;
  }
};

struct LkOut {
  float flx, fly, err;
  bool ok;
};

// Pyramidal LK for one slot, run by the whole block: from the coarsest
// level with the guess (flx, fly) in that level's pixels, its templates
// already issued by issue_templates. t0 receives this thread's level-0
// template taps (0 outside the patch).
template <int WIN>
__device__ LkOut lk_pyramid(Smem<WIN>& sm, Reducer& red, const Planes& P,
                            int L, float px, float py, float flx, float fly,
                            bool alive, int iters, float eps2,
                            float (&t0)[Geom<WIN>::kNT]) {
  using G = Geom<WIN>;
  constexpr int NT = G::kNT;
  constexpr float kArea = (float)(WIN * WIN);
  const float r = (WIN - 1) / 2.0f;
  const Taps<WIN> taps;
  bool ok = alive;
  float err = 0.0f;
  Tile<WIN> tile;

  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const int H = P.H[lvl];
    const int W = P.W[lvl];
    const float scale = (float)(1 << lvl);
    const float plx = px / scale;
    const float ply = py / scale;
    const float hx = corner_limit<WIN>(W);
    const float hy = corner_limit<WIN>(H);

    int ix, iy;
    float fx, fy;
    // The tile's loads go out before the wait for the templates.
    if (alive) {
      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, fy);
      tile.load(P.next[lvl], H, W, ix, iy);
    }
    wait_templates(lvl);
    __syncthreads();

    corner(plx - r, ply - r, hx, hy, ix, iy, fx, fy);
    const int sx = ix & 3;  // the window's column in its staged rows
    float t[NT], tx[NT], ty[NT];
    float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (taps.on[k]) {
        const int o = sx + taps.win[k];
        t[k] = blend(sm.tmpl[lvl][0] + o, G::kWS, fx, fy);
        tx[k] = blend(sm.tmpl[lvl][1] + o, G::kWS, fx, fy);
        ty[k] = blend(sm.tmpl[lvl][2] + o, G::kWS, fx, fy);
      } else {
        t[k] = tx[k] = ty[k] = 0.0f;
      }
      s[0] += tx[k] * tx[k];
      s[1] += tx[k] * ty[k];
      s[2] += ty[k] * ty[k];
    }
    if (lvl == 0) {
#pragma unroll
      for (int k = 0; k < NT; ++k) t0[k] = t[k];
    }
    if (alive) tile.store(sm.tile);
    red.sum(s);  // its barrier also publishes the tile
    const float a = s[0], b = s[1], c = s[2];
    const float det = a * c - b * b;
    const float tr = a + c;
    const float min_eig =
        0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    ok = ok && (min_eig / kArea > 1e-4f);
    const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
    const float i00 = c * inv_det;
    const float i01 = -b * inv_det;
    const float i11 = a * inv_det;

    int it = 0;
    float d2 = alive ? INFINITY : 0.0f;
    float sabs = 0.0f;  // the last update's sum of |residual|
    while (it < iters && d2 > eps2) {
      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, fy);
      if (!tile.holds(ix, iy)) {
        // Every thread has read the old tile before the last barrier.
        tile.load(P.next[lvl], H, W, ix, iy);
        tile.store(sm.tile);
        __syncthreads();
      }
      const float* base = sm.tile + (iy - tile.oy) * G::kTS + (ix - tile.ox);
      float q[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        if (taps.on[k]) {
          const float diff = blend(base + taps.tile[k], G::kTS, fx, fy) -
                             t[k];
          q[0] += diff * tx[k];
          q[1] += diff * ty[k];
          q[2] += fabsf(diff);
        }
      }
      red.sum(q);
      const float dx = -(i00 * q[0] + i01 * q[1]);
      const float dy = -(i01 * q[0] + i11 * q[1]);
      flx += dx;
      fly += dy;
      sabs = q[2];
      d2 = dx * dx + dy * dy;
      ++it;
    }
    err = sabs / kArea;
    if (lvl > 0) {
      flx *= 2.0f;
      fly *= 2.0f;
    }
  }
  return LkOut{flx, fly, err, ok && alive};
}

// Zero-mean NCC of two patches from this thread's taps (0 outside the
// patch), as _ncc_kernel computes it.
template <int WIN>
__device__ __forceinline__ float ncc_of_taps(
    Reducer& red, const float (&ta)[Geom<WIN>::kNT],
    const float (&tb)[Geom<WIN>::kNT]) {
  constexpr int NT = Geom<WIN>::kNT;
  constexpr float kArea = (float)(WIN * WIN);
  const Taps<WIN> taps;
  float m[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    m[0] += ta[k];
    m[1] += tb[k];
  }
  red.sum(m);
  const float ma = m[0] / kArea;
  const float mb = m[1] / kArea;
  float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (taps.on[k]) {
      const float da = ta[k] - ma;
      const float db = tb[k] - mb;
      s[0] += da * da;
      s[1] += db * db;
      s[2] += da * db;
    }
  }
  red.sum(s);
  return s[2] * rsqrtf(s[0] * s[1] + 1e-12f);
}

// ops/klt.track_pyramid's post-filter: in bounds with a 1 px border,
// err < 0.35, finite.
__device__ __forceinline__ bool post_filter(float x, float y, float err,
                                            int H, int W) {
  const bool inb = x >= 1.0f && x < (float)W - 1.0f && y >= 1.0f &&
                   y < (float)H - 1.0f;
  return inb && err < 0.35f && isfinite(x) && isfinite(y);
}

// kFlowOut = false: K1, init_flow (may be null) is a level-0 prior scaled
// down to the coarsest level and pts_out = pts + flow. kFlowOut = true:
// K4, init_flow is the guess in the (single) level's pixels and
// pts_out = flow.
template <int WIN, bool kFlowOut>
__global__ void __launch_bounds__(kThreads)
klt_pyramid_kernel(const float* __restrict__ pts,
                   const float* __restrict__ init_flow,
                   const bool* __restrict__ valid, Planes P, int L,
                   int iters, float eps2, float* __restrict__ pts_out,
                   bool* __restrict__ ok_out, float* __restrict__ err_out) {
  __shared__ Smem<WIN> sm;
  Reducer red{sm.red, 0};
  const int slot = blockIdx.x;
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  float flx = 0.0f;
  float fly = 0.0f;
  if (init_flow != nullptr) {
    const float coarse = kFlowOut ? 1.0f : (float)(1 << (L - 1));
    flx = init_flow[2 * slot] / coarse;
    fly = init_flow[2 * slot + 1] / coarse;
  }
  issue_templates<WIN>(sm, P, L, px, py);
  float t0[Geom<WIN>::kNT];
  const LkOut o = lk_pyramid<WIN>(sm, red, P, L, px, py, flx, fly,
                                  valid[slot], iters, eps2, t0);
  if (threadIdx.x == 0) {
    pts_out[2 * slot] = kFlowOut ? o.flx : px + o.flx;
    pts_out[2 * slot + 1] = kFlowOut ? o.fly : py + o.fly;
    ok_out[slot] = o.ok;
    err_out[slot] = o.err;
  }
}

template <int WIN>
__global__ void __launch_bounds__(kThreads)
patch_ncc_kernel(const float* __restrict__ img_a,
                 const float* __restrict__ img_b, int H, int W,
                 const float* __restrict__ pts_a,
                 const float* __restrict__ pts_b, float* __restrict__ out) {
  using G = Geom<WIN>;
  __shared__ NccSmem<WIN> sm;
  Reducer red{sm.red, 0};
  const int slot = blockIdx.x;
  const float r = (WIN - 1) / 2.0f;
  int ia, ja, ib, jb;
  float fxa, fya, fxb, fyb;
  clamped_corner<WIN>(pts_a[2 * slot] - r, pts_a[2 * slot + 1] - r, H, W,
                      ia, ja, fxa, fya);
  clamped_corner<WIN>(pts_b[2 * slot] - r, pts_b[2 * slot + 1] - r, H, W,
                      ib, jb, fxb, fyb);
  issue_window<WIN>(sm.win[0], img_a, W, ia, ja);
  issue_window<WIN>(sm.win[1], img_b, W, ib, jb);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const Taps<WIN> taps;
  float ta[G::kNT], tb[G::kNT];
#pragma unroll
  for (int k = 0; k < G::kNT; ++k) {
    const int oa = (ia & 3) + taps.win[k];
    const int ob = (ib & 3) + taps.win[k];
    ta[k] = taps.on[k] ? blend(sm.win[0] + oa, G::kWS, fxa, fya) : 0.0f;
    tb[k] = taps.on[k] ? blend(sm.win[1] + ob, G::kWS, fxb, fyb) : 0.0f;
  }
  const float ncc = ncc_of_taps<WIN>(red, ta, tb);
  if (threadIdx.x == 0) out[slot] = ncc;
}

// Forward pass prev -> next, its post-filter, backward pass next -> prev
// seeded with the negated forward flow, its post-filter, the NCC of the
// two level-0 templates, and the forward-backward gate.
template <int WIN>
__global__ void __launch_bounds__(kThreads)
klt_fb_ncc_kernel(const float* __restrict__ pts,
                  const bool* __restrict__ valid, Planes fwd, Planes bwd,
                  int L, int iters, float eps2, float fb_thresh,
                  float ncc_min, float* __restrict__ fwd_pts,
                  bool* __restrict__ status, float* __restrict__ err_out,
                  float* __restrict__ ncc_out) {
  constexpr int NT = Geom<WIN>::kNT;
  __shared__ Smem<WIN> sm;
  Reducer red{sm.red, 0};
  const int slot = blockIdx.x;
  const int H = fwd.H[0];
  const int W = fwd.W[0];
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  const bool alive = valid[slot];

  issue_templates<WIN>(sm, fwd, L, px, py);
  float ta[NT], tb[NT];
  const LkOut f = lk_pyramid<WIN>(sm, red, fwd, L, px, py, 0.0f, 0.0f, alive,
                                  iters, eps2, ta);
  const float qx = px + f.flx;
  const float qy = py + f.fly;
  const bool fwd_ok = f.ok && post_filter(qx, qy, f.err, H, W) && alive;

  __syncthreads();  // the forward templates are read: reuse the buffers
  issue_templates<WIN>(sm, bwd, L, qx, qy);
  const float coarse = (float)(1 << (L - 1));
  const LkOut b = lk_pyramid<WIN>(sm, red, bwd, L, qx, qy,
                                  (px - qx) / coarse, (py - qy) / coarse,
                                  fwd_ok, iters, eps2, tb);
  const float bx = qx + b.flx;
  const float by = qy + b.fly;
  const bool bwd_ok = b.ok && post_filter(bx, by, b.err, H, W) && fwd_ok;

  const float ncc = ncc_of_taps<WIN>(red, ta, tb);
  if (threadIdx.x == 0) {
    const float dx = bx - px;
    const float dy = by - py;
    const float rt = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    fwd_pts[2 * slot] = qx;
    fwd_pts[2 * slot + 1] = qy;
    status[slot] = fwd_ok && bwd_ok && rt < fb_thresh && ncc > ncc_min;
    err_out[slot] = rt;
    ncc_out[slot] = ncc;
  }
}

// Fill one direction's planes from a host array of `stride` pointers per
// level (finest first): tmpl, gx, gy, next at offsets o[0..3].
bool fill_planes(Planes& P, const float* const* pl, int stride,
                 const int (&o)[4], const int* h, const int* w, int L) {
  if (L < 1 || L > kMaxLevels) return false;
  for (int l = 0; l < L; ++l) {
    P.tmpl[l] = pl[stride * l + o[0]];
    P.gx[l] = pl[stride * l + o[1]];
    P.gy[l] = pl[stride * l + o[2]];
    P.next[l] = pl[stride * l + o[3]];
    P.H[l] = h[l];
    P.W[l] = w[l];
  }
  return true;
}

}  // namespace

extern "C" {

// pts, init_flow (may be null): [M, 2] f32; valid: [M] bool.
// planes: host array of 4*L device pointers, per level (prev, gx, gy,
// next), finest first; Hs, Ws: host arrays of L ints; L <= 4.
// Outputs: pts_out [M, 2] f32 = pts + flow, ok_out [M] bool (gates &
// valid), err_out [M] f32.
int vins_klt_pyramid(const void* pts, const void* init_flow,
                     const void* valid, const void* planes, const void* Hs,
                     const void* Ws, int L, int M, int win, int iters,
                     float eps2, void* pts_out, void* ok_out, void* err_out,
                     void* stream) {
  Planes P;
  if (!fill_planes(P, static_cast<const float* const*>(planes), 4,
                   {0, 1, 2, 3}, static_cast<const int*>(Hs),
                   static_cast<const int*>(Ws), L))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (win) {
    case 21:  // FrontendConfig.klt_window, the only window in use
      klt_pyramid_kernel<21, false><<<M, kThreads, 0, s>>>(
          static_cast<const float*>(pts),
          static_cast<const float*>(init_flow),
          static_cast<const bool*>(valid), P, L, iters, eps2,
          static_cast<float*>(pts_out), static_cast<bool*>(ok_out),
          static_cast<float*>(err_out));
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
  Planes P;
  P.tmpl[0] = static_cast<const float*>(prev);
  P.gx[0] = static_cast<const float*>(gx);
  P.gy[0] = static_cast<const float*>(gy);
  P.next[0] = static_cast<const float*>(next);
  P.H[0] = H;
  P.W[0] = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (win) {
    case 21:
      klt_pyramid_kernel<21, true><<<M, kThreads, 0, s>>>(
          static_cast<const float*>(pts), static_cast<const float*>(guess),
          static_cast<const bool*>(valid), P, 1, iters, eps2,
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
  switch (win) {
    case 21:
      patch_ncc_kernel<21><<<M, kThreads, 0, s>>>(
          static_cast<const float*>(img_a), static_cast<const float*>(img_b),
          H, W, static_cast<const float*>(pts_a),
          static_cast<const float*>(pts_b), static_cast<float*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Forward-backward tracking with the NCC gate. pts: [M, 2] f32 level-0
// points in prev; valid: [M] bool. planes: host array of 6*L device
// pointers, per level (prev, gx_prev, gy_prev, next, gx_next, gy_next),
// finest first; Hs, Ws: host arrays of L ints; L <= 4. Outputs: fwd_pts
// [M, 2] f32, status [M] bool, err [M] f32 (the round-trip distance),
// ncc [M] f32.
int vins_klt_fb_ncc(const void* pts, const void* valid, const void* planes,
                    const void* Hs, const void* Ws, int L, int M, int win,
                    int iters, float eps2, float fb_thresh, float ncc_min,
                    void* fwd_pts, void* status, void* err, void* ncc,
                    void* stream) {
  const float* const* pl = static_cast<const float* const*>(planes);
  const int* h = static_cast<const int*>(Hs);
  const int* w = static_cast<const int*>(Ws);
  Planes fwd, bwd;
  if (!fill_planes(fwd, pl, 6, {0, 1, 2, 3}, h, w, L) ||
      !fill_planes(bwd, pl, 6, {3, 4, 5, 0}, h, w, L))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (win) {
    case 21:
      klt_fb_ncc_kernel<21><<<M, kThreads, 0, s>>>(
          static_cast<const float*>(pts), static_cast<const bool*>(valid),
          fwd, bwd, L, iters, eps2, fb_thresh, ncc_min,
          static_cast<float*>(fwd_pts), static_cast<bool*>(status),
          static_cast<float*>(err), static_cast<float*>(ncc));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
