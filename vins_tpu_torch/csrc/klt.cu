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
// Two variants compute it. The 21x21 window at up to 4 levels, the window
// of default_config() and euroc_config(), runs a specialization with the
// window fixed at compile time (klt_*_kernel<21>): its taps, tile and
// staged templates have constant sizes, so its loops unroll and its
// template taps live in registers. Every other window from 1 to 128 and
// depth up to 32 levels runs the runtime-window variant (klt_*_kernel_r,
// below), which keeps the same arithmetic and guarantees. The
// specialization stays because the variant is slower at nearly the same
// point (its taps past two per thread re-blend their templates at each
// use; tools/torch_klt_domain_sweep.py times the fused kernel at windows
// 20 and 22 against the specialization at 21).
//
// The design against that latency (the specialization):
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
// The runtime-window variant, for any win in 1..128 and L in 1..32:
// - The same block of 256 threads a slot, Reducer, corner clamp, blend,
//   block-uniform early exit and gates. Thread t walks taps t, t + 256, ...
//   of the win x win window; the first two keep their template values in
//   registers (all of them up to win 22), the others blend theirs again
//   from the staged window at each use. A thread so holds the same
//   registers at any window (nvcc -Xptxas -v: 103 for the fused kernel,
//   110 for K1, 80 for K4 with 14 bytes spilled), where taps in registers
//   would need 3 x 64 of them at win 128; the price is three blends more
//   per tap and iteration past the cache.
// - Shared memory is dynamic, up to the card's opt-in limit (227 KB on an
//   H100; vins_klt_init sets cudaFuncAttributeMaxDynamicSharedMemorySize):
//   the reduction totals, the next-frame tile of (win+1+2m)^2 pixels and a
//   ring of R staged levels, R = min(L, 8, what fits beside the tile). The
//   R coarsest levels are issued at block start, coarsest first, one
//   commit group each; when a level ends, its slot takes level lvl - R.
//   A level waits for its own group: min(R - 1, lvl) newer groups may
//   still be in flight.
// - Where not even one level fits beside the tile (win >= 113; at win 128
//   the three windows take 204 KB and the tile 93 KB), R = 0 and every
//   template tap is read from L2 in place (the planes stay cached there).
// - The NCC of the fused kernel reads its two level-0 windows from L2 (the
//   ring has been refilled by then); K2 reads its windows the same way.
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

#include <algorithm>

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
// gradients, and the frame it tracks into; N levels at most.
template <int N>
struct PlanesN {
  const float* tmpl[N];
  const float* gx[N];
  const float* gy[N];
  const float* next[N];
  int H[N];
  int W[N];
};
using Planes = PlanesN<kMaxLevels>;

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
// still in flight (the finer levels' templates): up to kMaxLevels - 1 for
// the staged levels of the specialization, kRing - 1 for the ring.
__device__ __forceinline__ void wait_templates(int pending) {
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    case 3: __pipeline_wait_prior(3); break;
    case 4: __pipeline_wait_prior(4); break;
    case 5: __pipeline_wait_prior(5); break;
    case 6: __pipeline_wait_prior(6); break;
    default: __pipeline_wait_prior(7); break;
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

// ---------------------------------------------------------------------------
// The runtime-window variant: every window from 1x1 to kMaxWin x kMaxWin
// and up to kMaxLevelsR levels, the same arithmetic as the specialization
// above (corner clamp, blend, Reducer, early exit, gates).
// ---------------------------------------------------------------------------

constexpr int kMaxWin = 128;      // win + 1 <= 129: the Pallas read's bound
constexpr int kMaxLevelsR = 32;   // levels a launch takes
constexpr int kRing = 8;          // staged levels in flight at most
constexpr int kCache = 2;         // taps a thread keeps in registers
constexpr int kRedFloats = 2 * kWarps * kRed;

// The geometry of Geom<WIN>, from the window at run time.
struct GeomR {
  int win, w1, ws, win_pix, tile, ts;
  __host__ __device__ explicit GeomR(int w)
      : win(w), w1(w + 1), ws((w + 1 + 3 + 3) / 4 * 4), win_pix(w1 * ws),
        tile(w1 + 2 * kMargin), ts(tile + ((w - tile) % 32 + 32) % 32) {}
  // Floats of the tile (rounded up to whole 16-byte chunks) and of one
  // staged level (the template window and its two gradients).
  __host__ __device__ int tile_floats() const {
    return (tile * ts + 3) / 4 * 4;
  }
  __host__ __device__ int level_floats() const { return 3 * win_pix; }
};

using PlanesR = PlanesN<kMaxLevelsR>;

// The dynamic shared memory: the reduction totals, the next-frame tile and
// a ring of R staged levels (R = 0: templates are read from L2).
struct SmemR {
  float (*red)[kWarps * kRed];
  float* tile;
  float* ring;
  __device__ explicit SmemR(const GeomR& g) {
    extern __shared__ float4 dyn_smem[];
    float* base = reinterpret_cast<float*>(dyn_smem);
    red = reinterpret_cast<float (*)[kWarps * kRed]>(base);
    tile = base + kRedFloats;
    ring = tile + g.tile_floats();
  }
};

// This thread's taps j = threadIdx.x + kThreads * k of a win x win
// window, k = 0, 1, ..., as (row, col), stepped without a division.
struct TapWalk {
  int row, col, dr, dc, win;
  __device__ explicit TapWalk(int w) : win(w) {
    row = threadIdx.x / w;
    col = threadIdx.x - row * w;
    dr = kThreads / w;
    dc = kThreads - dr * w;
  }
  __device__ __forceinline__ bool on() const { return row < win; }
  __device__ __forceinline__ void next() {
    row += dr;
    col += dc;
    if (col >= win) {
      col -= win;
      ++row;
    }
  }
};

// A window read in place: its top-left pixel and row stride (a staged
// window in shared memory, a plane in device memory, or the tile).
struct Src {
  const float* p;
  int stride;
  __device__ __forceinline__ float at(int row, int col, float fx,
                                      float fy) const {
    return blend(p + row * stride + col, stride, fx, fy);
  }
};

__device__ __forceinline__ float corner_limit_r(int n, int win) {
  return (float)((double)(n - win) - 1.001);
}

// Issue the (win+1)^2 window at (ix, iy) of `plane` into dst, as
// issue_window lays it out.
__device__ __forceinline__ void issue_window_r(const GeomR& g, float* dst,
                                               const float* __restrict__ plane,
                                               int W, int ix, int iy) {
  const float* src = plane + (size_t)iy * W;
  if ((reinterpret_cast<size_t>(plane) & 15) == 0 && (W & 3) == 0) {
    const int chunks = g.ws / 4;
    const int c0 = ix & ~3;
    const int n = (((ix + g.w1 + 3) & ~3) - c0) / 4;  // chunks a row
    for (int e = threadIdx.x; e < g.w1 * chunks; e += kThreads) {
      const int row = e / chunks;
      const int ch = e - row * chunks;
      if (ch < n) {
        __pipeline_memcpy_async(dst + row * g.ws + 4 * ch,
                                src + (size_t)row * W + c0 + 4 * ch,
                                4 * sizeof(float));
      }
    }
  } else {
    const int sx = ix & 3;
    for (int e = threadIdx.x; e < g.w1 * g.w1; e += kThreads) {
      const int row = e / g.w1;
      const int col = e - row * g.w1;
      __pipeline_memcpy_async(dst + row * g.ws + sx + col,
                              src + (size_t)row * W + ix + col,
                              sizeof(float));
    }
  }
}

// Issue level lvl's three template windows around (px, py) (level-0
// pixels) into its ring slot, as one commit group.
__device__ __forceinline__ void issue_level_r(const GeomR& g, float* ring,
                                              int R, const PlanesR& P,
                                              int lvl, float px, float py) {
  const float r = (g.win - 1) / 2.0f;
  const float scale = ldexpf(1.0f, lvl);
  int ix, iy;
  float fx, fy;
  corner(px / scale - r, py / scale - r, corner_limit_r(P.W[lvl], g.win),
         corner_limit_r(P.H[lvl], g.win), ix, iy, fx, fy);
  float* slot = ring + (lvl % R) * g.level_floats();
  issue_window_r(g, slot, P.tmpl[lvl], P.W[lvl], ix, iy);
  issue_window_r(g, slot + g.win_pix, P.gx[lvl], P.W[lvl], ix, iy);
  issue_window_r(g, slot + 2 * g.win_pix, P.gy[lvl], P.W[lvl], ix, iy);
  __pipeline_commit();
}

// Fill the ring: the R coarsest levels, coarsest first.
__device__ __forceinline__ void issue_ring(const GeomR& g, float* ring, int R,
                                           const PlanesR& P, int L, float px,
                                           float py) {
  for (int k = 0; k < R; ++k) issue_level_r(g, ring, R, P, L - 1 - k, px, py);
}

// The next-frame tile of the runtime window, staged straight into shared
// memory (the caller publishes it with a barrier).
struct TileR {
  int ox = 0, oy = 0, tw = 0, th = 0;

  __device__ __forceinline__ void stage(const GeomR& g, float* sm,
                                        const float* __restrict__ plane,
                                        int H, int W, int ix, int iy) {
    tw = min(g.tile, W);
    th = min(g.tile, H);
    ox = min(max(ix - kMargin, 0), W - tw);
    oy = min(max(iy - kMargin, 0), H - th);
    for (int e = threadIdx.x; e < th * tw; e += kThreads) {
      const int row = e / tw;
      const int col = e - row * tw;
      sm[row * g.ts + col] = __ldg(plane + (size_t)(oy + row) * W + ox + col);
    }
  }

  __device__ __forceinline__ bool holds(const GeomR& g, int ix,
                                        int iy) const {
    return ix >= ox && iy >= oy && ix - ox <= tw - g.w1 &&
           iy - oy <= th - g.w1;
  }
};

// lk_pyramid at a runtime window. The first kCache taps of each thread keep
// their template values in registers; the others blend theirs again at
// each use from the staged window (or from L2 when R = 0), so a thread
// holds O(1) registers whatever the window. The ring's R coarsest levels
// were issued by issue_ring; a level's slot is refilled with level
// lvl - R as soon as the level ends.
__device__ LkOut lk_pyramid_r(const GeomR& g, SmemR& sm, int R, Reducer& red,
                              const PlanesR& P, int L, float px, float py,
                              float flx, float fly, bool alive, int iters,
                              float eps2) {
  const float area = (float)(g.win * g.win);
  const float r = (g.win - 1) / 2.0f;
  bool ok = alive;
  float err = 0.0f;
  TileR tile;

  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const int H = P.H[lvl];
    const int W = P.W[lvl];
    const float scale = ldexpf(1.0f, lvl);
    const float plx = px / scale;
    const float ply = py / scale;
    const float hx = corner_limit_r(W, g.win);
    const float hy = corner_limit_r(H, g.win);

    int ix, iy;
    float fx, fy;
    // Every thread has read the last level's tile before its last barrier.
    if (alive) {
      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, fy);
      tile.stage(g, sm.tile, P.next[lvl], H, W, ix, iy);
    }
    if (R > 0) wait_templates(min(R - 1, lvl));
    __syncthreads();  // publishes the staged templates and the tile

    corner(plx - r, ply - r, hx, hy, ix, iy, fx, fy);
    Src T, TX, TY;
    if (R > 0) {
      const float* slot = sm.ring + (lvl % R) * g.level_floats() + (ix & 3);
      T = Src{slot, g.ws};
      TX = Src{slot + g.win_pix, g.ws};
      TY = Src{slot + 2 * g.win_pix, g.ws};
    } else {
      const size_t o = (size_t)iy * W + ix;
      T = Src{P.tmpl[lvl] + o, W};
      TX = Src{P.gx[lvl] + o, W};
      TY = Src{P.gy[lvl] + o, W};
    }
    TapWalk walk(g.win);
    int crow[kCache], ccol[kCache];
    float t[kCache], tx[kCache], ty[kCache];
    float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      crow[k] = walk.row;
      ccol[k] = walk.col;
      if (walk.on()) {
        t[k] = T.at(walk.row, walk.col, fx, fy);
        tx[k] = TX.at(walk.row, walk.col, fx, fy);
        ty[k] = TY.at(walk.row, walk.col, fx, fy);
      } else {
        t[k] = tx[k] = ty[k] = 0.0f;
      }
      s[0] += tx[k] * tx[k];
      s[1] += tx[k] * ty[k];
      s[2] += ty[k] * ty[k];
      walk.next();
    }
    const TapWalk rest = walk;  // the taps past the cache
    for (; walk.on(); walk.next()) {
      const float gx = TX.at(walk.row, walk.col, fx, fy);
      const float gy = TY.at(walk.row, walk.col, fx, fy);
      s[0] += gx * gx;
      s[1] += gx * gy;
      s[2] += gy * gy;
    }
    red.sum(s);
    const float a = s[0], b = s[1], c = s[2];
    const float det = a * c - b * b;
    const float tr = a + c;
    const float min_eig =
        0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    ok = ok && (min_eig / area > 1e-4f);
    const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
    const float i00 = c * inv_det;
    const float i01 = -b * inv_det;
    const float i11 = a * inv_det;

    int it = 0;
    float d2 = alive ? INFINITY : 0.0f;
    float sabs = 0.0f;
    while (it < iters && d2 > eps2) {
      int jx, jy;
      float gfx, gfy;
      corner(plx + flx - r, ply + fly - r, hx, hy, jx, jy, gfx, gfy);
      if (!tile.holds(g, jx, jy)) {
        // Every thread has read the old tile before the last barrier.
        tile.stage(g, sm.tile, P.next[lvl], H, W, jx, jy);
        __syncthreads();
      }
      const Src cur{sm.tile + (jy - tile.oy) * g.ts + (jx - tile.ox), g.ts};
      float q[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kCache; ++k) {
        if (crow[k] < g.win) {
          const float diff = cur.at(crow[k], ccol[k], gfx, gfy) - t[k];
          q[0] += diff * tx[k];
          q[1] += diff * ty[k];
          q[2] += fabsf(diff);
        }
      }
      for (TapWalk u = rest; u.on(); u.next()) {
        const float diff = cur.at(u.row, u.col, gfx, gfy) -
                           T.at(u.row, u.col, fx, fy);
        q[0] += diff * TX.at(u.row, u.col, fx, fy);
        q[1] += diff * TY.at(u.row, u.col, fx, fy);
        q[2] += fabsf(diff);
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
    err = sabs / area;
    // Every thread read this level's slot before the last barrier: refill
    // it with the next level the ring does not hold yet.
    if (R > 0 && lvl - R >= 0) issue_level_r(g, sm.ring, R, P, lvl - R, px, py);
    if (lvl > 0) {
      flx *= 2.0f;
      fly *= 2.0f;
    }
  }
  return LkOut{flx, fly, err, ok && alive};
}

// Zero-mean NCC of the level-0 windows of a at (pax, pay) and of b at
// (pbx, pby), read from L2, as _ncc_kernel computes it.
__device__ float ncc_r(const GeomR& g, Reducer& red,
                       const float* __restrict__ a,
                       const float* __restrict__ b, int H, int W, float pax,
                       float pay, float pbx, float pby) {
  const float area = (float)(g.win * g.win);
  const float r = (g.win - 1) / 2.0f;
  const float hx = corner_limit_r(W, g.win);
  const float hy = corner_limit_r(H, g.win);
  int ia, ja, ib, jb;
  float fxa, fya, fxb, fyb;
  corner(pax - r, pay - r, hx, hy, ia, ja, fxa, fya);
  corner(pbx - r, pby - r, hx, hy, ib, jb, fxb, fyb);
  const Src A{a + (size_t)ja * W + ia, W};
  const Src B{b + (size_t)jb * W + ib, W};
  float m[2] = {0.0f, 0.0f};
  for (TapWalk w(g.win); w.on(); w.next()) {
    m[0] += A.at(w.row, w.col, fxa, fya);
    m[1] += B.at(w.row, w.col, fxb, fyb);
  }
  red.sum(m);
  const float ma = m[0] / area;
  const float mb = m[1] / area;
  float s[3] = {0.0f, 0.0f, 0.0f};
  for (TapWalk w(g.win); w.on(); w.next()) {
    const float da = A.at(w.row, w.col, fxa, fya) - ma;
    const float db = B.at(w.row, w.col, fxb, fyb) - mb;
    s[0] += da * da;
    s[1] += db * db;
    s[2] += da * db;
  }
  red.sum(s);
  return s[2] * rsqrtf(s[0] * s[1] + 1e-12f);
}

// klt_pyramid_kernel at a runtime window, R ring slots.
template <bool kFlowOut>
__global__ void __launch_bounds__(kThreads)
klt_pyramid_kernel_r(int win, int R, const float* __restrict__ pts,
                     const float* __restrict__ init_flow,
                     const bool* __restrict__ valid, PlanesR P, int L,
                     int iters, float eps2, float* __restrict__ pts_out,
                     bool* __restrict__ ok_out, float* __restrict__ err_out) {
  const GeomR g(win);
  SmemR sm(g);
  Reducer red{sm.red, 0};
  const int slot = blockIdx.x;
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  float flx = 0.0f;
  float fly = 0.0f;
  if (init_flow != nullptr) {
    const float coarse = kFlowOut ? 1.0f : ldexpf(1.0f, L - 1);
    flx = init_flow[2 * slot] / coarse;
    fly = init_flow[2 * slot + 1] / coarse;
  }
  issue_ring(g, sm.ring, R, P, L, px, py);
  const LkOut o = lk_pyramid_r(g, sm, R, red, P, L, px, py, flx, fly,
                               valid[slot], iters, eps2);
  if (threadIdx.x == 0) {
    pts_out[2 * slot] = kFlowOut ? o.flx : px + o.flx;
    pts_out[2 * slot + 1] = kFlowOut ? o.fly : py + o.fly;
    ok_out[slot] = o.ok;
    err_out[slot] = o.err;
  }
}

__global__ void __launch_bounds__(kThreads)
patch_ncc_kernel_r(int win, const float* __restrict__ img_a,
                   const float* __restrict__ img_b, int H, int W,
                   const float* __restrict__ pts_a,
                   const float* __restrict__ pts_b, float* __restrict__ out) {
  __shared__ __align__(16) float red_sm[2][kWarps * kRed];
  Reducer red{red_sm, 0};
  const int slot = blockIdx.x;
  const float ncc = ncc_r(GeomR(win), red, img_a, img_b, H, W,
                          pts_a[2 * slot], pts_a[2 * slot + 1],
                          pts_b[2 * slot], pts_b[2 * slot + 1]);
  if (threadIdx.x == 0) out[slot] = ncc;
}

// klt_fb_ncc_kernel at a runtime window: the NCC reads its two level-0
// windows from L2 (the ring has been refilled by then).
__global__ void __launch_bounds__(kThreads)
klt_fb_ncc_kernel_r(int win, int R, const float* __restrict__ pts,
                    const bool* __restrict__ valid, PlanesR fwd, PlanesR bwd,
                    int L, int iters, float eps2, float fb_thresh,
                    float ncc_min, float* __restrict__ fwd_pts,
                    bool* __restrict__ status, float* __restrict__ err_out,
                    float* __restrict__ ncc_out) {
  const GeomR g(win);
  SmemR sm(g);
  Reducer red{sm.red, 0};
  const int slot = blockIdx.x;
  const int H = fwd.H[0];
  const int W = fwd.W[0];
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  const bool alive = valid[slot];

  issue_ring(g, sm.ring, R, fwd, L, px, py);
  const LkOut f = lk_pyramid_r(g, sm, R, red, fwd, L, px, py, 0.0f, 0.0f,
                               alive, iters, eps2);
  const float qx = px + f.flx;
  const float qy = py + f.fly;
  const bool fwd_ok = f.ok && post_filter(qx, qy, f.err, H, W) && alive;

  __syncthreads();  // the forward templates are read: reuse the ring
  issue_ring(g, sm.ring, R, bwd, L, qx, qy);
  const float coarse = ldexpf(1.0f, L - 1);
  const LkOut b = lk_pyramid_r(g, sm, R, red, bwd, L, qx, qy,
                               (px - qx) / coarse, (py - qy) / coarse,
                               fwd_ok, iters, eps2);
  const float bx = qx + b.flx;
  const float by = qy + b.fly;
  const bool bwd_ok = b.ok && post_filter(bx, by, b.err, H, W) && fwd_ok;

  const float ncc = ncc_r(g, red, fwd.tmpl[0], fwd.next[0], H, W, px, py,
                          qx, qy);
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

// The card's opt-in shared memory a block, per device, once the generic
// kernels may use it (0 before).
int g_smem_budget[64];

// Let the generic kernels of the current device use the card's opt-in
// shared memory (cudaFuncAttributeMaxDynamicSharedMemorySize), once per
// device, and put that budget in *budget. Returns a cudaError_t.
int prepare_device(int* budget) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_smem_budget[dev] == 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if ((e = cudaFuncSetAttribute(klt_pyramid_kernel_r<false>, a, optin)) ||
        (e = cudaFuncSetAttribute(klt_pyramid_kernel_r<true>, a, optin)) ||
        (e = cudaFuncSetAttribute(klt_fb_ncc_kernel_r, a, optin)))
      return (int)e;
    g_smem_budget[dev] = optin;
  }
  *budget = g_smem_budget[dev];
  return 0;
}

// Dynamic shared memory and ring depth of a generic LK launch within
// `budget` bytes: as many of the L levels as fit beside the tile (at most
// kRing); none where not even one does, and the templates are read from
// L2.
struct PlanR {
  int R;
  size_t bytes;
};

PlanR plan_r(int win, int L, long budget) {
  const GeomR g(win);
  const long fixed = 4L * (kRedFloats + g.tile_floats());
  const long level = 4L * g.level_floats();
  const long fit = budget > fixed ? (budget - fixed) / level : 0;
  const int R = (int)std::min<long>(std::min(L, kRing), fit);
  return PlanR{R, (size_t)(fixed + R * level)};
}

bool win_ok(int win) { return win >= 1 && win <= kMaxWin; }

// Fill one direction's planes from a host array of `stride` pointers per
// level (finest first): tmpl, gx, gy, next at offsets o[0..3].
template <int N>
bool fill_planes(PlanesN<N>& P, const float* const* pl, int stride,
                 const int (&o)[4], const int* h, const int* w, int L) {
  if (L < 1 || L > N) return false;
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

// Let the runtime-window kernels use the card's opt-in shared memory on
// the current device (the launchers also do it at their first launch on
// a device). Returns a cudaError_t.
int vins_klt_init(void) {
  int budget = 0;
  return prepare_device(&budget);
}

// pts, init_flow (may be null): [M, 2] f32; valid: [M] bool.
// planes: host array of 4*L device pointers, per level (prev, gx, gy,
// next), finest first; Hs, Ws: host arrays of L ints; 1 <= L <= 32,
// 1 <= win <= 128. Outputs: pts_out [M, 2] f32 = pts + flow, ok_out [M]
// bool (gates & valid), err_out [M] f32.
int vins_klt_pyramid(const void* pts, const void* init_flow,
                     const void* valid, const void* planes, const void* Hs,
                     const void* Ws, int L, int M, int win, int iters,
                     float eps2, void* pts_out, void* ok_out, void* err_out,
                     void* stream) {
  const float* const* pl = static_cast<const float* const*>(planes);
  const int* h = static_cast<const int*>(Hs);
  const int* w = static_cast<const int*>(Ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win == 21 && L <= kMaxLevels) {  // the default configs' window
    Planes P;
    if (!fill_planes(P, pl, 4, {0, 1, 2, 3}, h, w, L))
      return (int)cudaErrorInvalidValue;
    if (M <= 0) return 0;
    klt_pyramid_kernel<21, false><<<M, kThreads, 0, s>>>(
        static_cast<const float*>(pts), static_cast<const float*>(init_flow),
        static_cast<const bool*>(valid), P, L, iters, eps2,
        static_cast<float*>(pts_out), static_cast<bool*>(ok_out),
        static_cast<float*>(err_out));
    return (int)cudaGetLastError();
  }
  PlanesR P;
  if (!win_ok(win) || !fill_planes(P, pl, 4, {0, 1, 2, 3}, h, w, L))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  int budget = 0;
  if (const int e = prepare_device(&budget)) return e;
  const PlanR pr = plan_r(win, L, budget);
  klt_pyramid_kernel_r<false><<<M, kThreads, pr.bytes, s>>>(
      win, pr.R, static_cast<const float*>(pts),
      static_cast<const float*>(init_flow), static_cast<const bool*>(valid),
      P, L, iters, eps2, static_cast<float*>(pts_out),
      static_cast<bool*>(ok_out), static_cast<float*>(err_out));
  return (int)cudaGetLastError();
}

// K4: one level. prev, gx, gy, next: [H, W] f32; pts, guess (may be
// null): [M, 2] f32 in this level's pixels; valid: [M] bool;
// 1 <= win <= 128. Outputs: flow_out [M, 2] f32, ok_out [M] bool (gate &
// valid), err_out [M] f32.
int vins_klt_level(const void* prev, const void* gx, const void* gy,
                   const void* next, int H, int W, const void* pts,
                   const void* guess, const void* valid, int M, int win,
                   int iters, float eps2, void* flow_out, void* ok_out,
                   void* err_out, void* stream) {
  if (!win_ok(win)) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const float* planes[4] = {static_cast<const float*>(prev),
                            static_cast<const float*>(gx),
                            static_cast<const float*>(gy),
                            static_cast<const float*>(next)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win == 21) {
    Planes P;
    fill_planes(P, planes, 4, {0, 1, 2, 3}, &H, &W, 1);
    klt_pyramid_kernel<21, true><<<M, kThreads, 0, s>>>(
        static_cast<const float*>(pts), static_cast<const float*>(guess),
        static_cast<const bool*>(valid), P, 1, iters, eps2,
        static_cast<float*>(flow_out), static_cast<bool*>(ok_out),
        static_cast<float*>(err_out));
    return (int)cudaGetLastError();
  }
  PlanesR P;
  fill_planes(P, planes, 4, {0, 1, 2, 3}, &H, &W, 1);
  int budget = 0;
  if (const int e = prepare_device(&budget)) return e;
  const PlanR pr = plan_r(win, 1, budget);
  klt_pyramid_kernel_r<true><<<M, kThreads, pr.bytes, s>>>(
      win, pr.R, static_cast<const float*>(pts),
      static_cast<const float*>(guess), static_cast<const bool*>(valid), P,
      1, iters, eps2, static_cast<float*>(flow_out),
      static_cast<bool*>(ok_out), static_cast<float*>(err_out));
  return (int)cudaGetLastError();
}

// img_a, img_b: [H, W] f32; pts_a, pts_b: [M, 2] f32; 1 <= win <= 128;
// out: [M] f32.
int vins_patch_ncc(const void* img_a, const void* img_b, int H, int W,
                   const void* pts_a, const void* pts_b, int M, int win,
                   void* out, void* stream) {
  if (!win_ok(win)) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win == 21) {
    patch_ncc_kernel<21><<<M, kThreads, 0, s>>>(
        static_cast<const float*>(img_a), static_cast<const float*>(img_b),
        H, W, static_cast<const float*>(pts_a),
        static_cast<const float*>(pts_b), static_cast<float*>(out));
  } else {
    patch_ncc_kernel_r<<<M, kThreads, 0, s>>>(
        win, static_cast<const float*>(img_a),
        static_cast<const float*>(img_b), H, W,
        static_cast<const float*>(pts_a), static_cast<const float*>(pts_b),
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// Forward-backward tracking with the NCC gate. pts: [M, 2] f32 level-0
// points in prev; valid: [M] bool. planes: host array of 6*L device
// pointers, per level (prev, gx_prev, gy_prev, next, gx_next, gy_next),
// finest first; Hs, Ws: host arrays of L ints; 1 <= L <= 32,
// 1 <= win <= 128. Outputs: fwd_pts [M, 2] f32, status [M] bool, err [M]
// f32 (the round-trip distance), ncc [M] f32.
int vins_klt_fb_ncc(const void* pts, const void* valid, const void* planes,
                    const void* Hs, const void* Ws, int L, int M, int win,
                    int iters, float eps2, float fb_thresh, float ncc_min,
                    void* fwd_pts, void* status, void* err, void* ncc,
                    void* stream) {
  const float* const* pl = static_cast<const float* const*>(planes);
  const int* h = static_cast<const int*>(Hs);
  const int* w = static_cast<const int*>(Ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win == 21 && L <= kMaxLevels) {  // the default configs' window
    Planes fwd, bwd;
    if (!fill_planes(fwd, pl, 6, {0, 1, 2, 3}, h, w, L) ||
        !fill_planes(bwd, pl, 6, {3, 4, 5, 0}, h, w, L))
      return (int)cudaErrorInvalidValue;
    if (M <= 0) return 0;
    klt_fb_ncc_kernel<21><<<M, kThreads, 0, s>>>(
        static_cast<const float*>(pts), static_cast<const bool*>(valid),
        fwd, bwd, L, iters, eps2, fb_thresh, ncc_min,
        static_cast<float*>(fwd_pts), static_cast<bool*>(status),
        static_cast<float*>(err), static_cast<float*>(ncc));
    return (int)cudaGetLastError();
  }
  PlanesR fwd, bwd;
  if (!win_ok(win) || !fill_planes(fwd, pl, 6, {0, 1, 2, 3}, h, w, L) ||
      !fill_planes(bwd, pl, 6, {3, 4, 5, 0}, h, w, L))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  int budget = 0;
  if (const int e = prepare_device(&budget)) return e;
  const PlanR pr = plan_r(win, L, budget);
  klt_fb_ncc_kernel_r<<<M, kThreads, pr.bytes, s>>>(
      win, pr.R, static_cast<const float*>(pts),
      static_cast<const bool*>(valid), fwd, bwd, L, iters, eps2, fb_thresh,
      ncc_min, static_cast<float*>(fwd_pts), static_cast<bool*>(status),
      static_cast<float*>(err), static_cast<float*>(ncc));
  return (int)cudaGetLastError();
}

// The ring depth and dynamic shared memory a generic launch at (win, L)
// takes on the current device (for reports; 0 levels: templates from L2).
int vins_klt_plan(int win, int L, void* ring_out, void* bytes_out) {
  if (!win_ok(win) || L < 1 || L > kMaxLevelsR)
    return (int)cudaErrorInvalidValue;
  int budget = 0;
  if (const int e = prepare_device(&budget)) return e;
  const PlanR pr = plan_r(win, L, budget);
  *static_cast<int*>(ring_out) = pr.R;
  *static_cast<long long*>(bytes_out) = (long long)pr.bytes;
  return 0;
}

}  // extern "C"
