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
// below), which keeps the same arithmetic and guarantees and, up to
// window 64, the same design, specialized on the template taps a thread
// holds instead of on the window.
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
// The runtime-window variant, for any win in 1..128 and L in 1..32, is
// compiled for the number of template taps a thread holds, KT in
// {1, 2, 4, 8, 16}; the window stays a run-time value. A launch takes
// the least KT with 256 KT >= win^2 (KT 16 covers win <= 64):
// - The same block of 256 threads a slot, Reducer, corner clamp, blend,
//   block-uniform early exit and gates. Thread t holds taps t, t + 256,
//   ... up to KT of them: their offsets in a staged window and in the tile
//   are computed once a launch (TapsR), each level blends their template
//   and gradients once into registers, and the tap loops unroll over KT
//   with one predicate on the thread's tap count.
// - The next-frame tile is staged through registers (TileR: every load of
//   a thread in flight before the first store, as the specialization's
//   Tile) and read with the specialization's bank-spread row stride.
// - Shared memory is dynamic, up to the card's opt-in limit (227 KB on an
//   H100; vins_klt_init sets cudaFuncAttributeMaxDynamicSharedMemorySize):
//   the reduction totals, the tile of (win+1+2m)^2 pixels and a ring of R
//   staged levels, R = min(L, 8, what fits beside the tile). The R
//   coarsest levels are issued at block start, coarsest first, one commit
//   group each; a level's slot takes level lvl - R as soon as every
//   thread has blended from it. A level waits for its own group:
//   min(R - 1, lvl) newer groups may still be in flight.
// - The fused kernel's NCC takes the level-0 templates the threads hold,
//   forward around pts and backward around the forward result, as the
//   specialization does: it reads no pixel again. K2 (no caller on the
//   main path) has one body for every window, not compiled for KT: two
//   passes over its two windows from L2 (tools/torch_klt_turns.py: bodies
//   that blend each tap once, in registers or in shared memory, were
//   slower at some window, and each body adds build time).
// tools/torch_klt_ablation.py measured where the variant before this
// design lost its 1.3x against the specialization at windows 20-22
// (where every template tap already sat in registers): the tile staged
// one serialized load at a time, the per-tap predicate and the runtime
// geometry of each tap, then the NCC read again from L2 (PERF.md).
// Past 64 (KT would pass 16 registers a tap array) the blended templates
// of a level lie in shared memory beside the tile, 3 floats a tap, each
// blended once a level: all win^2 taps up to win 113 in 227 KB; from 114
// as many as fit (at 128, 11,616 of 16,384 beside the 93 KB tile), the
// rest blended from L2 at each use (the planes stay cached there). The
// tile is staged in batches of loads; the fused NCC keeps its taps in
// shared memory too.
//
// Neither wgmma nor TMA: each slot's sums are 441-long dot products over
// data-dependent windows, so there is no matrix product for wgmma; the
// windows are 22 floats wide (88 B rows) at arbitrary offsets, and a TMA
// tensor map would have to be encoded on the host for each of 24 planes
// every frame, while cp.async takes any 4-byte-aligned address.
//
// Built by vins_tpu_torch/ops/native.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC --split-compile=0 -Xptxas --split-compile=0 -c
// (the split spreads this file's many kernel instantiations over every
// core), then linked with the other sources into one shared library,
// and bound with ctypes: each extern "C" launcher enqueues on the given
// stream, does not synchronize, and returns cudaGetLastError().

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

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
constexpr int kRedFloats = 2 * kWarps * kRed;
// Where a launch keeps the blended templates (KT): KT > 0 taps a thread in
// registers, one of {1, 2, 4, 8, 16}, the least with kThreads * KT >= win^2
// (win <= 64); kSharedT: all win^2 taps in shared memory, blended once a
// level (up to win 113 on an H100); kPartT: as many as fit beside the
// tile there, the rest blended from the planes at each use.
constexpr int kSharedT = 0;
constexpr int kPartT = -1;
constexpr int kKTs[] = {1, 2, 4, 8, 16};

// The largest window whose taps kThreads threads of KT taps cover.
__host__ __device__ constexpr int max_win(int kt) {
  return kt == 1 ? 16 : kt == 2 ? 22 : kt == 4 ? 32 : kt == 8 ? 45 : 64;
}

// Arrays of KT taps, one element where KT <= 0 (unused there).
__host__ __device__ constexpr int regs(int kt) { return kt > 0 ? kt : 1; }

// The geometry of Geom<WIN>, from the window at run time.
struct GeomR {
  int win, w1, ws, win_pix, tile, ts;
  __host__ __device__ constexpr explicit GeomR(int w)
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
// after it either a ring of R staged levels (KT > 0) or the blended
// templates t, gx, gy of the window's first nsh taps (KT <= 0).
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

// This thread's taps j = threadIdx.x + kThreads * k of a win x win window,
// k = 0, 1, ..., as (row, col), stepped without a division.
struct TapWalk {
  int row, col, dr, dc, win;
  __device__ explicit TapWalk(int w) : win(w) {
    row = threadIdx.x / w;
    col = threadIdx.x - row * w;
    dr = kThreads / w;
    dc = kThreads - dr * w;
  }
  __device__ __forceinline__ bool on() const { return row < win; }
  __device__ __forceinline__ int tap() const { return row * win + col; }
  __device__ __forceinline__ void next() {
    row += dr;
    col += dc;
    if (col >= win) {
      col -= win;
      ++row;
    }
  }
};

// This thread's KT taps: their offsets in a staged window (rows of ws
// floats) and in the tile (rows of ts), and how many lie in the window.
// Computed once a launch, so the tap loops unroll over KT.
template <int KT>
struct TapsR {
  int win[regs(KT)];
  int tile[regs(KT)];
  int n = 0;

  __device__ explicit TapsR(const GeomR& g) {
    const int taps = g.win * g.win;
    if (KT > 0 && (int)threadIdx.x < taps)
      n = (taps - 1 - (int)threadIdx.x) / kThreads + 1;
    TapWalk w(g.win);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      win[k] = w.row * g.ws + w.col;
      tile[k] = w.row * g.ts + w.col;
      w.next();
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

// Clamp the window corner around (cx, cy) (the window's centre) on an
// [H, W] plane, as clamped_corner does at a fixed window.
__device__ __forceinline__ void centred_corner(const GeomR& g, float cx,
                                               float cy, int H, int W,
                                               int& ix, int& iy, float& fx,
                                               float& fy) {
  const float r = (g.win - 1) / 2.0f;
  corner(cx - r, cy - r, corner_limit_r(W, g.win), corner_limit_r(H, g.win),
         ix, iy, fx, fy);
}

// The clamped corners of two windows centred at (pax, pay) and (pbx, pby)
// on [H, W] planes, the clamp's limits computed once.
struct CornerPair {
  int ia, ja, ib, jb;
  float fxa, fya, fxb, fyb;
  __device__ __forceinline__ CornerPair(const GeomR& g, int H, int W,
                                        float pax, float pay, float pbx,
                                        float pby) {
    const float r = (g.win - 1) / 2.0f;
    const float hx = corner_limit_r(W, g.win);
    const float hy = corner_limit_r(H, g.win);
    corner(pax - r, pay - r, hx, hy, ia, ja, fxa, fya);
    corner(pbx - r, pby - r, hx, hy, ib, jb, fxb, fyb);
  }
};

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
  const float scale = ldexpf(1.0f, lvl);
  int ix, iy;
  float fx, fy;
  centred_corner(g, px / scale, py / scale, P.H[lvl], P.W[lvl], ix, iy, fx,
                 fy);
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

// The next-frame tile of a runtime window: its origin clamped into the
// plane as Tile's, kTile = win + 1 + 2 kMargin pixels a side (fewer where
// the plane is smaller). KT > 0 stages it through registers: every load
// of a thread is in flight before the first store, as Tile does; the
// wide windows stage it in batches of kBatch loads.
template <int KT>
struct TileR {
  static constexpr int kSide = max_win(KT) + 1 + 2 * kMargin;
  static constexpr int kLoads =
      KT > 0 ? (kSide * kSide + kThreads - 1) / kThreads : 1;
  int ox = 0, oy = 0, tw = 0, th = 0;
  float v[kLoads];

  __device__ __forceinline__ void place(const GeomR& g, int H, int W, int ix,
                                        int iy) {
    tw = min(g.tile, W);
    th = min(g.tile, H);
    ox = min(max(ix - kMargin, 0), W - tw);
    oy = min(max(iy - kMargin, 0), H - th);
  }

  // This thread's first element of the tile, as (row, col), and the step
  // of kThreads elements.
  __device__ __forceinline__ void walk(int& row, int& col, int& dr,
                                       int& dc) const {
    row = threadIdx.x / tw;
    col = threadIdx.x - row * tw;
    dr = kThreads / tw;
    dc = kThreads - dr * tw;
  }

  __device__ __forceinline__ void step(int& row, int& col, int dr,
                                       int dc) const {
    row += dr;
    col += dc;
    if (col >= tw) {
      col -= tw;
      ++row;
    }
  }

  // KT > 0: this thread's loads into registers.
  __device__ __forceinline__ void load(const GeomR& g,
                                       const float* __restrict__ plane, int H,
                                       int W, int ix, int iy) {
    place(g, H, W, ix, iy);
    int row, col, dr, dc;
    walk(row, col, dr, dc);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      v[i] = row < th
            ? __ldg(plane + (size_t)(oy + row) * W + (ox + col))
            : 0.0f;  // runtime tile
      step(row, col, dr, dc);
    }
  }

  __device__ __forceinline__ void store(const GeomR& g, float* tile) const {
    int row, col, dr, dc;
    walk(row, col, dr, dc);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if (row < th) tile[row * g.ts + col] = v[i];
      step(row, col, dr, dc);
    }
  }

  // The wide windows: straight into shared memory, kBatch loads a thread
  // in flight at a time (the caller publishes it with a barrier).
  __device__ __forceinline__ void stage(const GeomR& g, float* tile,
                                        const float* __restrict__ plane,
                                        int H, int W, int ix, int iy) {
    constexpr int kBatch = 8;
    place(g, H, W, ix, iy);
    int row, col, dr, dc;
    walk(row, col, dr, dc);
    for (int e = 0; e < th * tw; e += kBatch * kThreads) {
      float b[kBatch];
      const int row0 = row, col0 = col;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        b[i] = row < th ? __ldg(plane + (size_t)(oy + row) * W + ox + col)
                        : 0.0f;
        step(row, col, dr, dc);
      }
      row = row0;
      col = col0;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (row < th) tile[row * g.ts + col] = b[i];
        step(row, col, dr, dc);
      }
    }
  }

  __device__ __forceinline__ bool holds(const GeomR& g, int ix,
                                        int iy) const {
    return ix >= ox && iy >= oy && ix - ox <= tw - g.w1 &&
           iy - oy <= th - g.w1;
  }
};

// The gate and the inverse of the structure tensor (a, b; b, c), as
// lk_pyramid computes them.
struct Hessian {
  float i00, i01, i11;
  bool ok;
  __device__ __forceinline__ Hessian(const float (&s)[3], float area) {
    const float a = s[0], b = s[1], c = s[2];
    const float det = a * c - b * b;
    const float tr = a + c;
    const float min_eig =
        0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    ok = min_eig / area > 1e-4f;
    const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
    i00 = c * inv_det;
    i01 = -b * inv_det;
    i11 = a * inv_det;
  }
};

// lk_pyramid at a runtime window with KT template taps a thread in
// registers: each level's taps are blended once from its staged ring slot
// (issue_ring issued the R coarsest levels; a slot is refilled with level
// lvl - R as soon as every thread has blended from it). t0 receives this
// thread's level-0 template taps (0 outside the window).
template <int KT>
__device__ LkOut lk_pyramid_kt(const GeomR& g, const TapsR<KT>& taps,
                               SmemR& sm, int R, Reducer& red,
                               const PlanesR& P, int L, float px, float py,
                               float flx, float fly, bool alive, int iters,
                               float eps2, float (&t0)[KT]) {
  const float area = (float)(g.win * g.win);
  const float r = (g.win - 1) / 2.0f;
  const int nk = taps.n;
  bool ok = alive;
  float err = 0.0f;
  TileR<KT> tile;

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
    // The tile's loads go out before the wait for the templates.
    if (alive) {
      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, fy);
      tile.load(g, P.next[lvl], H, W, ix, iy);
    }
    wait_templates(min(R - 1, lvl));  // runtime ring
    __syncthreads();

    corner(plx - r, ply - r, hx, hy, ix, iy, fx, fy);
    const float* slot = sm.ring + (lvl % R) * g.level_floats() + (ix & 3);
    float t[KT], tx[KT], ty[KT];
    float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < nk) {
        const float* o = slot + taps.win[k];
        t[k] = blend(o, g.ws, fx, fy);
        tx[k] = blend(o + g.win_pix, g.ws, fx, fy);
        ty[k] = blend(o + 2 * g.win_pix, g.ws, fx, fy);
      } else {
        t[k] = tx[k] = ty[k] = 0.0f;
      }
      s[0] += tx[k] * tx[k];
      s[1] += tx[k] * ty[k];
      s[2] += ty[k] * ty[k];
    }
    if (lvl == 0) {
#pragma unroll
      for (int k = 0; k < KT; ++k) t0[k] = t[k];
    }
    if (alive) tile.store(g, sm.tile);
    red.sum(s);  // its barrier also publishes the tile
    // Every thread has blended from this level's slot: refill it with the
    // next level the ring does not hold yet.
    if (lvl - R >= 0) issue_level_r(g, sm.ring, R, P, lvl - R, px, py);
    const Hessian h(s, area);
    ok = ok && h.ok;

    int it = 0;
    float d2 = alive ? INFINITY : 0.0f;
    float sabs = 0.0f;  // the last update's sum of |residual|
    while (it < iters && d2 > eps2) {
      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, fy);
      if (!tile.holds(g, ix, iy)) {
        // Every thread has read the old tile before the last barrier.
        tile.load(g, P.next[lvl], H, W, ix, iy);
        tile.store(g, sm.tile);
        __syncthreads();
      }
      const float* base = sm.tile + (iy - tile.oy) * g.ts + (ix - tile.ox);
      float q[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k < nk) {  // iteration tap
          const float diff = blend(base + taps.tile[k], g.ts, fx, fy) - t[k];
          q[0] += diff * tx[k];
          q[1] += diff * ty[k];
          q[2] += fabsf(diff);
        }
      }
      red.sum(q);
      const float dx = -(h.i00 * q[0] + h.i01 * q[1]);
      const float dy = -(h.i01 * q[0] + h.i11 * q[1]);
      flx += dx;
      fly += dy;
      sabs = q[2];
      d2 = dx * dx + dy * dy;
      ++it;
    }
    err = sabs / area;
    if (lvl > 0) {
      flx *= 2.0f;
      fly *= 2.0f;
    }
  }
  return LkOut{flx, fly, err, ok && alive};
}

// lk_pyramid past 64: the blended templates of a level in shared memory,
// t, gx, gy of tap j < nsh at T[j], T[nsh + j], T[2 nsh + j] (T =
// sm.ring), each blended once at the level's start from the planes; the
// taps from nsh on (kAll false: not all win^2 fit beside the tile) are
// blended from the planes again at each use. Each thread touches only its
// own taps there.
template <bool kAll>
__device__ LkOut lk_pyramid_wide(const GeomR& g, int nsh, SmemR& sm,
                                 Reducer& red, const PlanesR& P, int L,
                                 float px, float py, float flx, float fly,
                                 bool alive, int iters, float eps2) {
  const float area = (float)(g.win * g.win);
  const float r = (g.win - 1) / 2.0f;
  float* const T = sm.ring;
  bool ok = alive;
  float err = 0.0f;
  TileR<kSharedT> tile;

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
    // Every thread has read the last level's tile and templates before
    // its last barrier.
    if (alive) {
      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, fy);
      tile.stage(g, sm.tile, P.next[lvl], H, W, ix, iy);
    }
    corner(plx - r, ply - r, hx, hy, ix, iy, fx, fy);
    const size_t o = (size_t)iy * W + ix;
    const Src PT{P.tmpl[lvl] + o, W};
    const Src PX{P.gx[lvl] + o, W};
    const Src PY{P.gy[lvl] + o, W};
    float s[3] = {0.0f, 0.0f, 0.0f};
    for (TapWalk w(g.win); w.on(); w.next()) {
      const float gx = PX.at(w.row, w.col, fx, fy);
      const float gy = PY.at(w.row, w.col, fx, fy);
      const int j = w.tap();
      if (kAll || j < nsh) {
        T[j] = PT.at(w.row, w.col, fx, fy);
        T[nsh + j] = gx;
        T[2 * nsh + j] = gy;
      }
      s[0] += gx * gx;
      s[1] += gx * gy;
      s[2] += gy * gy;
    }
    red.sum(s);  // its barrier also publishes the tile
    const Hessian h(s, area);
    ok = ok && h.ok;

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
      for (TapWalk u(g.win); u.on(); u.next()) {
        const int j = u.tap();
        float t, gx, gy;
        if (kAll || j < nsh) {
          t = T[j];
          gx = T[nsh + j];
          gy = T[2 * nsh + j];
        } else {
          t = PT.at(u.row, u.col, fx, fy);
          gx = PX.at(u.row, u.col, fx, fy);
          gy = PY.at(u.row, u.col, fx, fy);
        }
        const float diff = cur.at(u.row, u.col, gfx, gfy) - t;
        q[0] += diff * gx;
        q[1] += diff * gy;
        q[2] += fabsf(diff);
      }
      red.sum(q);
      const float dx = -(h.i00 * q[0] + h.i01 * q[1]);
      const float dy = -(h.i01 * q[0] + h.i11 * q[1]);
      flx += dx;
      fly += dy;
      sabs = q[2];
      d2 = dx * dx + dy * dy;
      ++it;
    }
    err = sabs / area;
    if (lvl > 0) {
      flx *= 2.0f;
      fly *= 2.0f;
    }
  }
  return LkOut{flx, fly, err, ok && alive};
}

// R: the ring's levels (KT > 0), or the taps whose blended templates lie
// in shared memory (KT <= 0).
template <int KT>
__device__ __forceinline__ LkOut lk_pyramid_r(
    const GeomR& g, const TapsR<KT>& taps, SmemR& sm, int R, Reducer& red,
    const PlanesR& P, int L, float px, float py, float flx, float fly,
    bool alive, int iters, float eps2, float (&t0)[regs(KT)]) {
  if constexpr (KT > 0) {
    return lk_pyramid_kt<KT>(g, taps, sm, R, red, P, L, px, py, flx, fly,
                             alive, iters, eps2, t0);
  } else {
    return lk_pyramid_wide<KT == kSharedT>(g, R, sm, red, P, L, px, py, flx,
                                           fly, alive, iters, eps2);
  }
}

// Zero-mean NCC of two windows from this thread's KT taps of each (0
// outside the window), as ncc_of_taps computes it.
template <int KT>
__device__ __forceinline__ float ncc_of_taps_r(Reducer& red, int nk,
                                               float area,
                                               const float (&ta)[KT],
                                               const float (&tb)[KT]) {
  float m[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    m[0] += ta[k];
    m[1] += tb[k];
  }
  red.sum(m);
  const float ma = m[0] / area;
  const float mb = m[1] / area;
  float s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k < nk) {
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

// Zero-mean NCC of the level-0 windows of a at (pax, pay) and of b at
// (pbx, pby) (window centres) on [H, W] planes, as _ncc_kernel computes
// it, for the windows past 64. A tap j < nkeep is blended once: the first
// pass keeps it in keep[j] (b) and keep[nkeep + j] (a), shared memory,
// each thread its own taps, and the second reads it there; the others are
// blended from the planes again in the second pass. b_kept: the b
// window's taps j < nkeep already lie in keep[j] (the fused kernel's
// backward level-0 templates).
__device__ float ncc_wide(const GeomR& g, Reducer& red, float* keep,
                          int nkeep, bool b_kept,
                          const float* __restrict__ a,
                          const float* __restrict__ b, int H, int W,
                          float pax, float pay, float pbx, float pby) {
  const float area = (float)(g.win * g.win);
  const CornerPair c(g, H, W, pax, pay, pbx, pby);
  const float fxa = c.fxa, fya = c.fya, fxb = c.fxb, fyb = c.fyb;
  const Src A{a + (size_t)c.ja * W + c.ia, W};
  const Src B{b + (size_t)c.jb * W + c.ib, W};
  float m[2] = {0.0f, 0.0f};
  for (TapWalk w(g.win); w.on(); w.next()) {
    const int j = w.tap();
    const float va = A.at(w.row, w.col, fxa, fya);
    float vb;
    if (j < nkeep) {
      vb = b_kept ? keep[j] : B.at(w.row, w.col, fxb, fyb);
      keep[j] = vb;
      keep[nkeep + j] = va;
    } else {
      vb = B.at(w.row, w.col, fxb, fyb);
    }
    m[0] += va;
    m[1] += vb;
  }
  red.sum(m);
  const float ma = m[0] / area;
  const float mb = m[1] / area;
  float s[3] = {0.0f, 0.0f, 0.0f};
  for (TapWalk w(g.win); w.on(); w.next()) {
    const int j = w.tap();
    const bool kept = j < nkeep;
    const float da = (kept ? keep[nkeep + j]
                           : A.at(w.row, w.col, fxa, fya)) - ma;
    const float db = (kept ? keep[j] : B.at(w.row, w.col, fxb, fyb)) - mb;
    s[0] += da * da;
    s[1] += db * db;
    s[2] += da * db;
  }
  red.sum(s);
  return s[2] * rsqrtf(s[0] * s[1] + 1e-12f);
}

// The fused kernel's NCC of the forward templates around pts and the
// backward templates around the forward result: from the level-0 taps
// the threads hold (KT > 0), or with ncc_wide past 64, where the backward
// pass left the level-0 templates of its first R taps in shared memory.
template <int KT>
__device__ __forceinline__ float fused_ncc_r(
    const GeomR& g, const TapsR<KT>& taps, SmemR& sm, int R, Reducer& red,
    const PlanesR& fwd, float px, float py, float qx, float qy,
    const float (&ta)[regs(KT)], const float (&tb)[regs(KT)]) {
  if constexpr (KT > 0) {
    return ncc_of_taps_r<KT>(red, taps.n, (float)(g.win * g.win), ta, tb);
  } else {
    return ncc_wide(g, red, sm.ring, R, true, fwd.tmpl[0], fwd.next[0],
                    fwd.H[0], fwd.W[0], px, py, qx, qy);
  }
}

// klt_pyramid_kernel at a runtime window: KT as above; R ring slots
// (KT > 0) or shared template taps (KT <= 0); flow_out as kFlowOut there.
template <int KT>
__global__ void __launch_bounds__(kThreads)
klt_pyramid_kernel_r(int win, int R, bool flow_out,
                     const float* __restrict__ pts,
                     const float* __restrict__ init_flow,
                     const bool* __restrict__ valid, PlanesR P, int L,
                     int iters, float eps2, float* __restrict__ pts_out,
                     bool* __restrict__ ok_out, float* __restrict__ err_out) {
  const GeomR g(win);
  SmemR sm(g);
  Reducer red{sm.red, 0};
  const TapsR<KT> taps(g);
  const int slot = blockIdx.x;
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  float flx = 0.0f;
  float fly = 0.0f;
  if (init_flow != nullptr) {
    const float coarse = flow_out ? 1.0f : ldexpf(1.0f, L - 1);
    flx = init_flow[2 * slot] / coarse;
    fly = init_flow[2 * slot + 1] / coarse;
  }
  if (KT > 0) issue_ring(g, sm.ring, R, P, L, px, py);
  float t0[regs(KT)];
  const LkOut o = lk_pyramid_r<KT>(g, taps, sm, R, red, P, L, px, py, flx,
                                   fly, valid[slot], iters, eps2, t0);
  if (threadIdx.x == 0) {
    pts_out[2 * slot] = flow_out ? o.flx : px + o.flx;
    pts_out[2 * slot + 1] = flow_out ? o.fly : py + o.fly;
    ok_out[slot] = o.ok;
    err_out[slot] = o.err;
  }
}

// Zero-mean NCC of the level-0 windows of a at (pax, pay) and of b at
// (pbx, pby) (window centres), read from L2 in two passes (the mean, then
// the deviations), as _ncc_kernel computes it.
__device__ float ncc_r(const GeomR& g, Reducer& red,
                       const float* __restrict__ a,
                       const float* __restrict__ b, int H, int W, float pax,
                       float pay, float pbx, float pby) {
  const float area = (float)(g.win * g.win);
  const CornerPair c(g, H, W, pax, pay, pbx, pby);
  const float fxa = c.fxa, fya = c.fya, fxb = c.fxb, fyb = c.fyb;
  const Src A{a + (size_t)c.ja * W + c.ia, W};
  const Src B{b + (size_t)c.jb * W + c.ib, W};
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

// patch_ncc_kernel at a runtime window (no caller on the main path): one
// body for every window, ncc_r.
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

// klt_fb_ncc_kernel at a runtime window: KT and R as klt_pyramid_kernel_r.
template <int KT>
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
  const TapsR<KT> taps(g);
  const int slot = blockIdx.x;
  const int H = fwd.H[0];
  const int W = fwd.W[0];
  const float px = pts[2 * slot];
  const float py = pts[2 * slot + 1];
  const bool alive = valid[slot];

  if (KT > 0) issue_ring(g, sm.ring, R, fwd, L, px, py);
  float ta[regs(KT)], tb[regs(KT)];
  const LkOut f = lk_pyramid_r<KT>(g, taps, sm, R, red, fwd, L, px, py, 0.0f,
                                   0.0f, alive, iters, eps2, ta);
  const float qx = px + f.flx;
  const float qy = py + f.fly;
  const bool fwd_ok = f.ok && post_filter(qx, qy, f.err, H, W) && alive;

  __syncthreads();  // the forward templates are read: reuse the ring
  if (KT > 0) issue_ring(g, sm.ring, R, bwd, L, qx, qy);
  const float coarse = ldexpf(1.0f, L - 1);
  const LkOut b = lk_pyramid_r<KT>(g, taps, sm, R, red, bwd, L, qx, qy,
                                   (px - qx) / coarse, (py - qy) / coarse,
                                   fwd_ok, iters, eps2, tb);
  const float bx = qx + b.flx;
  const float by = qy + b.fly;
  const bool bwd_ok = b.ok && post_filter(bx, by, b.err, H, W) && fwd_ok;

  const float ncc = fused_ncc_r<KT>(g, taps, sm, R, red, fwd, px, py, qx,
                                    qy, ta, tb);
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

// Call f(std::integral_constant<int, KT>{}) with the compile-time KT that
// equals kt (kKTs, kSharedT or kPartT).
template <typename F>
int with_kt(int kt, F&& f) {
  using std::integral_constant;
  switch (kt) {
    case 1: return f(integral_constant<int, 1>{});
    case 2: return f(integral_constant<int, 2>{});
    case 4: return f(integral_constant<int, 4>{});
    case 8: return f(integral_constant<int, 8>{});
    case 16: return f(integral_constant<int, 16>{});
    case kSharedT: return f(integral_constant<int, kSharedT>{});
    default: return f(integral_constant<int, kPartT>{});
  }
}

// The card's opt-in shared memory a block, per device, once the generic
// kernels may use it (0 before).
int g_smem_budget[64];

// Let kernel fn take as dynamic shared memory all of the opt-in budget
// its static shared memory leaves.
template <typename K>
cudaError_t allow_smem(K* fn, int optin) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)fa.sharedSizeBytes);
}

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
    for (int kt : {1, 2, 4, 8, 16, kSharedT, kPartT}) {
      const int r = with_kt(kt, [&](auto k) {
        constexpr int KT = decltype(k)::value;
        cudaError_t x;
        if ((x = allow_smem(klt_pyramid_kernel_r<KT>, optin)) ||
            (x = allow_smem(klt_fb_ncc_kernel_r<KT>, optin)))
          return (int)x;
        return 0;
      });
      if (r) return r;
    }
    g_smem_budget[dev] = optin;
  }
  *budget = g_smem_budget[dev];
  return 0;
}

// A generic LK launch's plan within `budget` bytes of shared memory: KT
// template taps a thread in registers (the least of kKTs that covers the
// window) with a ring of R staged levels, as many of the L levels as fit
// beside the tile (at most kRing); past 64 (or where no level fits) the
// blended templates of all win^2 taps in shared memory beside the tile
// (kSharedT) or, where they do not fit, of R taps (kPartT).
struct PlanR {
  int kt;
  int R;
  size_t bytes;
};

int kt_for(int win) {
  for (int kt : kKTs)
    if (kThreads * kt >= win * win) return kt;
  return kSharedT;
}

PlanR plan_r(int win, int L, long budget) {
  const GeomR g(win);
  const long fixed = 4L * (kRedFloats + g.tile_floats());
  const long room = budget > fixed ? budget - fixed : 0;
  const int kt = kt_for(win);
  if (kt > 0) {
    const long level = 4L * g.level_floats();
    const int R = (int)std::min<long>(std::min(L, kRing), room / level);
    if (R > 0) return PlanR{kt, R, (size_t)(fixed + R * level)};
  }
  const int taps = (int)std::min<long>((long)win * win, room / 12);
  return PlanR{taps == win * win ? kSharedT : kPartT, taps,
               (size_t)(fixed + 12L * taps)};
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
  return with_kt(pr.kt, [&](auto k) {
    klt_pyramid_kernel_r<decltype(k)::value>
        <<<M, kThreads, pr.bytes, s>>>(
            win, pr.R, false, static_cast<const float*>(pts),
            static_cast<const float*>(init_flow),
            static_cast<const bool*>(valid), P, L, iters, eps2,
            static_cast<float*>(pts_out), static_cast<bool*>(ok_out),
            static_cast<float*>(err_out));
    return (int)cudaGetLastError();
  });
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
  return with_kt(pr.kt, [&](auto k) {
    klt_pyramid_kernel_r<decltype(k)::value>
        <<<M, kThreads, pr.bytes, s>>>(
            win, pr.R, true, static_cast<const float*>(pts),
            static_cast<const float*>(guess),
            static_cast<const bool*>(valid), P, 1, iters, eps2,
            static_cast<float*>(flow_out), static_cast<bool*>(ok_out),
            static_cast<float*>(err_out));
    return (int)cudaGetLastError();
  });
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
    return (int)cudaGetLastError();
  }
  patch_ncc_kernel_r<<<M, kThreads, 0, s>>>(
      win, static_cast<const float*>(img_a), static_cast<const float*>(img_b),
      H, W, static_cast<const float*>(pts_a), static_cast<const float*>(pts_b),
      static_cast<float*>(out));
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
  return with_kt(pr.kt, [&](auto k) {
    klt_fb_ncc_kernel_r<decltype(k)::value><<<M, kThreads, pr.bytes, s>>>(
        win, pr.R, static_cast<const float*>(pts),
        static_cast<const bool*>(valid), fwd, bwd, L, iters, eps2, fb_thresh,
        ncc_min, static_cast<float*>(fwd_pts), static_cast<bool*>(status),
        static_cast<float*>(err), static_cast<float*>(ncc));
    return (int)cudaGetLastError();
  });
}

// The plan of a generic LK launch at (win, L) on the current device, for
// reports: the template taps a thread holds in registers (kt; 0: the
// blended templates lie in shared memory), the levels staged in its ring
// (kt > 0) or the taps whose templates shared memory holds (kt = 0; the
// rest are blended from L2 at each use), and its dynamic shared memory in
// bytes.
int vins_klt_plan(int win, int L, void* kt_out, void* ring_out,
                  void* bytes_out) {
  if (!win_ok(win) || L < 1 || L > kMaxLevelsR)
    return (int)cudaErrorInvalidValue;
  int budget = 0;
  if (const int e = prepare_device(&budget)) return e;
  const PlanR pr = plan_r(win, L, budget);
  *static_cast<int*>(kt_out) = pr.kt;
  *static_cast<int*>(ring_out) = pr.R;
  *static_cast<long long*>(bytes_out) = (long long)pr.bytes;
  return 0;
}

}  // extern "C"
