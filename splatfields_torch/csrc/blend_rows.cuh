// The tile blend's rows, shared by blend_fwd.cu and blend_bwd.cu (sm_90a):
// the skip rules, the pre-test and tile cull that run ahead of them, and
// the staging of a tile's rows into shared memory.
//
// Exact rules (the plain versions in ops/raster/blend_torch.py):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = mx - px, dy = my - py,
//   alpha = min(0.99, op * expf(power)),
// skip a pair when power > 0 or alpha < 1/255; a pixel stops at the first
// pair with T (1 - alpha) < 1e-4, which is not applied.
//
// Pre-test. Each row carries thr = logf(1 / (255 op)) - kPreDelta (-inf
// when op <= 0 or NaN). A pair with power < thr has op * expf(power) <
// 1/255 by a margin of 1e-3 in power, far above the few ulp of expf, logf
// and the product, so the exact rule skips it too: the pixel loop tests
// power > 0 || power < thr before the expf, and evaluates the exact
// expression otherwise. A NaN power passes the pre-test, as it passes the
// exact rule.
//
// Tile cull (blend_torch.tile_cull, which the CPU tests hold to the exact
// rule). The float power is at most -0.5 Q'(d), Q' the conic with
// kCullGamma (|a| + |b|), kCullGamma (|c| + |b|) taken off its diagonal
// (8 ulp of the terms' magnitudes bound its rounding; kCullGamma is ten
// times that). Where Q' is positive definite, a pair with power >= thr
// lies in the ellipse Q'(d) <= -2 thr, inside the box of half-widths
// sqrt(-2 thr c' / det'), sqrt(-2 thr a' / det'); a row whose box misses
// every pixel centre of the tile is dropped for the whole tile, before the
// pixel loop sees it. det' is taken low, the half-widths wide and the gaps
// short against their own rounding. A row below the 1/255 level (thr > 0)
// is dropped whatever its conic. Rows with a non-finite or out-of-range
// value are never dropped (a power could overflow there).
//
// Staged row, 12 floats (three 16-byte chunks, so a row is two LDS.128 for
// the test and one more for an applied pair; all threads of a warp read the
// same row, a broadcast):
//   [mx, my, a, b] [c, thr, op, z] [r, g, b, pack row index]
// A tile stages up to blockDim.x rows at a time, one row a thread: five
// 8-byte loads of its row (the pack's 40-byte rows are 8-byte aligned; the
// warp's 32 rows are 1,280 consecutive bytes, fetched once and served from
// L1 to the five loads), the pre-test level, the cull, then a ballot
// compacts the kept rows in pack order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace blend {

constexpr int kAttrs = 10;  // mx, my, con_a, con_b, con_c, opacity, r, g, b, z
constexpr int kRow = 12;    // floats of a staged row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kPreDelta = 1e-3f;
constexpr float kCullGamma = 1e-5f;
constexpr float kCullDet = 1e-6f;
constexpr float kCullWiden = 1.001f;
constexpr float kCullGap = 1.0f - 1e-5f;
constexpr float kCullSane = 1e10f, kCullSaneMean = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float row_threshold(float op) {
  return op > 0.0f ? logf(1.0f / (255.0f * op)) - kPreDelta : -INFINITY;
}

// The tile whose pixel centres span [x0, x1] x [y0, y1] can drop row v.
__device__ __forceinline__ bool tile_cull(const float* v, float thr, float x0,
                                          float y0, float x1, float y1) {
  const float mx = v[0], my = v[1], a = v[2], b = v[3], c = v[4];
  // !(|x| <= bound) is also true for NaN
  if (!(fabsf(a) <= kCullSane && fabsf(b) <= kCullSane &&
        fabsf(c) <= kCullSane && fabsf(mx) <= kCullSaneMean &&
        fabsf(my) <= kCullSaneMean))
    return false;
  if (thr > 0.0f) return true;
  const float ap = a - kCullGamma * (fabsf(a) + fabsf(b));
  const float cp = c - kCullGamma * (fabsf(c) + fabsf(b));
  const float det = ap * cp * (1.0f - kCullDet) - b * b * (1.0f + kCullDet);
  if (!(ap > 0.0f && cp > 0.0f && det > 0.0f)) return false;
  const float k = -2.0f * thr;
  const float hx = sqrtf(k * cp / det) * kCullWiden;
  const float hy = sqrtf(k * ap / det) * kCullWiden;
  const float gx = fmaxf(x0 - mx, mx - x1) * kCullGap;
  const float gy = fmaxf(y0 - my, my - y1) * kCullGap;
  return gx > hx || gy > hy;
}

// Row `row` of the pack into registers: five 8-byte loads.
__device__ __forceinline__ void load_row(const float* __restrict__ pack,
                                         int row, float* v) {
  const float2* src = reinterpret_cast<const float2*>(pack) +
                      static_cast<size_t>(row) * (kAttrs / 2);
#pragma unroll
  for (int k = 0; k < kAttrs / 2; ++k) {
    const float2 t = __ldg(src + k);
    v[2 * k] = t.x;
    v[2 * k + 1] = t.y;
  }
}

// Staging, first half, before a CTA barrier: whether this thread's row
// (if it has one) is kept, its level in *thr, and the warp's kept count in
// warp_kept[warp]. Returns the warp's ballot of kept rows.
__device__ __forceinline__ unsigned stage_vote(const float* v, bool valid,
                                               float x0, float y0, float x1,
                                               float y1, float* thr,
                                               int* warp_kept) {
  *thr = row_threshold(v[5]);
  const bool keep = valid && !tile_cull(v, *thr, x0, y0, x1, y1);
  const unsigned ballot = __ballot_sync(kFullMask, keep);
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = __popc(ballot);
  return ballot;
}

// Staging, second half, after that barrier: the kept rows into `rows`
// (float4 [blockDim.x * 3]) in pack order. Returns how many were kept. The
// caller puts a barrier between this and the rows' first read.
__device__ __forceinline__ int stage_write(float4* rows,
                                           const int* warp_kept,
                                           unsigned ballot, const float* v,
                                           float thr, int index) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before = 0, total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int n = warp_kept[w];
    before += w < warp ? n : 0;
    total += n;
  }
  if (ballot >> lane & 1u) {
    float4* r = rows + 3 * (before + __popc(ballot & ((1u << lane) - 1u)));
    r[0] = make_float4(v[0], v[1], v[2], v[3]);
    r[1] = make_float4(v[4], thr, v[5], v[9]);
    r[2] = make_float4(v[6], v[7], v[8], __int_as_float(index));
  }
  return total;
}

}  // namespace blend
