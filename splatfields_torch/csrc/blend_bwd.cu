// Front-to-back tile alpha blend, backward, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/raster/blend_pallas.py::_blend_bwd_pallas
// (kernel body _bwd_one_tile). Computes dL/d(sorted_pack) [D, 10] from the
// upstream gradients of the forward's colour [T,3,P], depth and final T
// [T,P], with the forward's rules (blend_rows.cuh), at most tile_cap rows
// per tile.
//
// Math, per pixel, with w_i = alpha_i T_i over the applied splats:
//   dL/dalpha_i = T_i (c_i.gC + z_i gD)
//                 - (S_c,i + S_d,i + T_final gT) / max(1 - alpha_i, 1e-6)
// where S_*,i sum w_j (c_j.gC) and w_j z_j gD over applied j > i. The
// totals come in closed form from the saved outputs (C.gC, D gD), so one
// front-to-back replay suffices: S_*,i = total - running prefix through i.
// Then, with alpha = op exp(power), d alpha / d power = alpha (also at the
// 0.99 clamp, as the Pallas kernel and the reference CUDA rasterizer do)
// and d alpha / d op = alpha / max(op, 1e-9); dL/drgb_i = w_i gC,
// dL/dz_i = w_i gD.
//
// Design. One CTA per tile, one thread per pixel replaying the tile's rows
// in order with its own T, prefix sums and done flag. Rows are staged as
// in the forward (blend_rows.cuh: the tile cull drops rows no pixel can
// apply, the pre-test skips most pairs before the expf). A row's ten
// partials are summed over the tile's pixels without atomics, in two
// steps:
//  - within a warp, a reduce-scatter (recursive halving, each lane sending
//    half of what it still holds): 5 + 3 + 2 + 1 + 1 = 12 shuffles leave
//    each of the ten sums in two lanes, where a shuffle tree per partial
//    takes 50; a warp in which no lane applied the row writes zeros and
//    shuffles nothing, and a warp whose pixels are all done stops;
//  - across warps, each warp's sums of 32 rows in a shared-memory slot
//    (double-buffered), one barrier, then one thread per (row, attribute)
//    adds the warps' slots in warp order, while the warps go on to the
//    next 32 rows.
// Every duplicated instance belongs to one tile, so tiles write disjoint
// rows, and every sum has a fixed order: the result is deterministic. Rows
// the tile never reaches, and rows it culls, are not written: the caller
// passes a zeroed grad.
//
// Bound. Per (pixel, row) pair the replay does ~20 float operations to
// evaluate alpha and ~40 more when the row is applied, and the sums add
// ~40 a (warp, row) with an applied lane; device traffic is one 40-byte
// row read and one written per instance plus 9 floats read per pixel: the
// f32 rate bounds it, not memory. The design takes the per-row shuffle
// trees, the scalar staging and most pairs' expf off the path, and drops
// culled rows before the pixel loop.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libblend_bwd.so blend_bwd.cu
// --fmad=false rounds every product on its own, as PyTorch's elementwise
// ops round them in blend_torch.blend_bwd_plain, so every alpha and every
// skip and stop decision is the plain version's. The two divisions of an
// applied pair are IEEE divisions, as in the plain version.

#include "blend_rows.cuh"

namespace {

using namespace blend;

constexpr int kSub = 32;  // rows whose sums one slot buffer holds

// The attribute whose warp sum warp_sum_scatter leaves in `lane`, or -1.
__device__ __forceinline__ int scatter_attr(int lane) {
  const int i = (lane & 4) ? ((lane & 2) ? -1 : 2) : ((lane & 2) ? 1 : 0);
  const int j = (lane & 8) ? 3 + i : i;
  return (i < 0 || j >= 5) ? -1 : 5 * ((lane >> 4) & 1) + j;
}

// v[0..9] summed over the warp by recursive halving: lane l returns the sum
// of attribute scatter_attr(l) (both lanes of a pair l, l ^ 1 hold it).
__device__ __forceinline__ float warp_sum_scatter(const float* v, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  float u[5];  // xor 16: keep attributes 0-4 (h16 clear) or 5-9
#pragma unroll
  for (int i = 0; i < 5; ++i)
    u[i] = (h16 ? v[5 + i] : v[i]) +
           __shfl_xor_sync(kFullMask, h16 ? v[i] : v[5 + i], 16);
  float w[3];  // xor 8: keep u 0-2 (h8 clear) or 3, 4 and nothing
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = i < 2 ? u[3 + i] : 0.0f;
    w[i] = (h8 ? hi : u[i]) + __shfl_xor_sync(kFullMask, h8 ? u[i] : hi, 8);
  }
  // xor 4: keep w 0-1 (h4 clear) or 2 and nothing
  const float x0 = (h4 ? w[2] : w[0]) +
                   __shfl_xor_sync(kFullMask, h4 ? w[0] : w[2], 4);
  const float x1 = (h4 ? 0.0f : w[1]) +
                   __shfl_xor_sync(kFullMask, h4 ? w[1] : 0.0f, 4);
  // xor 2: keep x0 (h2 clear) or x1
  const float y = (h2 ? x1 : x0) + __shfl_xor_sync(kFullMask, h2 ? x0 : x1, 2);
  return y + __shfl_xor_sync(kFullMask, y, 1);
}

__global__ void blend_bwd_kernel(
    const float* __restrict__ pack, int d_rows,
    const int* __restrict__ tile_start, const int* __restrict__ counts,
    const int* __restrict__ tile_ids,
    const float* __restrict__ g_color, const float* __restrict__ g_depth,
    const float* __restrict__ g_tfinal, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_t,
    float* __restrict__ grad, int tiles_x, int tile_size, int tile_cap) {
  extern __shared__ float4 smem[];
  const int p = blockDim.x;  // == tile_size * tile_size, a multiple of 32
  const int n_warps = p / 32;
  float4* rows = smem;                                          // [p][3]
  float* slots = reinterpret_cast<float*>(smem + 3 * p);        // [2][warps][kSub][10]
  __shared__ int warp_kept[32];
  __shared__ int warp_rows[2][32];  // rows of a sub-batch each warp summed
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int attr = scatter_attr(lane);
  const bool writer = attr >= 0 && (lane & 1) == 0;

  const int gid = tile_ids[t];
  const float x0 = static_cast<float>((gid % tiles_x) * tile_size);
  const float y0 = static_cast<float>((gid / tiles_x) * tile_size);
  const float x1 = x0 + static_cast<float>(tile_size - 1);
  const float y1 = y0 + static_cast<float>(tile_size - 1);
  const float px = x0 + static_cast<float>(tid % tile_size);
  const float py = y0 + static_cast<float>(tid / tile_size);
  const int start = tile_start[t];
  const int n = max(0, min(min(counts[t], tile_cap), d_rows - start));

  const size_t o = static_cast<size_t>(t) * p + tid;
  const size_t oc = static_cast<size_t>(t) * 3 * p + tid;
  const float gc0 = g_color[oc], gc1 = g_color[oc + p], gc2 = g_color[oc + 2 * p];
  const float gd = g_depth[o];
  const float tf_gt = final_t[o] * g_tfinal[o];
  const float tot_c = color[oc] * gc0 + color[oc + p] * gc1 + color[oc + 2 * p] * gc2;
  const float tot_d = depth[o] * gd;

  float T = 1.0f, pre_c = 0.0f, pre_d = 0.0f;
  bool done = false;
  int buf = 0;
  for (int b = 0; b < n; b += p) {
    float mine[kAttrs] = {}, thr;  // the row this thread stages
    if (b + tid < n) load_row(pack, start + b + tid, mine);
    const unsigned ballot = stage_vote(mine, b + tid < n, x0, y0, x1, y1,
                                       &thr, warp_kept);
    // barrier: the previous batch's rows and sums are consumed before they
    // are overwritten, warp_kept is complete; the tile leaves once every
    // pixel is done
    if (__syncthreads_count(!done) == 0) break;
    const int m = stage_write(rows, warp_kept, ballot, mine, thr,
                              start + b + tid);
    __syncthreads();

    int live = 1;
    for (int s = 0; s < m && live; s += kSub, buf ^= 1) {
      const int mm = min(kSub, m - s);
      float* slot = slots + (buf * n_warps + warp) * kSub * kAttrs;
      int j = 0;
      for (; j < mm; ++j) {
        if (__all_sync(kFullMask, done)) break;  // the warp's pixels are done
        const float4* r = rows + 3 * (s + j);
        float v[kAttrs];
#pragma unroll
        for (int k = 0; k < kAttrs; ++k) v[k] = 0.0f;
        bool applied = false;
        if (!done) {
          const float4 g = r[0];  // mx, my, a, b
          const float4 q = r[1];  // c, thr, op, z
          const float dx = g.x - px;
          const float dy = g.y - py;
          const float power = -0.5f * (g.z * dx * dx + q.x * dy * dy) - g.w * dx * dy;
          // the exact pre-test, then the exact rule
          if (!(power > 0.0f || power < q.y)) {
            const float alpha = fminf(0.99f, q.z * expf(power));
            if (!(alpha < kAlphaMin)) {
              const float test_t = T * (1.0f - alpha);
              if (test_t < kTEps) {
                done = true;
              } else {
                applied = true;
                const float4 rgb = r[2];
                const float w = alpha * T;
                const float cdot = rgb.x * gc0 + rgb.y * gc1 + rgb.z * gc2;
                const float zdot = q.w * gd;
                pre_c += w * cdot;
                pre_d += w * zdot;
                const float g_alpha =
                    T * (cdot + zdot) -
                    ((tot_c - pre_c) + (tot_d - pre_d) + tf_gt) /
                        fmaxf(1.0f - alpha, 1e-6f);
                const float ga = g_alpha * alpha;
                v[0] = ga * -(g.z * dx + g.w * dy);
                v[1] = ga * -(q.x * dy + g.w * dx);
                v[2] = ga * (-0.5f * dx * dx);
                v[3] = ga * (-dx * dy);
                v[4] = ga * (-0.5f * dy * dy);
                v[5] = ga / fmaxf(q.z, 1e-9f);
                v[6] = w * gc0;
                v[7] = w * gc1;
                v[8] = w * gc2;
                v[9] = w * gd;
                T = test_t;
              }
            }
          }
        }
        if (__any_sync(kFullMask, applied)) {
          const float sum = warp_sum_scatter(v, lane);
          if (writer) slot[j * kAttrs + attr] = sum;
        } else if (writer) {
          slot[j * kAttrs + attr] = 0.0f;
        }
      }
      if (lane == 0) warp_rows[buf][warp] = j;
      // barrier: every warp's sums of this sub-batch are in; the slots of
      // the other buffer were summed before it
      live = __syncthreads_count(!done);
      // one thread per (row, attribute): add the warps' sums in warp order
      for (int e = tid; e < mm * kAttrs; e += p) {
        const int row = e / kAttrs;
        float acc = 0.0f;
        for (int w = 0; w < n_warps; ++w)
          if (row < warp_rows[buf][w])
            acc += slots[(buf * n_warps + w) * kSub * kAttrs + e];
        const int index = __float_as_int(rows[3 * (s + row) + 2].w);
        grad[static_cast<size_t>(index) * kAttrs + e % kAttrs] = acc;
      }
    }
    if (!live) break;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `grad` [d_rows, 10] must be zeroed: rows no pixel reaches are not
// written. `pack` must be 8-byte aligned.
int blend_bwd_launch(const float* pack, int d_rows, const int* tile_start,
                     const int* counts, const int* tile_ids,
                     const float* g_color, const float* g_depth,
                     const float* g_tfinal, const float* color,
                     const float* depth, const float* final_t, float* grad,
                     int num_tiles, int tiles_x, int tile_size, int tile_cap,
                     void* stream) {
  if (num_tiles == 0) return 0;
  const int p = tile_size * tile_size;
  if (p % 32 != 0 || p > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(p) * kRow +
                       2 * static_cast<size_t>(p / 32) * kSub * kAttrs) *
                      sizeof(float);
  // past 48 KB with the static warp_kept and warp_rows, the kernel must
  // opt in
  if (smem + 3 * 32 * sizeof(int) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blend_bwd_kernel<<<num_tiles, p, smem, static_cast<cudaStream_t>(stream)>>>(
      pack, d_rows, tile_start, counts, tile_ids, g_color, g_depth, g_tfinal,
      color, depth, final_t, grad, tiles_x, tile_size, tile_cap);
  return static_cast<int>(cudaGetLastError());
}

const char* blend_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
