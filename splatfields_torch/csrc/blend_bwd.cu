// Front-to-back tile alpha blend, backward, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/raster/blend_pallas.py::_blend_bwd_pallas
// (kernel body _bwd_one_tile). Computes dL/d(sorted_pack) [D, 10] from the
// upstream gradients of the forward's colour [T,3,P], depth and final T
// [T,P], with the forward's rules (blend_fwd.cu): skip a splat when
// power > 0 or alpha < 1/255, stop a pixel at the first splat with
// T (1 - alpha) < 1e-4 (not applied), at most tile_cap rows per tile.
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
// Design. The Pallas kernel works on [K, 256] chunks with log-step scans
// for the prefix sums; here it is the forward kernel's per-pixel loop:
// one CTA per tile, one thread per pixel, each thread replaying the tile's
// rows in order with its own T, prefix sums and done flag. Rows are staged
// through shared memory kBatch at a time (one coalesced copy of
// kBatch * 10 consecutive floats). Each row's ten partials are summed over
// the tile's pixels without atomics: a shuffle tree inside each warp
// (skipped when no lane of the warp applied the row), one slot per warp
// in shared memory, then one thread per (row, attribute) adds the warps'
// slots and writes the row, coalesced. Every duplicated instance belongs
// to one tile, so tiles write disjoint rows, and the order of every sum is
// fixed: the result is deterministic. The CTA leaves once every pixel is
// done (__syncthreads_count). Rows it never reaches are not written: the
// caller passes a zeroed grad.
//
// Bound. Per (pixel, row) pair the replay does ~20 float operations to
// evaluate alpha and ~40 more when the row is applied; the reduction adds
// 5 shuffle-adds per partial and warp that applied the row. Device
// traffic is one 40-byte row read and one written per instance plus
// 9 floats read per pixel. Like the forward, it is bound by the f32 rate,
// not by memory; the per-row shuffle trees are the part a faster version
// would cut first.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libblend_bwd.so blend_bwd.cu
// --fmad=false rounds every product on its own, as PyTorch's elementwise
// ops round them in blend_torch.blend_bwd_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kAttrs = 10;  // mx, my, con_a, con_b, con_c, opacity, r, g, b, z
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kBatch = 32;  // rows staged per batch
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void blend_bwd_kernel(
    const float* __restrict__ pack, int d_rows,
    const int* __restrict__ tile_start, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_tfinal,
    const float* __restrict__ color, const float* __restrict__ depth,
    const float* __restrict__ final_t, float* __restrict__ grad, int tiles_x,
    int tile_size, int tile_cap) {
  extern __shared__ float smem[];
  float* rows = smem;                      // [kBatch][kAttrs]
  float* partial = smem + kBatch * kAttrs;  // [warps][kBatch][kAttrs]
  const int p = blockDim.x;  // == tile_size * tile_size, a multiple of 32
  const int n_warps = p / 32;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int gid = tile_ids[t];
  const float px = static_cast<float>((gid % tiles_x) * tile_size + tid % tile_size);
  const float py = static_cast<float>((gid / tiles_x) * tile_size + tid / tile_size);
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
  for (int b = 0; b < n; b += kBatch) {
    // barrier: the previous batch's rows and partials are consumed before
    // they are overwritten; and the tile leaves once every pixel is done
    if (__syncthreads_count(!done) == 0) break;
    const int m = min(kBatch, n - b);
    const float* src = pack + static_cast<size_t>(start + b) * kAttrs;
    for (int e = tid; e < m * kAttrs; e += p) rows[e] = src[e];
    __syncthreads();

    for (int j = 0; j < m; ++j) {  // m is uniform: every lane takes part
      const float* r = rows + j * kAttrs;
      float v[kAttrs];
#pragma unroll
      for (int k = 0; k < kAttrs; ++k) v[k] = 0.0f;
      bool applied = false;
      if (!done) {
        const float dx = r[0] - px;
        const float dy = r[1] - py;
        const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        const float alpha = fminf(0.99f, r[5] * expf(power));
        if (!(power > 0.0f || alpha < kAlphaMin)) {
          const float test_t = T * (1.0f - alpha);
          if (test_t < kTEps) {
            done = true;
          } else {
            applied = true;
            const float w = alpha * T;
            const float cdot = r[6] * gc0 + r[7] * gc1 + r[8] * gc2;
            const float zdot = r[9] * gd;
            pre_c += w * cdot;
            pre_d += w * zdot;
            const float g_alpha =
                T * (cdot + zdot) -
                ((tot_c - pre_c) + (tot_d - pre_d) + tf_gt) / fmaxf(1.0f - alpha, 1e-6f);
            const float ga = g_alpha * alpha;
            v[0] = ga * -(r[2] * dx + r[3] * dy);
            v[1] = ga * -(r[4] * dy + r[3] * dx);
            v[2] = ga * (-0.5f * dx * dx);
            v[3] = ga * (-dx * dy);
            v[4] = ga * (-0.5f * dy * dy);
            v[5] = ga / fmaxf(r[5], 1e-9f);
            v[6] = w * gc0;
            v[7] = w * gc1;
            v[8] = w * gc2;
            v[9] = w * gd;
            T = test_t;
          }
        }
      }
      float* slot = partial + (warp * kBatch + j) * kAttrs;
      if (__any_sync(kFullMask, applied)) {
#pragma unroll
        for (int k = 0; k < kAttrs; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_down_sync(kFullMask, v[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kAttrs; ++k) slot[k] = v[k];
      }
    }
    __syncthreads();
    // one thread per (row, attribute): add the warps' slots, write the row
    float* dst = grad + static_cast<size_t>(start + b) * kAttrs;
    for (int e = tid; e < m * kAttrs; e += p) {
      float acc = 0.0f;
      for (int w = 0; w < n_warps; ++w) acc += partial[w * kBatch * kAttrs + e];
      dst[e] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `grad` [d_rows, 10] must be zeroed: rows no pixel reaches are not written.
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
  const size_t smem = static_cast<size_t>(kBatch) * kAttrs * (1 + p / 32) * sizeof(float);
  blend_bwd_kernel<<<num_tiles, p, smem, static_cast<cudaStream_t>(stream)>>>(
      pack, d_rows, tile_start, counts, tile_ids, g_color, g_depth, g_tfinal,
      color, depth, final_t, grad, tiles_x, tile_size, tile_cap);
  return static_cast<int>(cudaGetLastError());
}

const char* blend_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
