// Front-to-back tile alpha blend, forward, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/raster/blend_pallas.py::_blend_fwd_pallas
// (kernel body _fwd_kernel). Same contract and semantics: per 16x16 tile,
// composite the tile's depth-sorted instances front to back,
//   alpha = min(0.99, op * exp(power)),
//   power = -0.5 * (a dx^2 + c dy^2) - b dx dy,   dx = mx - px, dy = my - py,
// skip a splat when power > 0 or alpha < 1/255 (tested after the min),
// stop a pixel at the first splat with T * (1 - alpha) < 1e-4 (that splat
// is not applied), and cap each tile at tile_cap instances (binning does
// not cap counts). final_t is the T after the last applied splat.
//
// Design. The TPU kernel blends a whole [K, 256] chunk at once with a
// log-step cumprod because its vector unit has no per-lane control flow.
// Hopper has it, so this is the classic per-pixel loop: one CTA per tile,
// one thread per pixel, each thread compositing sequentially with its own
// done flag. The CTA stages the tile's instance rows through shared memory
// in batches of one row per thread, so each row is read from device memory
// once per tile and then broadcast to all 256 pixels, and it leaves the
// batch loop as soon as every pixel is done (__syncthreads_count).
//
// Bound. Per (pixel, instance) pair the loop does ~20 float operations
// (one expf) before the skip tests and ~8 more when the splat is applied,
// on data that is already in shared memory; device traffic is one 40-byte
// row per instance plus 20 bytes of output per pixel. At the serving shape
// (500k instances, 2,500 tiles) that is tens of MB against >10^8 pairs, so
// the kernel is bound by the non-tensor f32 rate, not by memory. Hence the
// design keeps the inner loop free of memory traffic and stops early; a
// faster version would cut the per-pair operations (skip splats whose
// ellipse misses the pixel before the expf) or the work of idle threads of
// pixels already done.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libblend_fwd.so blend_fwd.cu
// --fmad=false keeps every product rounded on its own, as PyTorch's
// elementwise ops round them, so the kernel computes each alpha the way
// the plain blend does; what still differs is the order of the T product.

#include <cuda_runtime.h>

namespace {

constexpr int kAttrs = 10;  // mx, my, con_a, con_b, con_c, opacity, r, g, b, z
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

__global__ void blend_fwd_kernel(const float* __restrict__ pack, int d_rows,
                                 const int* __restrict__ tile_start,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ tile_ids,
                                 float* __restrict__ color,
                                 float* __restrict__ depth,
                                 float* __restrict__ final_t, int tiles_x,
                                 int tile_size, int tile_cap) {
  extern __shared__ float rows[];  // [blockDim.x][kAttrs]
  const int p = blockDim.x;        // == tile_size * tile_size
  const int t = blockIdx.x;
  const int tid = threadIdx.x;

  const int gid = tile_ids[t];
  const float px = static_cast<float>((gid % tiles_x) * tile_size + tid % tile_size);
  const float py = static_cast<float>((gid / tiles_x) * tile_size + tid / tile_size);

  const int start = tile_start[t];
  // cap at tile_cap, and never read past the end of the pack
  const int n = max(0, min(min(counts[t], tile_cap), d_rows - start));

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, z = 0.0f;
  bool done = false;
  for (int b = 0; b < n; b += p) {
    // barrier: the previous batch is fully read before it is overwritten;
    // and the whole tile leaves once every pixel is done
    if (__syncthreads_count(!done) == 0) break;
    const int i = b + tid;
    if (i < n) {
      const float* src = pack + static_cast<size_t>(start + i) * kAttrs;
#pragma unroll
      for (int k = 0; k < kAttrs; ++k) rows[tid * kAttrs + k] = src[k];
    }
    __syncthreads();
    const int m = min(p, n - b);
    for (int j = 0; j < m && !done; ++j) {
      const float* r = rows + j * kAttrs;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      const float alpha = fminf(0.99f, r[5] * expf(power));
      if (power > 0.0f || alpha < kAlphaMin) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 += w * r[6];
      c1 += w * r[7];
      c2 += w * r[8];
      z += w * r[9];
      T = test_t;
    }
  }
  const size_t o = static_cast<size_t>(t) * p + tid;
  color[static_cast<size_t>(t) * 3 * p + tid] = c0;
  color[static_cast<size_t>(t) * 3 * p + p + tid] = c1;
  color[static_cast<size_t>(t) * 3 * p + 2 * p + tid] = c2;
  depth[o] = z;
  final_t[o] = T;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int blend_fwd_launch(const float* pack, int d_rows, const int* tile_start,
                     const int* counts, const int* tile_ids, float* color,
                     float* depth, float* final_t, int num_tiles, int tiles_x,
                     int tile_size, int tile_cap, void* stream) {
  if (num_tiles == 0) return 0;
  const int p = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(p) * kAttrs * sizeof(float);
  blend_fwd_kernel<<<num_tiles, p, smem, static_cast<cudaStream_t>(stream)>>>(
      pack, d_rows, tile_start, counts, tile_ids, color, depth, final_t,
      tiles_x, tile_size, tile_cap);
  return static_cast<int>(cudaGetLastError());
}

const char* blend_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
