// Front-to-back tile alpha blend, forward, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/raster/blend_pallas.py::_blend_fwd_pallas
// (kernel body _fwd_kernel). Same contract and semantics: per 16x16 tile,
// composite the tile's depth-sorted instances front to back with the rules
// of blend_rows.cuh (alpha = min(0.99, op exp(power)), skip on power > 0
// or alpha < 1/255, stop a pixel at the first splat with T (1 - alpha) <
// 1e-4, not applied), at most tile_cap instances a tile (binning does not
// cap counts). final_t is the T after the last applied splat.
//
// Design. The TPU kernel blends a whole [K, 256] chunk at once with a
// log-step cumprod because its vector unit has no per-lane control flow.
// Hopper has it, so this is the per-pixel loop: one CTA per tile, one
// thread per pixel, each compositing sequentially with its own done flag.
// The CTA stages up to one row a thread at a time (blend_rows.cuh): the
// rows the tile cull drops never reach the pixel loop, and the kept ones
// sit in shared memory as three 16-byte chunks, so a pair's test reads two
// float4 (a broadcast to the warp) and runs the exact pre-test before the
// expf: most pairs are skipped there (alpha < 1/255 far from the centre).
// The next batch's rows are loaded into registers while the pixel loop
// runs. The tile leaves once every pixel is done (__syncthreads_count).
//
// Bound. Per (pixel, instance) pair ~20 float operations before the skip
// tests and ~8 more when the splat is applied, on data already in shared
// memory; device traffic is one 40-byte row per instance plus 20 bytes
// per pixel, tens of MB against >10^8 pairs at the serving shape: the
// kernel is bound by the non-tensor f32 rate. The design cuts the instruction
// slots of a skipped pair (two LDS.128 instead of six scalar loads, no
// expf) and the pairs themselves (the cull).
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libblend_fwd.so blend_fwd.cu
// --fmad=false keeps every product rounded on its own, as PyTorch's
// elementwise ops round them, so the kernel computes each alpha the way
// the plain blend does; what still differs is the order of the T product.

#include "blend_rows.cuh"

namespace {

using namespace blend;

// blockDim.x is p rounded up to a warp; threads past p stage rows only
__global__ void blend_fwd_kernel(const float* __restrict__ pack, int d_rows,
                                 const int* __restrict__ tile_start,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ tile_ids,
                                 float* __restrict__ color,
                                 float* __restrict__ depth,
                                 float* __restrict__ final_t, int tiles_x,
                                 int tile_size, int tile_cap, int p) {
  extern __shared__ float4 rows[];  // [blockDim.x][3]
  __shared__ int warp_kept[32];
  const int nb = blockDim.x;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;

  const int gid = tile_ids[t];
  const float x0 = static_cast<float>((gid % tiles_x) * tile_size);
  const float y0 = static_cast<float>((gid / tiles_x) * tile_size);
  const float x1 = x0 + static_cast<float>(tile_size - 1);
  const float y1 = y0 + static_cast<float>(tile_size - 1);
  const float px = x0 + static_cast<float>(tid % tile_size);
  const float py = y0 + static_cast<float>(tid / tile_size);

  const int start = tile_start[t];
  // cap at tile_cap, and never read past the end of the pack
  const int n = max(0, min(min(counts[t], tile_cap), d_rows - start));

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, z = 0.0f;
  bool done = tid >= p;
  for (int b = 0; b < n; b += nb) {
    float mine[kAttrs] = {}, thr;  // the row this thread stages
    if (b + tid < n) load_row(pack, start + b + tid, mine);
    const unsigned ballot = stage_vote(mine, b + tid < n, x0, y0, x1, y1,
                                       &thr, warp_kept);
    // barrier: the previous batch is fully read before it is overwritten
    // and warp_kept is complete; the tile leaves once every pixel is done
    if (__syncthreads_count(!done) == 0) break;
    const int m = stage_write(rows, warp_kept, ballot, mine, thr,
                              start + b + tid);
    __syncthreads();
    for (int j = 0; j < m && !done; ++j) {
      const float4 g = rows[3 * j];      // mx, my, a, b
      const float4 q = rows[3 * j + 1];  // c, thr, op, z
      const float dx = g.x - px;
      const float dy = g.y - py;
      const float power = -0.5f * (g.z * dx * dx + q.x * dy * dy) - g.w * dx * dy;
      if (power > 0.0f || power < q.y) continue;  // the exact pre-test
      const float alpha = fminf(0.99f, q.z * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float4 rgb = rows[3 * j + 2];
      const float w = alpha * T;
      c0 += w * rgb.x;
      c1 += w * rgb.y;
      c2 += w * rgb.z;
      z += w * q.w;
      T = test_t;
    }
  }
  if (tid >= p) return;
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
// `pack` must be 8-byte aligned.
int blend_fwd_launch(const float* pack, int d_rows, const int* tile_start,
                     const int* counts, const int* tile_ids, float* color,
                     float* depth, float* final_t, int num_tiles, int tiles_x,
                     int tile_size, int tile_cap, void* stream) {
  if (num_tiles == 0) return 0;
  const int p = tile_size * tile_size;
  const int threads = (p + 31) / 32 * 32;
  if (p < 1 || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(threads) * kRow * sizeof(float);
  // past 48 KB with the static warp_kept, the kernel must opt in
  if (smem + 32 * sizeof(int) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blend_fwd_kernel<<<num_tiles, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      pack, d_rows, tile_start, counts, tile_ids, color, depth, final_t,
      tiles_x, tile_size, tile_cap, p);
  return static_cast<int>(cudaGetLastError());
}

const char* blend_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
