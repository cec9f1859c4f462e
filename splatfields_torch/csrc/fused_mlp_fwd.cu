// Every rank-0 MLP head of a field in one pass, forward, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/fused_mlp.py::_fused_fwd_call (kernel body
// _fwd_kernel). Same contract: for embeddings emb [N, E] and features
// feat [N, F] (f32), packed weights w [R, 128] (layer i of a head is a
// block of rows holding weight.T, zero-padded) and biases b [L, 128],
// each head h of the plan computes
//   h_in = [emb[:, :emb_cols], feat]
//   x = h_in; for each layer: x = leaky_relu(x W + b, 0.01),
//             and x = [h_in, x] after a skip layer
// and writes x to out[h] [N, out_dim] (f32). Matrix operands are rounded
// to the compute type (bf16 or f32) and every product sums in f32; the
// bias is added in f32.
//
// Design. What the TPU kernel keeps out of device memory, this one keeps
// out too: a CTA takes a chunk of points and runs every head of the plan
// for them with the activations in shared memory; only the inputs are
// read and only the heads' outputs written. The plan (layer widths, row
// and bias offsets, skips) is a kernel parameter, so one build serves
// every plan. The ragged last chunk is masked: rows past N compute on
// zeros and are not written.
//
// bf16 (fused_fwd_mma_kernel): the products run on the tensor cores
// (fused_mlp_mma.cuh: mma.sync m16n8k16, f32 accumulation), 64 points a
// chunk. The chunk's inputs are staged into shared memory once (cp.async,
// during the previous chunk's last head) and every head builds its h_in
// from them. The activations sit in shared memory as bf16 rows, already
// rounded (the skip's h_in too), padded to a multiple of 16 with zeros.
// The weights come as one bf16 copy of the packed matrix (made by the
// wrapper); each layer's tile is staged into shared memory with cp.async
// into a two-ended ring, the next layer's (or the next chunk's first)
// while the current one computes. The epilogue adds the bias in f32,
// applies leaky_relu, rounds to bf16 and stores into the next layer's
// input at the skip offset; the last layer writes f32 to out[h]. One CTA
// an SM walks the chunks c, c + gridDim.x, ..., so the ring's prefetch
// runs on across chunks.
//
// f32 (fused_fwd_simt_kernel): exact f32 FMAs on the CUDA cores, 32 points
// a CTA, a thread a 4-point x 4-column tile, weights read as float4
// through the read-only cache.
//
// Bound. At the published widths a point needs 310,336 multiply-adds
// over both plans and moves ~400 bytes, so the kernel is bound by
// operations: bf16 at the tensor cores' rate, f32 at the CUDA cores'.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libfused_mlp_fwd.so fused_mlp_fwd.cu
// --fmad=false keeps a*b+c from being fused behind our back; the FMAs
// of the f32 path are explicit (__fmaf_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_mlp_mma.cuh"

namespace {

using fused_mma::kCols;
using fused_mma::leaky_relu;
using fused_mma::ld_bf16;
using fused_mma::round16;

constexpr int kMaxHeads = 8;
constexpr int kMaxLayers = 48;
constexpr int kPoints = 32;   // points per CTA, f32 path
constexpr int kThreads = 256;  // f32 path
using fused_mma::kMmaThreads;

struct Layer {
  int fin, fout, row_off, bias_idx, skip_after;
};
struct Head {
  int emb_cols, out_dim, first_layer, n_layers;
};
struct Plan {
  int n_heads, n_layers, emb_dim, feat_dim, n, hin_stride, width_stride;
  int points, w_region;  // bf16 path: points a chunk, weight ring (values)
  Head heads[kMaxHeads];
  Layer layers[kMaxLayers];
  float* out[kMaxHeads];
};

__global__ void __launch_bounds__(kThreads)
    fused_fwd_simt_kernel(const float* __restrict__ emb,
                          const float* __restrict__ feat,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          const __grid_constant__ Plan plan) {
  extern __shared__ float smem[];
  const int hs = plan.hin_stride, ws = plan.width_stride;
  float* hin = smem;                    // [kPoints, hs]
  float* buf0 = hin + kPoints * hs;     // [kPoints, ws]
  float* buf1 = buf0 + kPoints * ws;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kPoints;
  const int E = plan.emb_dim, F = plan.feat_dim;

  for (int hd = 0; hd < plan.n_heads; ++hd) {
    const Head head = plan.heads[hd];
    const int hin_w = head.emb_cols + F;
    __syncthreads();  // the previous head is done with the buffers
    for (int i = tid; i < kPoints * hin_w; i += kThreads) {
      const int p = i / hin_w, c = i % hin_w;
      const long long gp = base + p;
      float v = 0.0f;
      if (gp < plan.n) {
        v = c < head.emb_cols ? emb[gp * E + c]
                              : feat[gp * F + (c - head.emb_cols)];
      }
      hin[p * hs + c] = v;
      buf0[p * ws + c] = v;
    }
    __syncthreads();
    float* cur = buf0;
    float* nxt = buf1;
    for (int li = 0; li < head.n_layers; ++li) {
      const Layer L = plan.layers[head.first_layer + li];
      const bool last = li == head.n_layers - 1;
      const int off = L.skip_after ? hin_w : 0;
      const int n_ct = (L.fout + 3) / 4;
      const float* wl = w + static_cast<size_t>(L.row_off) * kCols;
      const float* bl = b + static_cast<size_t>(L.bias_idx) * kCols;
      for (int t = tid; t < (kPoints / 4) * n_ct; t += kThreads) {
        const int c0 = (t % n_ct) * 4, p0 = (t / n_ct) * 4;
        float acc[4][4] = {};
        for (int k = 0; k < L.fin; ++k) {
          // columns past fout are zero in the packed weights
          const float4 wv = __ldg(
              reinterpret_cast<const float4*>(wl + k * kCols + c0));
          const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hv = cur[(p0 + i) * ws + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(hv, wk[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          if (c >= L.fout) continue;
          const float bias = bl[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float y = leaky_relu(acc[i][j] + bias);
            const long long gp = base + p0 + i;
            if (!last) {
              nxt[(p0 + i) * ws + off + c] = y;
            } else if (gp < plan.n) {
              plan.out[hd][gp * head.out_dim + c] = y;
            }
          }
        }
      }
      if (L.skip_after) {  // the next input is [h_in, x]
        for (int i = tid; i < kPoints * hin_w; i += kThreads) {
          const int p = i / hin_w, c = i % hin_w;
          nxt[p * ws + c] = hin[p * hs + c];
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

// Shared memory: the weight ring; the chunk's inputs xin [P, E + F] f32;
// h_in [P, hs] and two activation buffers [P, ws] as bf16 rows.
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_fwd_mma_kernel(const float* __restrict__ emb,
                         const float* __restrict__ feat,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ b,
                         const __grid_constant__ Plan plan) {
  extern __shared__ float4 smem4[];
  const int P = plan.points, hs = plan.hin_stride, ws = plan.width_stride;
  const int E = plan.emb_dim, F = plan.feat_dim;
  const fused_mma::WeightRing ring = {
      reinterpret_cast<__nv_bfloat16*>(smem4), plan.w_region, w};
  float* xin = reinterpret_cast<float*>(ring.region + plan.w_region);
  __nv_bfloat16* hin = reinterpret_cast<__nv_bfloat16*>(xin + P * (E + F));
  __nv_bfloat16* bufs[2] = {hin + P * hs, hin + P * hs + P * ws};
  const int tid = threadIdx.x;
  const int n_chunks = (plan.n + P - 1) / P;
  // the weight schedule: every layer in plan order, chunk after chunk;
  // item s is layer s % n_layers
  auto stage = [&](int s) {
    const Layer& L = plan.layers[s % plan.n_layers];
    ring.stage(s, L.row_off, L.fin, L.fout);
  };
  int s = 0;
  if (static_cast<int>(blockIdx.x) < n_chunks) {
    stage(0);
    fused_mma::stage_inputs(xin, emb, feat,
                            static_cast<long long>(blockIdx.x) * P, plan.n, P,
                            E, F);
  }

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long base = static_cast<long long>(chunk) * P;
    const bool more = chunk + static_cast<int>(gridDim.x) < n_chunks;
    for (int hd = 0; hd < plan.n_heads; ++hd) {
      const Head head = plan.heads[hd];
      const int hin_w = head.emb_cols + F;
      // the previous head is done with h_in; the chunk's inputs have
      // landed (staged during the previous chunk)
      if (hd == 0) fused_mma::cp_async_wait_all();
      __syncthreads();
      fused_mma::hin_rows(hin, hs, xin, P, E, F, head.emb_cols);
      for (int li = 0; li < head.n_layers; ++li, ++s) {
        const Layer L = plan.layers[head.first_layer + li];
        const bool last = li == head.n_layers - 1;
        // this layer's tile has landed and every warp is past the
        // previous layer (its input is written, the ring's other end and
        // this layer's output buffer are free): prefetch the next item,
        // and once the last head's h_in is built, the next chunk's inputs
        fused_mma::cp_async_wait_all();
        __syncthreads();
        if (more || hd < plan.n_heads - 1 || !last) stage(s + 1);
        if (more && hd == plan.n_heads - 1 && li == 0) {
          fused_mma::stage_inputs(xin, emb, feat,
                                  base + static_cast<long long>(gridDim.x) * P,
                                  plan.n, P, E, F);
        }
        const __nv_bfloat16* wt = ring.tile(s, L.fin, L.fout);
        const __nv_bfloat16* cur = li == 0 ? hin : bufs[(li - 1) & 1];
        const int cur_ld = li == 0 ? hs : ws;
        const float* bl = b + static_cast<size_t>(L.bias_idx) * kCols;
        const int fout = L.fout;
        if (last) {
          float* out = plan.out[hd];
          const int n = plan.n;
          fused_mma::cta_mma<false>(
              cur, cur_ld, wt, ld_bf16(fout), P, round16(fout),
              round16(L.fin), [&](int row, int col, float y0, float y1) {
                const long long gp = base + row;
                if (gp >= n) return;
                if (col < fout) {
                  out[gp * fout + col] = leaky_relu(y0 + bl[col]);
                }
                if (col + 1 < fout) {
                  out[gp * fout + col + 1] = leaky_relu(y1 + bl[col + 1]);
                }
              });
        } else {
          fused_mma::hidden_layer(cur, cur_ld, wt, bl, L.fin, fout,
                                  bufs[li & 1], ws, L.skip_after ? hin_w : 0,
                                  hin, hs, P);
        }
      }
    }
  }
  fused_mma::cp_async_wait_all();
}

// Parses the plan table of ops/fused_mlp.py::plan_table into `plan`;
// false if it is out of bounds.
bool parse_table(const int* table, Plan& plan) {
  plan.n_heads = table[0];
  plan.emb_dim = table[1];
  plan.feat_dim = table[2];
  if (plan.n_heads < 1 || plan.n_heads > kMaxHeads) return false;
  int pos = 3, n_layers = 0;
  for (int h = 0; h < plan.n_heads; ++h) {
    Head& head = plan.heads[h];
    head.emb_cols = table[pos];
    head.out_dim = table[pos + 1];
    head.n_layers = table[pos + 2];
    head.first_layer = n_layers;
    pos += 3;
    if (head.n_layers < 1 || n_layers + head.n_layers > kMaxLayers) {
      return false;
    }
    for (int l = 0; l < head.n_layers; ++l, pos += 5) {
      plan.layers[n_layers++] = {table[pos], table[pos + 1], table[pos + 2],
                                 table[pos + 3], table[pos + 4]};
    }
  }
  plan.n_layers = n_layers;
  return true;
}

// The bf16 path's layout as ops/fused_mlp.py::fwd_layout gives it: rows of
// h_in and of the activations wide enough, the ring large enough for any
// two consecutive tiles of the schedule, `smem` its exact size.
bool mma_layout_ok(const Plan& plan, int smem) {
  int sched[kMaxLayers], fin[kMaxLayers], fout[kMaxLayers];
  for (int l = 0; l < plan.n_layers; ++l) {
    const Layer& L = plan.layers[l];
    sched[l] = l;
    fin[l] = L.fin;
    fout[l] = L.fout;
    if (L.fout > kCols || ld_bf16(L.fin) > plan.width_stride) return false;
  }
  for (int h = 0; h < plan.n_heads; ++h) {
    if (ld_bf16(plan.heads[h].emb_cols + plan.feat_dim) > plan.hin_stride) {
      return false;
    }
  }
  const long long bytes =
      2LL * (plan.w_region + static_cast<long long>(plan.points) *
                                 (plan.hin_stride + 2 * plan.width_stride)) +
      4LL * plan.points * (plan.emb_dim + plan.feat_dim);
  return plan.points > 0 && plan.points % 16 == 0 &&
         plan.hin_stride % 8 == 0 && plan.width_stride % 8 == 0 &&
         plan.w_region % 8 == 0 &&
         plan.w_region >=
             fused_mma::ring_elems(sched, plan.n_layers, fin, fout) &&
         bytes == smem;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `table` (host memory) is the plan: n_heads, emb_dim, feat_dim, then per
// head emb_cols, out_dim, n_layers and per layer fin, fout, row_off,
// bias_idx, skip_after. `outs` (host memory) holds one device pointer per
// head. The layout (`hin_stride`, `width_stride`, `w_region`, `points`,
// `smem`) is ops/fused_mlp.py::fwd_layout's. f32 (`bf16` 0): `w` is the
// packed f32 matrix, 32 points a CTA (`ctas` the chunks), strides in
// floats. bf16: `w` is its bf16 copy, strides in bf16 values, `w_region`
// the weight ring, `ctas` (at most the chunks) walk the chunks.
int fused_mlp_fwd_launch(const float* emb, const float* feat, const void* w,
                         const float* b, const int* table,
                         float* const* outs, int n, int hin_stride,
                         int width_stride, int w_region, int points, int smem,
                         int ctas, int bf16, void* stream) {
  Plan plan = {};
  plan.n = n;
  plan.hin_stride = hin_stride;
  plan.width_stride = width_stride;
  plan.points = points;
  plan.w_region = w_region;
  if (!parse_table(table, plan)) return static_cast<int>(cudaErrorInvalidValue);
  for (int h = 0; h < plan.n_heads; ++h) plan.out[h] = outs[h];
  if (bf16 ? !mma_layout_ok(plan, smem) : points != kPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (n + points - 1) / points;
  if (ctas < 1 || ctas > chunks || (!bf16 && ctas != chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_fwd_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_fwd_simt_kernel<<<ctas, kThreads, smem, st>>>(
        emb, feat, static_cast<const float*>(w), b, plan);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_fwd_mma_kernel<<<ctas, kMmaThreads, smem, st>>>(
      emb, feat, static_cast<const __nv_bfloat16*>(w), b, plan);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
