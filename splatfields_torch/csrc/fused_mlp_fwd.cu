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
// out too: a CTA takes kPoints points and runs every head of the plan for
// them with the activations in shared memory; only the inputs are read
// and only the heads' outputs written. The plan (layer widths, row and
// bias offsets, skips) is a kernel parameter, so one build serves every
// plan. A thread computes a 4-point x 4-column tile of a layer's output
// with f32 FMAs over the layer's inputs, reading the weights (at most a
// few MB, L2-resident) as float4 through the read-only cache. In bf16
// mode both operands are rounded in registers first: a product of two
// bf16 values is exact in f32, so the FMA rounds only the sum, as the
// TPU's matrix unit does. The ragged last block is masked: rows past N
// compute on zeros and are not written.
//
// Bound. At the published widths a point needs 310,336 multiply-adds
// over both plans and moves ~400 bytes, so the kernel is bound by
// operations: on tensor cores at the bf16 rate, here on the f32 units.
// This first version uses no tensor cores (wgmma), no TMA and no weight
// tiles in shared memory: that is later work.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libfused_mlp_fwd.so fused_mlp_fwd.cu
// --fmad=false keeps a*b+c from being fused behind our back; the FMAs
// here are explicit (__fmaf_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHeads = 8;
constexpr int kMaxLayers = 48;
constexpr int kCols = 128;    // columns of the packed weights and biases
constexpr int kPoints = 32;   // points per CTA
constexpr int kThreads = 256;
constexpr float kAlpha = 0.01f;

struct Layer {
  int fin, fout, row_off, bias_idx, skip_after;
};
struct Head {
  int emb_cols, out_dim, first_layer, n_layers;
};
struct Plan {
  int n_heads, emb_dim, feat_dim, n, hin_stride, width_stride, bf16;
  Head heads[kMaxHeads];
  Layer layers[kMaxLayers];
  float* out[kMaxHeads];
};

__device__ __forceinline__ float rnd(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__global__ void __launch_bounds__(kThreads)
    fused_fwd_kernel(const float* __restrict__ emb,
                     const float* __restrict__ feat,
                     const float* __restrict__ w,
                     const float* __restrict__ b,
                     const __grid_constant__ Plan plan) {
  extern __shared__ float smem[];
  const int hs = plan.hin_stride, ws = plan.width_stride;
  float* hin = smem;                    // [kPoints, hs], f32
  float* buf0 = hin + kPoints * hs;     // [kPoints, ws], rounded
  float* buf1 = buf0 + kPoints * ws;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kPoints;
  const int E = plan.emb_dim, F = plan.feat_dim, bf16 = plan.bf16;

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
      buf0[p * ws + c] = rnd(v, bf16);
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
          const float wk[4] = {rnd(wv.x, bf16), rnd(wv.y, bf16),
                               rnd(wv.z, bf16), rnd(wv.w, bf16)};
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
            float y = acc[i][j] + bias;
            y = y >= 0.0f ? y : kAlpha * y;
            const long long gp = base + p0 + i;
            if (!last) {
              nxt[(p0 + i) * ws + off + c] = rnd(y, bf16);
            } else if (gp < plan.n) {
              plan.out[hd][gp * head.out_dim + c] = y;
            }
          }
        }
      }
      if (L.skip_after) {  // the next input is [h_in, x]
        for (int i = tid; i < kPoints * hin_w; i += kThreads) {
          const int p = i / hin_w, c = i % hin_w;
          nxt[p * ws + c] = rnd(hin[p * hs + c], bf16);
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `table` (host memory) is the plan: n_heads, emb_dim, feat_dim, then per
// head emb_cols, out_dim, n_layers and per layer fin, fout, row_off,
// bias_idx, skip_after. `outs` (host memory) holds one device pointer per
// head. `hin_stride` and `width_stride` are the widest h_in and the widest
// layer input or output; `smem` = 4 * 32 * (hin_stride + 2 width_stride).
int fused_mlp_fwd_launch(const float* emb, const float* feat, const float* w,
                         const float* b, const int* table,
                         float* const* outs, int n, int hin_stride,
                         int width_stride, int smem, int bf16,
                         void* stream) {
  Plan plan = {};
  plan.n_heads = table[0];
  plan.emb_dim = table[1];
  plan.feat_dim = table[2];
  plan.n = n;
  plan.hin_stride = hin_stride;
  plan.width_stride = width_stride;
  plan.bf16 = bf16;
  if (plan.n_heads < 1 || plan.n_heads > kMaxHeads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int pos = 3, n_layers = 0;
  for (int h = 0; h < plan.n_heads; ++h) {
    Head& head = plan.heads[h];
    head.emb_cols = table[pos];
    head.out_dim = table[pos + 1];
    head.n_layers = table[pos + 2];
    head.first_layer = n_layers;
    pos += 3;
    if (n_layers + head.n_layers > kMaxLayers) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int l = 0; l < head.n_layers; ++l, pos += 5) {
      plan.layers[n_layers++] = {table[pos], table[pos + 1], table[pos + 2],
                                 table[pos + 3], table[pos + 4]};
    }
    plan.out[h] = outs[h];
  }
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kPoints - 1) / kPoints;
  fused_fwd_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(emb, feat, w, b,
                                                          plan);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
