// Every rank-0 MLP head of a field in one pass, backward, for Hopper
// (sm_90a), and the fixed-order sum of its weight-gradient partials.
//
// Replaces splatfields_tpu/ops/fused_mlp.py::_fused_vjp_bwd (kernel body
// _bwd_kernel). Same contract: for the forward of fused_mlp_fwd.cu and
// one cotangent g[h] [N, out_dim] per head, it gives d_emb [N, E] (the sum
// over heads of each head's h_in gradient on its emb_cols prefix), d_feat
// [N, F], and dW [R, 128], db [L, 128] (zero in the padding). Rounding as
// the TPU kernel's, to the compute type (bf16 or f32):
//   - the recomputed layer inputs are kept rounded;
//   - the leaky_relu mask is the sign of the layer's (stored) output;
//   - g is rounded before both the dW and the dX product, every product
//     sums in f32, db sums the unrounded g.
//
// Design. Only the inputs were saved: each CTA recomputes the forward of
// a chunk of `points` points head by head, keeping every layer's input in
// shared memory (at the published widths the rgb head keeps 1,070 values
// a point: 32 points take 137 KB), then backpropagates the head through
// them. The TPU kernel adds dW and db across its sequential grid into one
// block that stays in VMEM. Here CTAs run in parallel and in no order, so
// the grid is fixed (as many CTAs as fit on the card at once) and CTA c
// takes the chunks c, c + gridDim.x, ... in order, adding each chunk's
// dW/db into its own partial in device memory (`partials`, [gridDim.x,
// (R + L) 128], zeroed by the caller). Every element of a partial has one
// owner thread per layer and is summed over the chunk's points in order.
// fused_mlp_reduce then sums the partials in CTA order. No atomics: the
// result is deterministic, bit for bit, for a given grid.
//
// Bound. Recompute, dX and dW are each one product per layer: ~3x the
// forward's multiply-adds (at the published widths 931,008 a point), so
// the kernel is bound by operations, like the forward. The partials'
// read-modify-write adds (R + L) x 128 x 8 bytes per chunk per CTA (1.2
// MB for the downstream plan), mostly in L2. This first version uses f32
// FMAs on bf16-rounded operands and no tensor cores: later work. At ~200
// KB of shared memory a CTA, one CTA (8 warps) runs on an SM, too few to
// hide the load latency; scripts/profile_fused_bwd.py splits the time
// between the recompute, the dW partials and the dX products.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libfused_mlp_bwd.so fused_mlp_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHeads = 8;
constexpr int kMaxLayers = 48;
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kTileP = 4;   // points per thread tile of the products
constexpr float kAlpha = 0.01f;

struct Layer {
  int fin, fout, row_off, bias_idx, skip_after;
};
struct Head {
  int emb_cols, out_dim, first_layer, n_layers;
};
struct Plan {
  int n_heads, emb_dim, feat_dim, n, hin_stride, width_stride, inputs_stride;
  int points, bf16, n_rows, n_bias;
  Head heads[kMaxHeads];
  Layer layers[kMaxLayers];
  const float* g[kMaxHeads];
};

__device__ __forceinline__ float rnd(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__global__ void __launch_bounds__(kThreads)
    fused_bwd_kernel(const float* __restrict__ emb,
                     const float* __restrict__ feat,
                     const float* __restrict__ w,
                     const float* __restrict__ b,
                     float* __restrict__ d_emb, float* __restrict__ d_feat,
                     float* __restrict__ partials,
                     const __grid_constant__ Plan plan) {
  extern __shared__ float4 smem4[];
  const int P = plan.points, hs = plan.hin_stride, ws = plan.width_stride;
  const int E = plan.emb_dim, F = plan.feat_dim, bf16 = plan.bf16;
  float* ga = reinterpret_cast<float*>(smem4);  // [P, 128] rounded g
  float* inputs = ga + P * kCols;                // every layer's input
  float* gb = inputs + P * plan.inputs_stride;   // [P, ws] dX / last output
  float* dhin = gb + P * ws;                     // [P, hs]
  float* demb = dhin + P * hs;                   // [P, E]
  float* dfeat = demb + P * E;                   // [P, F]
  const int tid = threadIdx.x;
  const int n_chunks = (plan.n + P - 1) / P;
  // this CTA's partial: dW [n_rows, 128], then db [n_bias, 128]
  float* part_w = partials + static_cast<size_t>(blockIdx.x) * kCols *
                                 (plan.n_rows + plan.n_bias);
  float* part_b = part_w + static_cast<size_t>(plan.n_rows) * kCols;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long base = static_cast<long long>(chunk) * P;
    __syncthreads();  // the previous chunk's d_emb / d_feat are written
    for (int i = tid; i < P * (E + F); i += kThreads) demb[i] = 0.0f;

    for (int hd = 0; hd < plan.n_heads; ++hd) {
      const Head head = plan.heads[hd];
      const int hin_w = head.emb_cols + F;
      const Layer* layers = plan.layers + head.first_layer;
      __syncthreads();  // the previous chunk or head is done with the buffers

      // ---- recompute: inputs[0] = rnd(h_in), inputs[l + 1] = rnd(out l)
      for (int i = tid; i < P * hin_w; i += kThreads) {
        const int p = i / hin_w, c = i % hin_w;
        const long long gp = base + p;
        float v = 0.0f;
        if (gp < plan.n) {
          v = c < head.emb_cols ? emb[gp * E + c]
                                : feat[gp * F + (c - head.emb_cols)];
        }
        inputs[p * hin_w + c] = rnd(v, bf16);
        dhin[p * hs + c] = 0.0f;
      }
      __syncthreads();
      int in_off = 0;  // offset of layer l's input region
      for (int li = 0; li < head.n_layers; ++li) {
        const Layer L = layers[li];
        const bool last = li == head.n_layers - 1;
        const float* cur = inputs + in_off;          // [P, L.fin]
        const int out_off = in_off + P * L.fin;
        const int nfin = last ? 0 : layers[li + 1].fin;
        float* nxt = last ? gb : inputs + out_off;   // [P, next fin]
        const int nstride = last ? ws : nfin;
        const int off = L.skip_after ? hin_w : 0;
        const int n_ct = (L.fout + 3) / 4;
        const float* wl = w + static_cast<size_t>(L.row_off) * kCols;
        const float* bl = b + static_cast<size_t>(L.bias_idx) * kCols;
        for (int t = tid; t < (P / kTileP) * n_ct; t += kThreads) {
          const int c0 = (t % n_ct) * 4, p0 = (t / n_ct) * kTileP;
          float acc[kTileP][4] = {};
          for (int k = 0; k < L.fin; ++k) {
            const float4 wv = __ldg(
                reinterpret_cast<const float4*>(wl + k * kCols + c0));
            const float wk[4] = {rnd(wv.x, bf16), rnd(wv.y, bf16),
                                 rnd(wv.z, bf16), rnd(wv.w, bf16)};
#pragma unroll
            for (int i = 0; i < kTileP; ++i) {
              const float hv = cur[(p0 + i) * L.fin + k];
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
            for (int i = 0; i < kTileP; ++i) {
              float y = acc[i][j] + bias;
              y = y >= 0.0f ? y : kAlpha * y;
              // the last output stays f32: only its sign is read
              nxt[(p0 + i) * nstride + off + c] = last ? y : rnd(y, bf16);
            }
          }
        }
        if (L.skip_after) {  // the next input is [h_in, x]
          for (int i = tid; i < P * hin_w; i += kThreads) {
            const int p = i / hin_w, c = i % hin_w;
            nxt[p * nstride + c] = inputs[p * hin_w + c];
          }
        }
        __syncthreads();
        in_off = out_off;
      }

      // ---- backward, last layer first
      for (int li = head.n_layers - 1; li >= 0; --li) {
        const Layer L = layers[li];
        const bool last = li == head.n_layers - 1;
        in_off -= P * L.fin;
        const float* inp = inputs + in_off;  // [P, L.fin]
        // 1. g = leaky mask * (cotangent, or the dX tail after a skip);
        //    db += sum_p g; ga = rnd(g), zero past fout. The h_in part of
        //    the dX after a skip goes to d_h_in.
        const int off = L.skip_after ? hin_w : 0;
        if (tid < kCols) {
          const int c = tid;
          float db_acc = 0.0f;
          for (int p = 0; p < P; ++p) {
            float g = 0.0f;
            if (c < L.fout) {
              const long long gp = base + p;
              float src, out;
              if (last) {
                src = gp < plan.n ? plan.g[hd][gp * head.out_dim + c] : 0.0f;
                out = gb[p * ws + c];
              } else {
                src = gb[p * ws + off + c];
                out = inp[P * L.fin + p * layers[li + 1].fin + off + c];
              }
              g = out >= 0.0f ? src : kAlpha * src;
              db_acc += g;
            }
            ga[p * kCols + c] = rnd(g, bf16);
          }
          if (c < L.fout) part_b[L.bias_idx * kCols + c] += db_acc;
        } else if (L.skip_after) {
          for (int i = tid - kCols; i < P * hin_w; i += kThreads - kCols) {
            const int p = i / hin_w, c = i % hin_w;
            dhin[p * hs + c] += gb[p * ws + c];
          }
        }
        __syncthreads();
        // 2. dW[k, j] += sum_p inp[p, k] ga[p, j], 4 x 4 per thread
        {
          const int n_jt = (L.fout + 3) / 4, n_kt = (L.fin + 3) / 4;
          float* pw = part_w + static_cast<size_t>(L.row_off) * kCols;
          for (int t = tid; t < n_kt * n_jt; t += kThreads) {
            const int j0 = (t % n_jt) * 4, k0 = (t / n_jt) * 4;
            float acc[4][4] = {};
            for (int p = 0; p < P; ++p) {
              const float4 gv =
                  *reinterpret_cast<const float4*>(ga + p * kCols + j0);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float x =
                    k0 + i < L.fin ? inp[p * L.fin + k0 + i] : 0.0f;
                acc[i][0] = __fmaf_rn(x, gv.x, acc[i][0]);
                acc[i][1] = __fmaf_rn(x, gv.y, acc[i][1]);
                acc[i][2] = __fmaf_rn(x, gv.z, acc[i][2]);
                acc[i][3] = __fmaf_rn(x, gv.w, acc[i][3]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (k0 + i >= L.fin) break;
              float4* dst = reinterpret_cast<float4*>(pw + (k0 + i) * kCols + j0);
              float4 v = *dst;
              v.x += acc[i][0];
              v.y += acc[i][1];
              v.z += acc[i][2];
              v.w += acc[i][3];
              *dst = v;
            }
          }
        }
        // 3. dX[p, k] = sum_j ga[p, j] rnd(W[k, j]), into gb, 4 x 4 per thread
        {
          const int n_kt = (L.fin + 3) / 4, n_jq = (L.fout + 3) / 4;
          const float* wl = w + static_cast<size_t>(L.row_off) * kCols;
          for (int t = tid; t < (P / kTileP) * n_kt; t += kThreads) {
            const int k0 = (t % n_kt) * 4, p0 = (t / n_kt) * kTileP;
            float acc[kTileP][4] = {};  // [point][k]
            for (int jq = 0; jq < n_jq; ++jq) {
              const int j0 = jq * 4;
              float wk[4][4];  // [k][j]; rows past fin are zero padding
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float4 wv = __ldg(reinterpret_cast<const float4*>(
                    wl + (k0 + kk) * kCols + j0));
                wk[kk][0] = rnd(wv.x, bf16);
                wk[kk][1] = rnd(wv.y, bf16);
                wk[kk][2] = rnd(wv.z, bf16);
                wk[kk][3] = rnd(wv.w, bf16);
              }
#pragma unroll
              for (int i = 0; i < kTileP; ++i) {
                const float4 gv = *reinterpret_cast<const float4*>(
                    ga + (p0 + i) * kCols + j0);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                  float a = acc[i][kk];
                  a = __fmaf_rn(gv.x, wk[kk][0], a);
                  a = __fmaf_rn(gv.y, wk[kk][1], a);
                  a = __fmaf_rn(gv.z, wk[kk][2], a);
                  a = __fmaf_rn(gv.w, wk[kk][3], a);
                  acc[i][kk] = a;
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kTileP; ++i) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                if (k0 + kk < L.fin) gb[(p0 + i) * ws + k0 + kk] = acc[i][kk];
              }
            }
          }
        }
        __syncthreads();
      }
      // ---- d_h_in += dX of layer 0; its prefix goes to d_emb, the rest
      //      to d_feat
      for (int i = tid; i < P * hin_w; i += kThreads) {
        const int p = i / hin_w, c = i % hin_w;
        const float v = dhin[p * hs + c] + gb[p * ws + c];
        if (c < head.emb_cols) {
          demb[p * E + c] += v;
        } else {
          dfeat[p * F + (c - head.emb_cols)] += v;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < P * (E + F); i += kThreads) {
      const int p = i / (E + F), c = i % (E + F);
      const long long gp = base + p;
      if (gp >= plan.n) continue;
      if (c < E) {
        d_emb[gp * E + c] = demb[p * E + c];
      } else {
        d_feat[gp * F + (c - E)] = dfeat[p * F + (c - E)];
      }
    }
  }
}

// out[m] = sum over g = 0 .. G-1, in that order, of partials[g, m]
__global__ void reduce_kernel(const float* __restrict__ partials,
                              float* __restrict__ out, int g_count, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float acc = 0.0f;
  for (int g = 0; g < g_count; ++g) {
    acc += partials[static_cast<size_t>(g) * m + i];
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `table` (host memory) is the plan as in fused_mlp_fwd_launch; `gs`
// (host memory) one device pointer per head to its cotangent [N, out].
// `partials` is [ctas, (R + L) 128], zeroed; `points` (a multiple of 4)
// and `smem` come from ops/fused_mlp.py::bwd_layout: per point
// 4 (128 + inputs_stride + width_stride + hin_stride + E + F) bytes.
int fused_mlp_bwd_launch(const float* emb, const float* feat, const float* w,
                         const float* b, const int* table,
                         const float* const* gs, float* d_emb, float* d_feat,
                         float* partials, int n, int hin_stride,
                         int width_stride, int inputs_stride, int points,
                         int smem, int ctas, int bf16, void* stream) {
  Plan plan = {};
  plan.n_heads = table[0];
  plan.emb_dim = table[1];
  plan.feat_dim = table[2];
  plan.n = n;
  plan.hin_stride = hin_stride;
  plan.width_stride = width_stride;
  plan.inputs_stride = inputs_stride;
  plan.points = points;
  plan.bf16 = bf16;
  if (plan.n_heads < 1 || plan.n_heads > kMaxHeads || points % 4 != 0 ||
      points <= 0 || ctas <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int pos = 3, n_layers = 0, n_rows = 0;
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
      const Layer L = {table[pos], table[pos + 1], table[pos + 2],
                       table[pos + 3], table[pos + 4]};
      plan.layers[n_layers++] = L;
      n_rows = L.row_off + ((L.fin + 7) / 8) * 8;
    }
    plan.g[h] = gs[h];
  }
  plan.n_rows = n_rows;
  plan.n_bias = n_layers;  // one bias row per layer
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_bwd_kernel<<<ctas, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      emb, feat, w, b, d_emb, d_feat, partials, plan);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [m] = the sum of partials [g_count, m] over its first axis, in order.
int fused_mlp_reduce_launch(const float* partials, float* out, int g_count,
                            int m, void* stream) {
  if (m == 0) return 0;
  reduce_kernel<<<(m + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(partials, out, g_count,
                                                       m);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
