// Every rank-0 MLP head of a field in one pass, backward, for Hopper
// (sm_90a): three kernels, launched in this order.
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
// 1. The backward. Only the inputs were saved: each CTA recomputes the
//    forward of a chunk of points head by head, then backpropagates the
//    head: d_emb, d_feat, and db into its own per-CTA partial ([ctas, L
//    128], zeroed by the caller; each column summed over the chunk's
//    points in a fixed order). CTA c takes the chunks c, c + gridDim.x,
//    ... in order; the grid is as many CTAs as fit on the card (one an SM
//    at the published widths). For every layer it writes the rounded input
//    X_l [N_pad, round8(fin)] and the rounded cotangent G_l [N_pad,
//    round8(fout)] to a scratch buffer in the compute type
//    (ops/fused_mlp.py::dw_scratch_layout), zero in the padding, with
//    16-byte stores. Bound by operations (recompute and dX: 2x the
//    forward's multiply-adds).
//    - bf16, fused_bwd_mma_kernel: 64 points a chunk (32 or 16 where a
//      plan needs the shared memory: ops/fused_mlp.py::bwd_layout), 16
//      warps. The recompute (X W) and dX (G Wᵀ) run on the tensor cores
//      (fused_mlp_mma.cuh), one bf16 weight tile in shared memory serving
//      both, staged by cp.async into a two-ended ring in schedule order
//      (per head: its layers for the recompute, then in reverse for dX),
//      the next tile loading while the current one computes. The
//      recompute keeps only two bf16 activation buffers (rows padded for
//      ldmatrix) and, of every layer output but the last, the leaky mask
//      as one bit a value; it writes each X_l to the scratch as it goes
//      (16-byte copies of the rows). The backward's f32 dX and bf16
//      rounded g share those buffers' shared memory (a union); G_l goes to
//      the scratch from the g rows. d_emb, d_feat, the db part sums and
//      the last layer's output (its sign) stay f32. ~227 KB of shared
//      memory at the published widths.
//    - f32, fused_bwd_simt_kernel: 32 points a chunk (fewer if the plan
//      needs it), 8 warps, every layer's f32 input of the head kept in
//      shared memory (~203 KB at the published widths); exact f32 FMAs on
//      the CUDA cores, a thread a 4-point x 4-column tile, weights through
//      the read-only cache.
//
// 2. fused_mlp_dw: dW_l = X_lᵀ G_l, one GEMM per layer with K = N. The TPU
//    kernel keeps dW in VMEM across its sequential grid; here the grid is
//    (output tile, slice of N): a CTA sums its slice of N in order into f32
//    registers and writes one partial [S, R, 128] (every element, padding
//    included, so the caller allocates it empty). A tile is 128 packed rows
//    by all 128 columns, so X_l is read once. bf16: mma.sync m16n8k16 on
//    the tensor cores, operands staged through shared memory by cp.async,
//    double-buffered, fragments by ldmatrix.trans (both X and G have N as
//    the slow axis). f32: exact f32 FMAs on the CUDA cores (no TF32). Bound
//    by bytes: the scratch is read once (1.23 GB a step at the published
//    widths in bf16).
//
// 3. fused_mlp_reduce: the dW slice partials and the db CTA partials summed
//    over their first axis in a fixed order, in one launch, float4 loads;
//    a small partial is split over up to 32 lanes a value (each lane sums
//    its share in order, the lanes are summed in lane order) so that it
//    fills the card. Bound by bytes.
//
// No atomics anywhere: for a given card (its SM count fixes the grids) the
// result is deterministic, bit for bit.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libfused_mlp_bwd.so fused_mlp_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_mlp_mma.cuh"

namespace {

using fused_mma::cp_async16;
using fused_mma::kCols;
using fused_mma::kMmaThreads;
using fused_mma::kMmaWarps;
using fused_mma::leaky_relu;
using fused_mma::ld_bf16;
using fused_mma::ldsm_x4_trans;
using fused_mma::mma_bf16;
using fused_mma::round16;
using fused_mma::round8;

constexpr int kMaxHeads = 8;
constexpr int kMaxLayers = 48;
constexpr int kMaxTiles = 128;
constexpr int kThreads = 256;  // the f32 backward, fused_mlp_dw, the reduction
constexpr int kTileP = 4;   // points per thread tile of the f32 products
constexpr int kLdG = kCols + 8;  // bf16 row stride of the rounded g
constexpr float kAlpha = 0.01f;

struct Layer {
  int fin, fout, row_off, bias_idx, skip_after;
  long long x_off, g_off;  // scratch offsets of X_l and G_l, in elements
};
struct Head {
  int emb_cols, out_dim, first_layer, n_layers;
};
struct Plan {
  int n_heads, emb_dim, feat_dim, n, n_pad, hin_stride, width_stride;
  int inputs_stride, points, n_bias, w_region, n_sched;
  int mask_words, last_stride, union_elems;  // bf16 path, see the kernel
  Head heads[kMaxHeads];
  Layer layers[kMaxLayers];
  unsigned char sched[2 * kMaxLayers];  // bf16: the weight schedule, layers
  const float* g[kMaxHeads];
};

// Four values of a shared [P, stride] row from column c0 (a multiple of
// 4), zero from column `cols` on: one float4 load where the row is 16-byte
// aligned (scalar loads of neighbouring threads 8 or 4 floats apart would
// conflict 8 or 4 ways in the banks), else four scalar loads. The float4
// may read past the row's end, into the buffers that follow it; those
// values are masked.
__device__ __forceinline__ float4 load4(const float* row, int c0, int cols,
                                        bool aligned) {
  float4 v;
  if (aligned) {
    v = *reinterpret_cast<const float4*>(row + c0);
  } else {
    v.x = c0 < cols ? row[c0] : 0.0f;
    v.y = c0 + 1 < cols ? row[c0 + 1] : 0.0f;
    v.z = c0 + 2 < cols ? row[c0 + 2] : 0.0f;
    v.w = c0 + 3 < cols ? row[c0 + 3] : 0.0f;
  }
  if (c0 + 4 > cols) {
    v.x = c0 < cols ? v.x : 0.0f;
    v.y = c0 + 1 < cols ? v.y : 0.0f;
    v.z = c0 + 2 < cols ? v.z : 0.0f;
    v.w = 0.0f;
  }
  return v;
}

// Rows [base, base + P) of one f32 scratch block [n_pad, width8] (width8 =
// round8(cols)) from a shared [P, stride] f32 block, in 16-byte stores:
// zero past `cols` and for points past n.
__device__ void store_block(float* scratch, long long off, int width8,
                            const float* src, int stride, int cols,
                            long long base, int n, int P) {
  const bool aligned = (stride & 3) == 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* dst = scratch + off + base * width8;
  const int units = width8 / 4;
  for (int u = threadIdx.x; u < P * units; u += kThreads) {
    const int p = u / units, c0 = (u % units) * 4;
    const bool live = base + p < n;
    *reinterpret_cast<float4*>(dst + static_cast<long long>(p) * width8 +
                               c0) =
        live ? load4(src + p * stride, c0, cols, aligned) : zero;
  }
}

// The same for a bf16 block from shared bf16 rows [P, ld] that are
// already zero from column `cols` to round8(cols): straight 16-byte
// copies, zero for points past n.
__device__ void copy_block(__nv_bfloat16* scratch, long long off, int width8,
                           const __nv_bfloat16* src, int ld, long long base,
                           int n, int P) {
  __nv_bfloat16* dst = scratch + off + base * width8;
  const int units = width8 / 8;
  for (int u = threadIdx.x; u < P * units; u += kMmaThreads) {
    const int p = u / units, c0 = (u % units) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(p) * width8 + c0) =
        base + p < n ? *reinterpret_cast<const uint4*>(src + p * ld + c0)
                     : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_bwd_simt_kernel(const float* __restrict__ emb,
                          const float* __restrict__ feat,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          float* __restrict__ d_emb,
                          float* __restrict__ d_feat,
                          float* __restrict__ scratch,
                          float* __restrict__ b_parts,
                          const __grid_constant__ Plan plan) {
  extern __shared__ float4 smem4[];
  const int P = plan.points, hs = plan.hin_stride, ws = plan.width_stride;
  const int E = plan.emb_dim, F = plan.feat_dim;
  float* ga = reinterpret_cast<float*>(smem4);  // [P, 128] g
  float* inputs = ga + P * kCols;                // every layer's input
  float* gb = inputs + P * plan.inputs_stride;   // [P, ws] dX / last output
  float* dhin = gb + P * ws;                     // [P, hs]
  float* demb = dhin + P * hs;                   // [P, E]
  float* dfeat = demb + P * E;                   // [P, F]
  const int tid = threadIdx.x;
  // chunks cover the scratch's n_pad rows: those past n are written zero
  const int n_chunks = plan.n_pad / P;
  // this CTA's db partial [n_bias, 128]
  float* part_b = b_parts + static_cast<size_t>(blockIdx.x) * kCols *
                                plan.n_bias;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long base = static_cast<long long>(chunk) * P;
    __syncthreads();  // the previous chunk's d_emb / d_feat are written
    for (int i = tid; i < P * (E + F); i += kThreads) demb[i] = 0.0f;

    for (int hd = 0; hd < plan.n_heads; ++hd) {
      const Head head = plan.heads[hd];
      const int hin_w = head.emb_cols + F;
      const Layer* layers = plan.layers + head.first_layer;
      __syncthreads();  // the previous chunk or head is done with the buffers

      // ---- recompute: inputs[0] = h_in, inputs[l + 1] = out l
      for (int i = tid; i < P * hin_w; i += kThreads) {
        const int p = i / hin_w, c = i % hin_w;
        const long long gp = base + p;
        float v = 0.0f;
        if (gp < plan.n) {
          v = c < head.emb_cols ? emb[gp * E + c]
                                : feat[gp * F + (c - head.emb_cols)];
        }
        inputs[p * hin_w + c] = v;
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
            const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
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
              nxt[(p0 + i) * nstride + off + c] = leaky_relu(acc[i][j] + bias);
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
        //    db += sum_p g; ga = g, zero past fout. The h_in part of the
        //    dX after a skip goes to d_h_in.
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
            ga[p * kCols + c] = g;
          }
          if (c < L.fout) part_b[L.bias_idx * kCols + c] += db_acc;
        } else if (L.skip_after) {
          for (int i = tid - kCols; i < P * hin_w; i += kThreads - kCols) {
            const int p = i / hin_w, c = i % hin_w;
            dhin[p * hs + c] += gb[p * ws + c];
          }
        }
        __syncthreads();
        // 2. X_l and G_l to the scratch, for fused_mlp_dw
        store_block(scratch, L.x_off, round8(L.fin), inp, L.fin, L.fin, base,
                    plan.n, P);
        store_block(scratch, L.g_off, round8(L.fout), ga, kCols, L.fout, base,
                    plan.n, P);
        // 3. dX[p, k] = sum_j ga[p, j] W[k, j], into gb, 4 x 4 per thread
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
                wk[kk][0] = wv.x;
                wk[kk][1] = wv.y;
                wk[kk][2] = wv.z;
                wk[kk][3] = wv.w;
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

// Shared memory, in order: the weight ring; a union of the recompute's
// bf16 rows (h_in [P, hs] and two activation buffers [P, ws]) and the
// backward's dX gb [P, ws] (f32) and rounded g ga [P, kLdG] (bf16); the
// leaky masks of every layer but the last, one bit a value (mask_words
// words a point); the last layer's output [P, last_stride] (f32, for its
// sign); the db part sums [kMmaThreads]; d_emb [P, E] and d_feat [P, F]; the
// chunk's inputs xin [P, E + F] (f32).
__global__ void __launch_bounds__(kMmaThreads, 1)
    fused_bwd_mma_kernel(const float* __restrict__ emb,
                         const float* __restrict__ feat,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ b,
                         float* __restrict__ d_emb,
                         float* __restrict__ d_feat,
                         __nv_bfloat16* __restrict__ scratch,
                         float* __restrict__ b_parts,
                         const __grid_constant__ Plan plan) {
  extern __shared__ float4 smem4[];
  const int P = plan.points, hs = plan.hin_stride, ws = plan.width_stride;
  const int E = plan.emb_dim, F = plan.feat_dim, lo = plan.last_stride;
  const fused_mma::WeightRing ring = {
      reinterpret_cast<__nv_bfloat16*>(smem4), plan.w_region, w};
  __nv_bfloat16* uni = ring.region + plan.w_region;
  __nv_bfloat16* hin = uni;
  __nv_bfloat16* bufs[2] = {uni + P * hs, uni + P * hs + P * ws};
  float* gb = reinterpret_cast<float*>(uni);
  __nv_bfloat16* ga = uni + 2 * P * ws;
  uint32_t* masks = reinterpret_cast<uint32_t*>(uni + plan.union_elems);
  float* lastout = reinterpret_cast<float*>(masks + P * plan.mask_words);
  float* parts = lastout + P * lo;
  float* demb = parts + kMmaThreads;
  float* dfeat = demb + P * E;
  float* xin = dfeat + P * F;
  const int tid = threadIdx.x;
  // chunks cover the scratch's n_pad rows: those past n are written zero
  const int n_chunks = plan.n_pad / P;
  // this CTA's db partial [n_bias, 128]
  float* part_b = b_parts + static_cast<size_t>(blockIdx.x) * kCols *
                                plan.n_bias;
  // schedule item s is layer sched[s % n_sched]; it sits at one end of the
  // ring or the other by the parity of s
  auto stage = [&](int s) {
    const Layer& L = plan.layers[plan.sched[s % plan.n_sched]];
    ring.stage(s, L.row_off, L.fin, L.fout);
  };
  // item s (layer L) has landed and every warp is past item s - 1, whose
  // end of the ring is then free for item s + 1 (unless s is the last)
  int s = 0;
  auto next_tile = [&](const Layer& L, bool final_item) {
    fused_mma::cp_async_wait_all();
    __syncthreads();
    if (!final_item) stage(s + 1);
    return ring.tile(s++, L.fin, L.fout);
  };
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
      const Layer* layers = plan.layers + head.first_layer;
      const bool last_head = hd == plan.n_heads - 1;
      // the previous head or chunk is done with the buffers; the chunk's
      // inputs have landed (staged during the previous chunk)
      if (hd == 0) fused_mma::cp_async_wait_all();
      __syncthreads();
      if (hd == 0) {
        for (int i = tid; i < P * (E + F); i += kMmaThreads) demb[i] = 0.0f;
      }
      fused_mma::hin_rows(hin, hs, xin, P, E, F, head.emb_cols);

      // ---- recompute: X_l = rnd(input of layer l) to the scratch, the
      //      leaky mask of every output, the last output in f32
      int mo = 0;  // offset of the next layer's masks
      for (int li = 0; li < head.n_layers; ++li) {
        const Layer L = layers[li];
        const int fout = L.fout;
        const __nv_bfloat16* wt = next_tile(L, false);
        if (more && last_head && li == 0) {  // every h_in is built
          fused_mma::stage_inputs(xin, emb, feat,
                                  base + static_cast<long long>(gridDim.x) * P,
                                  plan.n, P, E, F);
        }
        const __nv_bfloat16* cur = li == 0 ? hin : bufs[(li - 1) & 1];
        const int cld = li == 0 ? hs : ws;
        // X_l to the scratch, for fused_mlp_dw
        copy_block(scratch, L.x_off, round8(L.fin), cur, cld, base, plan.n, P);
        if (li > 0) {  // the signs of the previous layer's output
          const Layer& Lp = layers[li - 1];
          const int words = (Lp.fout + 31) / 32;
          const __nv_bfloat16* out = cur + (Lp.skip_after ? hin_w : 0);
          const int lane = tid & 31;
          for (int i = tid >> 5; i < P * words; i += kMmaWarps) {
            const int p = i / words, c = (i % words) * 32 + lane;
            const uint32_t bits = __ballot_sync(
                0xffffffffu,
                c < Lp.fout && __bfloat162float(out[p * cld + c]) >= 0.0f);
            if (lane == 0) masks[mo + i] = bits;
          }
          mo += P * words;
        }
        const float* bl = b + static_cast<size_t>(L.bias_idx) * kCols;
        if (li == head.n_layers - 1) {
          fused_mma::cta_mma<false>(
              cur, cld, wt, ld_bf16(fout), P, round16(fout), round16(L.fin),
              [&](int row, int col, float y0, float y1) {
                if (col < fout) {
                  lastout[row * lo + col] = leaky_relu(y0 + bl[col]);
                }
                if (col + 1 < fout) {
                  lastout[row * lo + col + 1] = leaky_relu(y1 + bl[col + 1]);
                }
              });
        } else {
          fused_mma::hidden_layer(cur, cld, wt, bl, L.fin, fout, bufs[li & 1],
                                  ws, L.skip_after ? hin_w : 0, hin, hs, P);
        }
      }
      __syncthreads();  // the last output and every mask are written

      // ---- backward, last layer first
      for (int li = head.n_layers - 1; li >= 0; --li) {
        const Layer L = layers[li];
        const bool last = li == head.n_layers - 1;
        const int fout = L.fout, words = (fout + 31) / 32;
        if (!last) mo -= P * words;
        // 1. g = leaky mask * (cotangent, or the dX tail after a skip);
        //    ga = rnd(g), zero from fout to round16(fout). The column sums
        //    of g (db) in `parts` part sums of consecutive points, cw
        //    threads a part. The h_in part of the dX after a skip goes to
        //    d_emb / d_feat.
        const int off = L.skip_after ? hin_w : 0;
        int cw = 1;
        while (cw < fout) cw *= 2;
        const int n_parts = kMmaThreads / cw < P ? kMmaThreads / cw : P;
        const int per = P / n_parts;
        {
          const int c = tid & (cw - 1), part = tid / cw;
          if (part < n_parts && c < fout) {
            float acc = 0.0f;
            for (int p = part * per; p < (part + 1) * per; ++p) {
              float src;
              bool pos;
              if (last) {
                const long long gp = base + p;
                src = gp < plan.n ? plan.g[hd][gp * head.out_dim + c] : 0.0f;
                pos = lastout[p * lo + c] >= 0.0f;
              } else {
                src = gb[p * ws + off + c];
                pos = (masks[mo + p * words + c / 32] >> (c & 31)) & 1u;
              }
              const float g = pos ? src : kAlpha * src;
              acc += g;
              ga[p * kLdG + c] = __float2bfloat16_rn(g);
            }
            parts[part * cw + c] = acc;
          }
        }
        {
          const int pad = round16(fout) - fout;
          for (int i = tid; i < P * pad; i += kMmaThreads) {
            ga[(i / pad) * kLdG + fout + i % pad] = __float2bfloat16_rn(0.0f);
          }
        }
        if (L.skip_after) {
          for (int i = tid; i < P * hin_w; i += kMmaThreads) {
            const int p = i / hin_w, c = i % hin_w;
            if (c < head.emb_cols) {
              demb[p * E + c] += gb[p * ws + c];
            } else {
              dfeat[p * F + (c - head.emb_cols)] += gb[p * ws + c];
            }
          }
        }
        const __nv_bfloat16* wt =
            next_tile(L, !more && last_head && li == 0);
        if (tid < fout) {  // db: the parts in order, into this CTA's partial
          float sum = 0.0f;
          for (int part = 0; part < n_parts; ++part) {
            sum += parts[part * cw + tid];
          }
          part_b[L.bias_idx * kCols + tid] += sum;
        }
        // 2. G_l to the scratch, for fused_mlp_dw
        copy_block(scratch, L.g_off, round8(fout), ga, kLdG, base, plan.n, P);
        // 3. dX = rnd(g) rnd(W)ᵀ, into gb, on the tensor cores
        fused_mma::cta_mma<true>(
            ga, kLdG, wt, ld_bf16(fout), P, round16(L.fin), round16(fout),
            [&](int row, int col, float y0, float y1) {
              *reinterpret_cast<float2*>(gb + row * ws + col) =
                  make_float2(y0, y1);
            });
        __syncthreads();
      }
      // ---- the dX of layer 0 is d_h_in: its prefix goes to d_emb, the
      //      rest to d_feat
      for (int i = tid; i < P * hin_w; i += kMmaThreads) {
        const int p = i / hin_w, c = i % hin_w;
        if (c < head.emb_cols) {
          demb[p * E + c] += gb[p * ws + c];
        } else {
          dfeat[p * F + (c - head.emb_cols)] += gb[p * ws + c];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < P * (E + F); i += kMmaThreads) {
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
  fused_mma::cp_async_wait_all();
}

// ---- fused_mlp_dw -----------------------------------------------------------

constexpr int kDwTile = 128;  // packed rows (of round8(fin)) and columns a tile
constexpr int kDwK = 32;      // points a stage, tensor-core path
constexpr int kDwKf = 16;     // points a stage, f32 path
constexpr int kDwLd = kDwTile + 8;  // bf16 a shared row: ldmatrix conflict-free

struct DwLayer {
  long long x_off, g_off;  // scratch offsets, elements
  int m, n, row_off;       // round8(fin), round8(fout), packed row offset
};
struct DwPlan {
  int n_tiles, n_pad, slice_rows, n_rows;
  DwLayer layers[kMaxLayers];
  int2 tiles[kMaxTiles];  // (layer, first row within the layer's block)
};

struct DwCta {
  DwLayer L;
  int m0, mw, k_begin, k_end;  // tile rows [m0, m0 + mw), points [k_begin, k_end)
};

__device__ __forceinline__ DwCta dw_cta(const DwPlan& plan) {
  const int2 tile = plan.tiles[blockIdx.x];
  DwCta c;
  c.L = plan.layers[tile.x];
  c.m0 = tile.y;
  c.mw = min(kDwTile, c.L.m - tile.y);
  c.k_begin = blockIdx.y * plan.slice_rows;
  c.k_end = min(plan.n_pad, c.k_begin + plan.slice_rows);
  return c;
}

// bf16: 8 warps as 4 (rows) x 2 (columns), a warp tile of 32 x 64, that is
// 2 x 8 mma tiles of 16 x 8. A = X_lᵀ (rows of the tile are X's columns),
// B = G_l; both are stored [points, columns] in shared memory, so both
// fragments come from ldmatrix.trans. Columns past round8(fin) or
// round8(fout) stay zero in shared memory (never written by cp.async), so
// the padding of the partial comes out zero.
__global__ void __launch_bounds__(kThreads, 2)
    dw_mma_kernel(const __nv_bfloat16* __restrict__ scratch,
                  float* __restrict__ parts, const __grid_constant__ DwPlan plan) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kDwK][kDwLd];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kDwK][kDwLd];
  const DwCta c = dw_cta(plan);
  const int nw = c.L.n;
  const int n_k = max(0, (c.k_end - c.k_begin) / kDwK);
  const __nv_bfloat16* X = scratch + c.L.x_off;  // [n_pad, m]
  const __nv_bfloat16* G = scratch + c.L.g_off;  // [n_pad, n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  {
    uint4* zx = reinterpret_cast<uint4*>(&xs[0][0][0]);
    uint4* zg = reinterpret_cast<uint4*>(&gs[0][0][0]);
    for (int i = tid; i < static_cast<int>(sizeof(xs) / 16); i += kThreads) {
      zx[i] = make_uint4(0, 0, 0, 0);
      zg[i] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int xu = c.mw / 8, gu = nw / 8;  // 16-byte units a row
  auto load = [&](int stage, int k0) {
    for (int u = tid; u < kDwK * xu; u += kThreads) {
      const int r = u / xu, col = (u % xu) * 8;
      cp_async16(&xs[stage][r][col],
                 X + static_cast<long long>(k0 + r) * c.L.m + c.m0 + col);
    }
    for (int u = tid; u < kDwK * gu; u += kThreads) {
      const int r = u / gu, col = (u % gu) * 8;
      cp_async16(&gs[stage][r][col],
                 G + static_cast<long long>(k0 + r) * nw + col);
    }
  };

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int q = lane >> 3, r8 = lane & 7;  // ldmatrix: block, row in block
  float acc[2][8][4] = {};
  if (n_k > 0) load(0, c.k_begin);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) load((kt + 1) & 1, c.k_begin + (kt + 1) * kDwK);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int st = kt & 1;
    if (wm < c.mw && wn < nw) {
#pragma unroll
      for (int kk = 0; kk < kDwK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // blocks: (points kk.., rows +0), (kk.., +8), (kk+8.., +0), (kk+8.., +8)
          ldsm_x4_trans(a[i], &xs[st][kk + (q >> 1) * 8 + r8]
                                  [wm + i * 16 + (q & 1) * 8]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int n0 = wn + jp * 16;
          if (n0 < nw) {
            // blocks: (points kk.., cols n0), (kk+8.., n0), (kk.., n0+8),
            // (kk+8.., n0+8): the b fragments of two n8 tiles
            uint32_t bf[4];
            ldsm_x4_trans(bf, &gs[st][kk + (q & 1) * 8 + r8][n0 + (q >> 1) * 8]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * jp], a[i], bf[0], bf[1]);
              mma_bf16(acc[i][2 * jp + 1], a[i], bf[2], bf[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is read before it is loaded again
  }

  float* out = parts + static_cast<size_t>(blockIdx.y) * plan.n_rows * kCols +
               static_cast<size_t>(c.L.row_off + c.m0) * kCols;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = wm + i * 16 + gr, col = wn + j * 8 + gc;
      if (row < c.mw) {
        *reinterpret_cast<float2*>(out + row * kCols + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      }
      if (row + 8 < c.mw) {
        *reinterpret_cast<float2*>(out + (row + 8) * kCols + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// f32: each thread sums an 8 x 8 block of the tile (rows ty*8.., columns
// tx*8..) over the slice's points in order, one exact FMA per product.
__global__ void __launch_bounds__(kThreads)
    dw_simt_kernel(const float* __restrict__ scratch,
                   float* __restrict__ parts,
                   const __grid_constant__ DwPlan plan) {
  __shared__ __align__(16) float xs[kDwKf][kDwTile];
  __shared__ __align__(16) float gs[kDwKf][kDwTile];
  const DwCta c = dw_cta(plan);
  const int nw = c.L.n;
  const float* X = scratch + c.L.x_off;
  const float* G = scratch + c.L.g_off;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[8][8] = {};
  for (int k0 = c.k_begin; k0 < c.k_end; k0 += kDwKf) {
    for (int u = tid; u < kDwKf * (kDwTile / 4); u += kThreads) {
      const int r = u / (kDwTile / 4), col = (u % (kDwTile / 4)) * 4;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&xs[r][col]) =
          col < c.mw ? *reinterpret_cast<const float4*>(
                           X + static_cast<long long>(k0 + r) * c.L.m +
                           c.m0 + col)
                     : zero;
      *reinterpret_cast<float4*>(&gs[r][col]) =
          col < nw ? *reinterpret_cast<const float4*>(
                         G + static_cast<long long>(k0 + r) * nw + col)
                   : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kDwKf; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(&xs[k][ty * 8]);
      const float4 x1 = *reinterpret_cast<const float4*>(&xs[k][ty * 8 + 4]);
      const float4 g0 = *reinterpret_cast<const float4*>(&gs[k][tx * 8]);
      const float4 g1 = *reinterpret_cast<const float4*>(&gs[k][tx * 8 + 4]);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(xv[i], gv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = parts + static_cast<size_t>(blockIdx.y) * plan.n_rows * kCols +
               static_cast<size_t>(c.L.row_off + c.m0) * kCols;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
    if (row >= c.mw) break;
    float4* dst = reinterpret_cast<float4*>(out + row * kCols + tx * 8);
    dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---- fused_mlp_reduce -------------------------------------------------------

struct RedSeg {
  const float4* in;  // [g, m4]
  float4* out;       // [m4]
  int g, m4, lanes, blocks;
};

// out[o] = sum over g of in[g, o]: `lanes` threads a value, lane l summing
// g = l, l + lanes, ... in order; then the lanes, in lane order. A block
// holds 256 / lanes values, the lanes of one value in different warps, so
// that neighbouring threads read neighbouring float4s.
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const RedSeg a, const RedSeg b) {
  __shared__ float4 part[kThreads];
  // field by field: selecting a whole struct would copy it to the stack
  const bool first = blockIdx.x < a.blocks;
  const float4* __restrict__ in = first ? a.in : b.in;
  float4* __restrict__ out = first ? a.out : b.out;
  const int g_count = first ? a.g : b.g, m4 = first ? a.m4 : b.m4;
  const int lanes = first ? a.lanes : b.lanes;
  const int blk = first ? blockIdx.x : blockIdx.x - a.blocks;
  const int per = kThreads / lanes;
  const int lane = threadIdx.x / per, j = threadIdx.x % per;
  const int o = blk * per + j;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (o < m4) {
    for (int g = lane; g < g_count; g += lanes) {
      const float4 v = __ldcs(in + static_cast<size_t>(g) * m4 + o);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  if (lanes == 1) {
    if (o < m4) out[o] = acc;
    return;
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (lane == 0 && o < m4) {
    for (int l = 1; l < lanes; ++l) {
      const float4 v = part[l * per + j];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out[o] = acc;
  }
}

// Lanes a value: doubled, up to 32 and to g, until the segment has about
// 1,024 threads an SM.
RedSeg red_seg(const float* in, float* out, int g, int m, int sms) {
  RedSeg s = {reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
              g, m / 4, 1, 0};
  while (s.lanes < 32 && s.lanes * 2 <= g &&
         static_cast<long long>(s.m4) * s.lanes < 1024LL * sms) {
    s.lanes *= 2;
  }
  const int per = kThreads / s.lanes;
  s.blocks = (s.m4 + per - 1) / per;
  return s;
}

// Parses the plan table of ops/fused_mlp.py::plan_table into `layers`
// (n_layers of them, at most kMaxLayers) and `heads` (if given); returns
// the packed row count, or -1 if the table is out of bounds.
int parse_table(const int* table, Layer* layers, int* n_layers, Head* heads) {
  const int n_heads = table[0];
  if (n_heads < 1 || n_heads > kMaxHeads) return -1;
  int pos = 3, count = 0, n_rows = 0;
  for (int h = 0; h < n_heads; ++h) {
    Head head = {table[pos], table[pos + 1], count, table[pos + 2]};
    pos += 3;
    if (count + head.n_layers > kMaxLayers) return -1;
    for (int l = 0; l < head.n_layers; ++l, pos += 5) {
      Layer L = {table[pos], table[pos + 1], table[pos + 2], table[pos + 3],
                 table[pos + 4], 0, 0};
      layers[count++] = L;
      n_rows = L.row_off + round8(L.fin);
    }
    if (heads != nullptr) heads[h] = head;
  }
  *n_layers = count;
  return n_rows;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `table` (host memory) is the plan as in fused_mlp_fwd_launch; `gs`
// (host memory) one device pointer per head to its cotangent [N, out];
// `offs` (host memory) the scratch offsets x_off, g_off of every layer
// (ops/fused_mlp.py::dw_scratch_layout, n_pad rows). `b_parts` is [ctas,
// L 128], zeroed. The layout (`hin_stride`, `width_stride`,
// `inputs_stride`, `w_region`, `points` dividing n_pad, `smem`) is
// ops/fused_mlp.py::bwd_layout's. f32 (`bf16` 0): `w` and `scratch` f32,
// per point 4 (128 + inputs_stride + width_stride + hin_stride + E + F)
// bytes. bf16: `w` the bf16 copy of the packed weights, `scratch` bf16,
// bf16 row strides, `inputs_stride` unused, and the bytes of the
// kernel's shared memory as laid out there.
int fused_mlp_bwd_launch(const float* emb, const float* feat, const void* w,
                         const float* b, const int* table,
                         const float* const* gs, float* d_emb, float* d_feat,
                         void* scratch, const long long* offs, float* b_parts,
                         int n, int n_pad, int hin_stride, int width_stride,
                         int inputs_stride, int w_region, int points, int smem,
                         int ctas, int bf16, void* stream) {
  Plan plan = {};
  plan.n_heads = table[0];
  plan.emb_dim = table[1];
  plan.feat_dim = table[2];
  plan.n = n;
  plan.n_pad = n_pad;
  plan.hin_stride = hin_stride;
  plan.width_stride = width_stride;
  plan.inputs_stride = inputs_stride;
  plan.points = points;
  plan.w_region = w_region;
  int n_layers = 0;
  if (points <= 0 || points % (bf16 ? 16 : 4) != 0 || n_pad % points != 0 ||
      n_pad < n || ctas <= 0 ||
      parse_table(table, plan.layers, &n_layers, plan.heads) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < n_layers; ++l) {
    plan.layers[l].x_off = offs[2 * l];
    plan.layers[l].g_off = offs[2 * l + 1];
  }
  for (int h = 0; h < plan.n_heads; ++h) plan.g[h] = gs[h];
  plan.n_bias = n_layers;  // one bias row per layer
  if (bf16) {
    // the weight schedule, and a layout that holds it
    int sched[2 * kMaxLayers], fin[kMaxLayers], fout[kMaxLayers];
    int hin_max = 0, fin_max = 0;
    for (int h = 0; h < plan.n_heads; ++h) {
      const Head& head = plan.heads[h];
      int words = 0;
      for (int l = 0; l < head.n_layers; ++l) {
        const Layer& L = plan.layers[head.first_layer + l];
        sched[plan.n_sched++] = head.first_layer + l;
        fin_max = L.fin > fin_max ? L.fin : fin_max;
        if (L.fout > kCols) return static_cast<int>(cudaErrorInvalidValue);
        if (l < head.n_layers - 1) words += (L.fout + 31) / 32;
      }
      for (int l = head.n_layers - 1; l >= 0; --l) {
        sched[plan.n_sched++] = head.first_layer + l;
      }
      const int hin_w = head.emb_cols + plan.feat_dim;
      const int last_fout = plan.layers[head.first_layer + head.n_layers - 1].fout;
      hin_max = hin_w > hin_max ? hin_w : hin_max;
      plan.mask_words = words > plan.mask_words ? words : plan.mask_words;
      plan.last_stride = last_fout > plan.last_stride ? last_fout : plan.last_stride;
    }
    for (int l = 0; l < n_layers; ++l) {
      fin[l] = plan.layers[l].fin;
      fout[l] = plan.layers[l].fout;
    }
    for (int i = 0; i < plan.n_sched; ++i) {
      plan.sched[i] = static_cast<unsigned char>(sched[i]);
    }
    const int recompute = points * (hin_stride + 2 * width_stride);
    const int backward = 2 * points * width_stride + points * kLdG;
    plan.union_elems = recompute > backward ? recompute : backward;
    const long long bytes =
        2LL * (w_region + plan.union_elems) +
        4LL * points *
            (plan.mask_words + plan.last_stride +
             2 * (plan.emb_dim + plan.feat_dim)) +
        4LL * kMmaThreads;
    if ((points & (points - 1)) != 0 || points % 16 != 0 ||
        hin_stride < ld_bf16(hin_max) || hin_stride % 8 != 0 ||
        width_stride < ld_bf16(fin_max) || width_stride % 8 != 0 ||
        w_region % 8 != 0 ||
        w_region < fused_mma::ring_elems(sched, plan.n_sched, fin, fout) ||
        bytes != smem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_bwd_mma_kernel<<<ctas, kMmaThreads, smem, st>>>(
        emb, feat, static_cast<const __nv_bfloat16*>(w), b, d_emb, d_feat,
        static_cast<__nv_bfloat16*>(scratch), b_parts, plan);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        fused_bwd_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_bwd_simt_kernel<<<ctas, kThreads, smem, st>>>(
        emb, feat, static_cast<const float*>(w), b, d_emb, d_feat,
        static_cast<float*>(scratch), b_parts, plan);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dW slice partials `parts` [slices, R 128] from the scratch (bf16 on the
// tensor cores if `bf16`, else f32): `table` and `offs` as for the
// backward, `tiles` [n_tiles, 2] (host memory) the (layer, first row)
// output tiles of ops/fused_mlp.py::dw_tiles; slice s takes the points
// [s slice_rows, min(n_pad, (s + 1) slice_rows)).
int fused_mlp_dw_launch(const void* scratch, float* parts, const int* table,
                        const long long* offs, const int* tiles, int n_tiles,
                        int n_pad, int slice_rows, int slices, int bf16,
                        void* stream) {
  Layer layers[kMaxLayers];
  int n_layers = 0;
  const int n_rows = parse_table(table, layers, &n_layers, nullptr);
  if (n_rows < 0 || n_tiles <= 0 || n_tiles > kMaxTiles || slices <= 0 ||
      n_pad % kDwK != 0 || slice_rows <= 0 || slice_rows % kDwK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwPlan plan = {};
  plan.n_tiles = n_tiles;
  plan.n_pad = n_pad;
  plan.slice_rows = slice_rows;
  plan.n_rows = n_rows;
  for (int l = 0; l < n_layers; ++l) {
    const Layer& L = layers[l];
    if (L.fout > kCols) return static_cast<int>(cudaErrorInvalidValue);
    plan.layers[l] = {offs[2 * l], offs[2 * l + 1], round8(L.fin),
                      round8(L.fout), L.row_off};
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int layer = tiles[2 * t], m0 = tiles[2 * t + 1];
    if (layer < 0 || layer >= n_layers || m0 < 0 || m0 >= plan.layers[layer].m) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    plan.tiles[t] = make_int2(layer, m0);
  }
  const dim3 grid(n_tiles, slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dw_mma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(scratch), parts, plan);
  } else {
    dw_simt_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(scratch), parts, plan);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out_a [m_a] and out_b [m_b] = the sums of part_a [g_a, m_a] and part_b
// [g_b, m_b] over their first axis, in a fixed order, in one launch; m_a
// and m_b multiples of 4, every pointer 16-byte aligned.
int fused_mlp_reduce_launch(const float* part_a, float* out_a, int g_a,
                            int m_a, const float* part_b, float* out_b,
                            int g_b, int m_b, int sms, void* stream) {
  if (m_a % 4 != 0 || m_b % 4 != 0 || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RedSeg a = red_seg(part_a, out_a, g_a, m_a, sms);
  const RedSeg b = red_seg(part_b, out_b, g_b, m_b, sms);
  if (a.blocks + b.blocks == 0) return 0;
  reduce_kernel<<<a.blocks + b.blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_mlp_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
