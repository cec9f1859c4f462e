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
// 1. fused_bwd_kernel. Only the inputs were saved: each CTA recomputes the
//    forward of a chunk of `points` points head by head, keeping every
//    layer's input in shared memory (at the published widths the rgb head
//    keeps 1,070 values a point: 32 points take 137 KB), then
//    backpropagates the head through them: d_emb, d_feat, and db into its
//    own per-CTA partial ([ctas, L 128], zeroed by the caller). CTA c takes
//    the chunks c, c + gridDim.x, ... in order. For every layer it writes
//    the rounded input X_l [N_pad, round8(fin)] and the rounded cotangent
//    G_l [N_pad, round8(fout)] to a scratch buffer in the compute type
//    (ops/fused_mlp.py::dw_scratch_layout), zero in the padding, with
//    16-byte stores. Bound by operations (recompute and dX: 2x the
//    forward's multiply-adds, f32 FMAs on rounded operands, no tensor cores
//    yet); at ~200 KB of shared memory one CTA (8 warps) runs on an SM.
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

namespace {

constexpr int kMaxHeads = 8;
constexpr int kMaxLayers = 48;
constexpr int kMaxTiles = 128;
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kTileP = 4;   // points per thread tile of the products
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
  int inputs_stride, points, bf16, n_bias;
  Head heads[kMaxHeads];
  Layer layers[kMaxLayers];
  const float* g[kMaxHeads];
};

__device__ __forceinline__ float rnd(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [base, base + P) of one scratch block [n_pad, width8] (width8 =
// round8(cols)) from a shared [P, stride] f32 block, in 16-byte stores:
// zero past `cols` and for points past n. The values are already rounded
// to the compute type, so the conversion is exact.
__device__ void store_block(void* scratch, long long off, int width8,
                            const float* src, int stride, int cols,
                            long long base, int n, int P, int bf16) {
  const bool aligned = (stride & 3) == 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (bf16) {
    __nv_bfloat16* dst =
        static_cast<__nv_bfloat16*>(scratch) + off + base * width8;
    const int units = width8 / 8;
    for (int u = threadIdx.x; u < P * units; u += kThreads) {
      const int p = u / units, c0 = (u % units) * 8;
      const bool live = base + p < n;
      const float* row = src + p * stride;
      const float4 a = live ? load4(row, c0, cols, aligned) : zero;
      const float4 b = live ? load4(row, c0 + 4, cols, aligned) : zero;
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(p) * width8 +
                                c0) =
          make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                     pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
  } else {
    float* dst = static_cast<float*>(scratch) + off + base * width8;
    const int units = width8 / 4;
    for (int u = threadIdx.x; u < P * units; u += kThreads) {
      const int p = u / units, c0 = (u % units) * 4;
      const bool live = base + p < n;
      *reinterpret_cast<float4*>(dst + static_cast<long long>(p) * width8 +
                                 c0) =
          live ? load4(src + p * stride, c0, cols, aligned) : zero;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_bwd_kernel(const float* __restrict__ emb,
                     const float* __restrict__ feat,
                     const float* __restrict__ w,
                     const float* __restrict__ b,
                     float* __restrict__ d_emb, float* __restrict__ d_feat,
                     void* __restrict__ scratch,
                     float* __restrict__ b_parts,
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
        // 2. X_l and G_l to the scratch, for fused_mlp_dw
        store_block(scratch, L.x_off, round8(L.fin), inp, L.fin, L.fin, base,
                    plan.n, P, bf16);
        store_block(scratch, L.g_off, round8(L.fout), ga, kCols, L.fout, base,
                    plan.n, P, bf16);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// A [16 x 16] fragment of a bf16 matrix whose rows are stored as columns:
// four 8x8 blocks, each transposed on the way to the registers.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// (ops/fused_mlp.py::dw_scratch_layout, n_pad rows). `scratch` is bf16 if
// `bf16`, else f32; `b_parts` is [ctas, L 128], zeroed. `points` (dividing
// n_pad) and `smem` come from ops/fused_mlp.py::bwd_layout: per point
// 4 (128 + inputs_stride + width_stride + hin_stride + E + F) bytes.
int fused_mlp_bwd_launch(const float* emb, const float* feat, const float* w,
                         const float* b, const int* table,
                         const float* const* gs, float* d_emb, float* d_feat,
                         void* scratch, const long long* offs, float* b_parts,
                         int n, int n_pad, int hin_stride, int width_stride,
                         int inputs_stride, int points, int smem, int ctas,
                         int bf16, void* stream) {
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
  plan.bf16 = bf16;
  int n_layers = 0;
  if (points <= 0 || points % 4 != 0 || n_pad % points != 0 || n_pad < n ||
      ctas <= 0 || parse_table(table, plan.layers, &n_layers, plan.heads) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < n_layers; ++l) {
    plan.layers[l].x_off = offs[2 * l];
    plan.layers[l].g_off = offs[2 * l + 1];
  }
  for (int h = 0; h < plan.n_heads; ++h) plan.g[h] = gs[h];
  plan.n_bias = n_layers;  // one bias row per layer
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_bwd_kernel<<<ctas, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      emb, feat, w, b, d_emb, d_feat, scratch, b_parts, plan);
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
