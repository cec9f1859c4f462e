// bf16 tensor-core tiles shared by the fused-heads kernels
// (fused_mlp_fwd.cu, fused_mlp_bwd.cu): cp.async staging of the weight
// tiles and the inputs, ldmatrix, mma.sync m16n8k16 with f32
// accumulation, one CTA-level product
//
//   Y[M x N] = A[M x K] . B
//
// with A bf16 row-major in shared memory and B a layer's weight tile in
// shared memory. A weight tile is the layer's block of the packed [R, 128]
// matrix (weight.T) as stored, rows [0, round16(fin)) by columns
// [0, round16(fout)), so one tile serves three products:
//   - the forward and the backward's recompute, X W: B = W, stored
//     [K rows][N columns], fragments by ldmatrix.trans;
//   - the backward's dX = G Wᵀ: B = Wᵀ, whose [N][K] storage is the same
//     tile, fragments by plain ldmatrix.
// Every bf16 row in shared memory is padded to a multiple of 16 values
// (the mma depth), zero past its width, plus 8 values of stride
// (ld_bf16): an odd multiple of 16 bytes, so the eight rows an ldmatrix
// reads fall in different banks. On top of the product: a hidden layer
// (bias, leaky_relu, bf16 rounding, padding, skip) as the forward and the
// recompute both run it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fused_mma {

constexpr int kMmaThreads = 512;  // the tensor-core kernels: 16 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kCols = 128;        // columns of the packed weights

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// Shared-memory row stride, in bf16 values, of a row of `cols` values.
__host__ __device__ __forceinline__ int ld_bf16(int cols) {
  return round16(cols) + 8;
}

// bf16 values of a layer's weight tile in shared memory.
__host__ __device__ __forceinline__ int w_tile_elems(int fin, int fout) {
  return round16(fin) * ld_bf16(fout);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four bytes, or zeros where `bytes` is 0 (src is not read then).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// A [16 x 16] fragment of a bf16 matrix stored row by row: four 8x8
// blocks, lane 8 i + r giving row r of block i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same for a matrix whose rows are stored as columns: each 8x8 block
// is transposed on the way to the registers.
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

// The weight ring: schedule item s (a layer's tile) sits at the start of
// the region if s is even, at its end if odd, so two consecutive items
// never overlap as long as the region holds any two consecutive tiles of
// the schedule (checked by the launchers).
struct WeightRing {
  __nv_bfloat16* region;
  int elems;               // bf16 values of the region
  const __nv_bfloat16* w;  // the packed bf16 weights [R, 128]

  __device__ __forceinline__ __nv_bfloat16* tile(int s, int fin,
                                                 int fout) const {
    return (s & 1) ? region + elems - w_tile_elems(fin, fout) : region;
  }

  // Item s, a layer (row_off, fin, fout), into its end of the ring, by the
  // whole CTA, once every warp is past item s - 1 (so done with item s -
  // 2, which sat there), as one cp.async group: rows [0, round8(fin)),
  // round16(fout) values each (zero past fin and fout, as packed), in
  // 16-byte units, thread t taking units t, t + kMmaThreads, ...; rows
  // [round8(fin), round16(fin)), which would be the next layer's, are
  // zeroed.
  __device__ __forceinline__ void stage(int s, int row_off, int fin,
                                        int fout) const {
    __nv_bfloat16* dst = tile(s, fin, fout);
    const __nv_bfloat16* src = w + static_cast<size_t>(row_off) * kCols;
    const int ld = ld_bf16(fout), units = round16(fout) / 8;
    const int rows = round8(fin), t = threadIdx.x;
    const int dr = kMmaThreads / units, dc = kMmaThreads % units;
    for (int r = t / units, c = t % units; r < rows;) {
      cp_async16(dst + r * ld + c * 8, src + static_cast<size_t>(r) * kCols +
                                           c * 8);
      r += dr;
      c += dc;
      if (c >= units) {
        c -= units;
        ++r;
      }
    }
    for (int u = t; u < (round16(fin) - rows) * units; u += kMmaThreads) {
      *reinterpret_cast<uint4*>(dst + (rows + u / units) * ld +
                                (u % units) * 8) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  }
};

// Stage the f32 inputs of the points [base, base + P) into `xin` [P, E +
// F] (each row: the embedding, then the features) with cp.async, by the
// whole CTA, a warp a row, as one commit group; zeros for points past n.
__device__ __forceinline__ void stage_inputs(float* xin, const float* emb,
                                             const float* feat, long long base,
                                             int n, int P, int E, int F) {
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < P; p += kMmaWarps) {
    const bool live = base + p < n;
    for (int c = lane; c < E; c += 32) {
      cp_async4(xin + p * (E + F) + c, live ? emb + (base + p) * E + c : emb,
                live ? 4 : 0);
    }
    for (int c = lane; c < F; c += 32) {
      cp_async4(xin + p * (E + F) + E + c,
                live ? feat + (base + p) * F + c : feat, live ? 4 : 0);
    }
  }
  cp_async_commit();
}

// A head's input h_in = [emb[:, :emb_cols], feat] as bf16 rows [P, hs]
// from the staged inputs, rounded, zero from hin_w to round16(hin_w); a
// warp a row.
__device__ __forceinline__ void hin_rows(__nv_bfloat16* hin, int hs,
                                         const float* xin, int P, int E,
                                         int F, int emb_cols) {
  const int hin_w = emb_cols + F, w16 = round16(hin_w);
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < P; p += kMmaWarps) {
    const float* x = xin + p * (E + F);
    for (int c = lane; c < w16; c += 32) {
      const float v = c < emb_cols ? x[c]
                      : c < hin_w  ? x[E + (c - emb_cols)]
                                   : 0.0f;
      hin[p * hs + c] = __float2bfloat16_rn(v);
    }
  }
}

// Warp tiles of (16 MT) rows by 32 columns, warp w taking tiles w, w +
// kMmaWarps, ...; N a multiple of 16 (a tile's second half may be
// absent).
template <int MT, bool kBT, class Epi>
__device__ __forceinline__ void mma_tiles(const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb,
                                          int M, int N, int K, Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane >> 3, r8 = lane & 7;  // ldmatrix: block, row in block
  const int m_tiles = M / (16 * MT), n_tiles = (N + 31) / 32;
  for (int t = warp; t < m_tiles * n_tiles; t += kMmaWarps) {
    const int m0 = (t % m_tiles) * 16 * MT, n0 = (t / m_tiles) * 32;
    const bool two = n0 + 16 < N;  // the tile's second 16 columns exist
    float acc[MT][4][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // blocks: (rows +0, k0), (+8, k0), (+0, k0 + 8), (+8, k0 + 8)
        ldsm_x4(a[i], A + (m0 + i * 16 + (lane & 15)) * lda + k0 +
                          (lane >> 4) * 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !two) break;
        const int nb = n0 + h * 16;
        // blocks: (k0, nb), (k0 + 8, nb), (k0, nb + 8), (k0 + 8, nb + 8):
        // the b fragments of the n8 tiles nb and nb + 8
        uint32_t b[4];
        if (kBT) {
          ldsm_x4(b, B + (nb + (q >> 1) * 8 + r8) * ldb + k0 + (q & 1) * 8);
        } else {
          ldsm_x4_trans(b, B + (k0 + (q & 1) * 8 + r8) * ldb + nb +
                               (q >> 1) * 8);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * h], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * h + 1], a[i], b[2], b[3]);
        }
      }
    }
    const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= 2 && !two) break;
        const int row = m0 + i * 16 + gr, col = n0 + j * 8 + gc;
        epi(row, col, acc[i][j][0], acc[i][j][1]);
        epi(row + 8, col, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// Y = A . B on the tensor cores, by the whole CTA: M a multiple of 16, N
// and K multiples of 16; A [M][lda] bf16; B the weight tile, [K][ldb]
// (B = W, kBT false) or [N][ldb] (B = Wᵀ, kBT true). epi(row, col, y0,
// y1) receives Y[row][col] and Y[row][col + 1] (col even) once each, in
// f32. Warp tiles of 32 rows where that still gives every warp a tile,
// else of 16. No barrier inside: the caller orders A, B and what epi
// writes.
template <bool kBT, class Epi>
__device__ __forceinline__ void cta_mma(const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* B, int ldb,
                                        int M, int N, int K, Epi epi) {
  if ((M / 32) * ((N + 31) / 32) >= kMmaWarps) {
    mma_tiles<2, kBT>(A, lda, B, ldb, M, N, K, epi);
  } else {
    mma_tiles<1, kBT>(A, lda, B, ldb, M, N, K, epi);
  }
}

__device__ __forceinline__ float leaky_relu(float y) {
  return y >= 0.0f ? y : 0.01f * y;
}

// A hidden layer of the forward (or the backward's recompute), by the
// whole CTA: nxt[:, off + c] = rnd(leaky_relu(cur W + b)[:, c]) for c <
// fout, rows [P, ld] of bf16; zero from off + fout to round16(off +
// fout); after a skip (off = hin_w) h_in in front. `bl` is the layer's f32
// bias row. No barrier inside.
__device__ __forceinline__ void hidden_layer(
    const __nv_bfloat16* cur, int cur_ld, const __nv_bfloat16* wt,
    const float* __restrict__ bl, int fin, int fout, __nv_bfloat16* nxt,
    int ld, int off, const __nv_bfloat16* hin, int hs, int P) {
  __nv_bfloat16* dst = nxt + off;
  cta_mma<false>(cur, cur_ld, wt, ld_bf16(fout), P, round16(fout),
                 round16(fin), [&](int row, int col, float y0, float y1) {
                   __nv_bfloat16* d = dst + row * ld + col;
                   y0 = leaky_relu(y0 + bl[col]);
                   if (col + 1 < fout) {
                     y1 = leaky_relu(y1 + bl[col + 1]);
                     if ((off & 1) == 0) {  // an aligned pair
                       *reinterpret_cast<__nv_bfloat162*>(d) =
                           __floats2bfloat162_rn(y0, y1);
                       return;
                     }
                     d[1] = __float2bfloat16_rn(y1);
                   }
                   if (col < fout) d[0] = __float2bfloat16_rn(y0);
                 });
  const int width = off + fout, lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < P; p += kMmaWarps) {
    if (lane < round16(width) - width) {
      nxt[p * ld + width + lane] = __float2bfloat16_rn(0.0f);
    }
    for (int c = lane; c < off; c += 32) nxt[p * ld + c] = hin[p * hs + c];
  }
}

// Host: the least ring (in bf16 values) for the cyclic schedule `sched`
// of layer indices, given each layer's fin and fout.
inline int ring_elems(const int* sched, int n_sched, const int* fin,
                      const int* fout) {
  int best = 0;
  for (int i = 0; i < n_sched; ++i) {
    const int a = sched[i], b = sched[(i + 1) % n_sched];
    const int need =
        w_tile_elems(fin[a], fout[a]) + w_tile_elems(fin[b], fout[b]);
    best = need > best ? need : best;
  }
  return best;
}

}  // namespace fused_mma
