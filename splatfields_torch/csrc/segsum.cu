// Segment sum of sorted rows, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/segsum_pallas.py::sorted_segment_sum
// (kernel body _seg_kernel). Same contract: for ascending int32 ids
// sidx [M] and f32 rows vals [M, D], any D >= 1,
//   out[r] = sum of vals[j] over j with sidx[j] == r,   out [n_rows, D],
// ids below 0 or at or above n_rows are dropped, rows that receive
// nothing are 0. It is the transpose of a row gather: the gradient of the
// NGP hash table, with the ids sorted by the caller. The result is
// deterministic, bit for bit: every sum runs in an order fixed by the
// data alone, and nothing is added atomically.
//
// Bound. Each slot is read once (4 bytes of id, 4 D bytes of values) and
// each output row written once (4 D bytes); one add a value. At the NGP
// step's shape (12.8M slots, D = 2, 2^24 rows) that is 287,817,728 bytes,
// 0.0859 ms at 3.35 TB/s: the kernel is bound by memory traffic.
//
// Design. The TPU kernel streams K-slot chunks and sums each with a
// one-hot mask matmul on the MXU; none of that carries over. Here:
//
// - Work by merge path. The output rows and the slots, merged in the order
//   "slot j before the end of row r iff sidx[j] <= r", form n_rows + M
//   items; merge-path block b takes the items [b C, (b + 1) C), C =
//   `items` (a launch argument: 8,192 at D <= 2). A slot's place in that
//   order is j + clamp(sidx[j], 0, n_rows), strictly increasing in j, so a
//   warp finds the split of a diagonal with a 32-way search (32 probes a
//   step, five dependent loads for 12.8M slots), then the first slot of
//   the split's row (for rows > 0 almost always among the 32 slots below
//   the split: one more load). Block b owns the rows [r0, r1) whose ends
//   lie in its items and exactly the slots whose ids lie in them,
//   [s0, s1). Every block holds about C rows plus slots, whether its rows
//   are dense (level 0: ~160 slots a row), hashed (~1.4) or empty (the ~1M
//   rows past each dense level's grid): no block is an outlier and no
//   search runs per row. A row whose slots began in an earlier block's
//   items is summed whole by the block that owns its end, so a row longer
//   than C (none in the NGP step, whose longest is 324) lies on one block.
// - One cooperative launch, two phases. Phase 1: the grid's warps find
//   all n_blocks + 1 splits, two diagonals a warp in lockstep, into a
//   scratch of ints; a grid-wide barrier; phase 2: the resident blocks
//   (three an SM at D = 2) take merge-path blocks blockIdx.x,
//   + gridDim.x, ... and read their edges. Searching inside each block
//   put ~6 dependent loads before every block's first load (an earlier
//   build so: 0.129-0.135 ms on the NGP step; two phases: 0.121, of which
//   phase 2 alone, the edges given, 0.108).
// - Slots read once, coalesced. A step takes 1,024 slots, four
//   consecutive ones a thread: ids as one int4, values as D float4 when
//   D <= 4 (four slots hold 4 D floats, so every thread's values start on
//   16 bytes), one float4 a slot when D % 4 == 0, scalars otherwise (and
//   for views off 16-byte alignment). The next step's loads are issued
//   before this step's sums.
// - Segmented sums without a search. A slot starts a segment when its id
//   differs from the previous slot's (head flag). Each thread sums its
//   four slots in order, the warp combines the threads' trailing partials
//   with a segmented Hillis-Steele scan (5 shuffle rounds), the block the
//   warps' totals in warp order, and a step's last partial carries into
//   the next step. A segment's total is written by the slot after its end
//   (or, for the block's last slot, after the last step). The order of
//   every sum depends on the slots' positions only: launches repeat bit
//   for bit.
// - Every output row written once. The totals land in a shared-memory
//   image of the block's rows [r0, r1), zeros included, which the block
//   then stores with float4 stores aligned to 16 bytes of `out` (scalars
//   at the two ends). No memset, no scattered global writes.
// - D > 4 runs the step loop once for each 4 columns (each value still
//   read once, the ids once a pass), storing each pass's columns row by
//   row. One launch for any D.
//
// Tried and dropped (NGP step, H100, graph replay, scripts/
// profile_segsum.py): 1,024 / 2,048 / 4,096 / 6,144 items a block (0.224 /
// 0.150 / 0.128 / 0.125 ms against 0.121 at 8,192: more edges to search
// and more block ends); a cap of 64 registers for four blocks an SM
// (spills, 0.130); issuing each step's loads at its own start (0.128).
// The sums cost little: loads, row image and stores alone take 0.120.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libsegsum.so segsum.cu

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                  // consecutive slots a thread
constexpr int kStep = kThreads * kSlots;   // slots a block takes a step
constexpr int kCols = 4;                   // columns a pass at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDead = INT_MAX;             // id of a slot past the range

// how a group of four slots is loaded
enum Mode { kRow, kSlot4, kScalar };

// For each of N searches, the first position p in [lo[n], hi[n]] with
// pred(n, p); pred is monotone in p (false, then true) and taken as true
// at hi[n]. Each step the 32 lanes probe 32 evenly spaced positions of
// every open range, the N searches' loads issued together (one dependent
// load a step), and each range shrinks 32 times. The answers are left in
// lo. Every lane of the warp calls it.
template <int N, class Pred>
__device__ void warp_search(int (&lo)[N], int (&hi)[N], Pred pred,
                            int lane) {
  for (;;) {
    bool open = false, t[N];
    long long s[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      s[n] = (static_cast<long long>(hi[n]) - lo[n] + 31) / 32;
      const long long p = lo[n] + lane * s[n] + s[n] - 1;
      t[n] = hi[n] <= lo[n] || p >= hi[n] || pred(n, static_cast<int>(p));
      open = open || hi[n] > lo[n];
    }
    if (!open) return;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (hi[n] <= lo[n]) continue;   // uniform over the warp
      const unsigned m = __ballot_sync(kFull, t[n]);
      if (m == 0) {
        lo[n] = hi[n];
        continue;
      }
      const int l = __ffs(m) - 1;
      const long long hit = lo[n] + l * s[n] + s[n] - 1;
      lo[n] = static_cast<int>(lo[n] + l * s[n]);
      if (hit < hi[n]) hi[n] = static_cast<int>(hit);
    }
  }
}

// The merge-path splits of N diagonals k[n], found together: the rows
// whose end lies among the first k items (`row`) and the first slot of
// row `row` (`slot`).
template <int N>
__device__ void split(const long long (&k)[N], const int* __restrict__ sidx,
                      int m, int n_rows, int lane, int (&row)[N],
                      int (&slot)[N]) {
  int lo[N], hi[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    lo[n] = static_cast<int>(k[n] - n_rows > 0 ? k[n] - n_rows : 0);
    hi[n] = static_cast<int>(k[n] < m ? k[n] : m);
  }
  // slots among the first k items: the first j with j + clamp(sidx[j],
  // 0, n_rows) >= k
  warp_search(lo, hi, [&](int n, int p) {
    const int id = __ldg(sidx + p);
    const int c = id < 0 ? 0 : (id > n_rows ? n_rows : id);
    return p + static_cast<long long>(c) >= k[n];
  }, lane);
  // the first slot with id >= row. For row > 0 it lies in [0, j] (the
  // slot at j has id >= row), almost always among the 32 slots below j;
  // for row 0 anywhere (negative ids may follow j)
  bool below[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    row[n] = static_cast<int>(k[n] - lo[n]);
    below[n] = row[n] > 0 && lo[n] > 32 &&
               __ldg(sidx + lo[n] - 32 + lane) >= row[n];
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = lo[n];
    if (row[n] == 0) {
      hi[n] = m;
      lo[n] = 0;
    } else if (j <= 32) {
      hi[n] = j;
      lo[n] = 0;
    } else {
      const unsigned win = __ballot_sync(kFull, below[n]);
      if (win & 1u) {            // at or before slot j - 32
        hi[n] = j - 32;
        lo[n] = 0;
      } else {                   // in the window
        lo[n] = hi[n] = win ? j - 32 + __ffs(win) - 1 : j;
      }
    }
  }
  warp_search(lo, hi, [&](int n, int p) { return __ldg(sidx + p) >= row[n]; },
              lane);
#pragma unroll
  for (int n = 0; n < N; ++n) slot[n] = lo[n];
}

template <int W>
struct Group {
  int key[kSlots];
  float val[kSlots][W];
  int prev;   // id of the slot before the group (read by lane 0)
};

// Slots j0 .. j0 + 3 of the block's range (live below s1; a dead slot has
// id kDead and values 0), columns c0 .. c0 + W - 1 (0 past d).
template <int W, int kMode>
__device__ __forceinline__ void load_group(Group<W>& g,
                                           const int* __restrict__ sidx,
                                           const float* __restrict__ vals,
                                           int j0, int s1, int d, int c0,
                                           int lane) {
  if (lane == 0) {
    g.prev = j0 == 0 ? INT_MIN : (j0 - 1 < s1 ? __ldg(sidx + j0 - 1) : kDead);
  }
  if (kMode != kScalar && j0 + kSlots <= s1) {
    const int4 k4 = __ldg(reinterpret_cast<const int4*>(sidx + j0));
    g.key[0] = k4.x;
    g.key[1] = k4.y;
    g.key[2] = k4.z;
    g.key[3] = k4.w;
    if (kMode == kRow) {   // W == d: the group's 4 W floats are W float4
      float f[kSlots * W];
      const float4* src =
          reinterpret_cast<const float4*>(vals + static_cast<size_t>(j0) * W);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float4 x = __ldg(src + e);
        f[4 * e] = x.x;
        f[4 * e + 1] = x.y;
        f[4 * e + 2] = x.z;
        f[4 * e + 3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
#pragma unroll
        for (int w = 0; w < W; ++w) g.val[q][w] = f[q * W + w];
      }
    } else {   // kSlot4: W == 4, d % 4 == 0, c0 % 4 == 0
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(
            vals + static_cast<size_t>(j0 + q) * d + c0));
        g.val[q][0] = x.x;
        g.val[q][1] = x.y;
        g.val[q][2] = x.z;
        g.val[q][3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int j = j0 + q;
      const bool live = j < s1;
      g.key[q] = live ? __ldg(sidx + j) : kDead;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        g.val[q][w] = live && c0 + w < d
            ? __ldg(vals + static_cast<size_t>(j) * d + c0 + w) : 0.0f;
      }
    }
  }
}

// One step's segment sums. `carry` enters as the running sum of the
// segment open at the step's start and leaves as the one open at its end.
// Totals of segments that end inside the step go to `buf` (rows r0..r1).
template <int W>
__device__ __forceinline__ void step_sums(const Group<W>& g, float* carry,
                                          float* buf, int off, int r0,
                                          int r1, float (*agg_v)[W],
                                          int* agg_f, int lane, int warp) {
  const int up = __shfl_up_sync(kFull, g.key[kSlots - 1], 1);
  const int prev = lane == 0 ? g.prev : up;
  bool head[kSlots];
  head[0] = g.key[0] != prev;
#pragma unroll
  for (int q = 1; q < kSlots; ++q) head[q] = g.key[q] != g.key[q - 1];

  // the thread's trailing partial: its slots from its last head on
  float inc[W];
  bool flag = head[0];
#pragma unroll
  for (int w = 0; w < W; ++w) inc[w] = g.val[0][w];
#pragma unroll
  for (int q = 1; q < kSlots; ++q) {
    flag = flag || head[q];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      inc[w] = head[q] ? g.val[q][w] : inc[w] + g.val[q][w];
    }
  }
  // segmented inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool uf = __shfl_up_sync(kFull, static_cast<int>(flag), o) != 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float u = __shfl_up_sync(kFull, inc[w], o);
      if (lane >= o && !flag) inc[w] = u + inc[w];
    }
    if (lane >= o) flag = flag || uf;
  }
  if (lane == 31) {
    agg_f[warp] = flag;
#pragma unroll
    for (int w = 0; w < W; ++w) agg_v[warp][w] = inc[w];
  }
  __syncthreads();
  // the carry into this warp and out of the step, folded in warp order
  float cw[W], c[W];
#pragma unroll
  for (int w = 0; w < W; ++w) c[w] = cw[w] = carry[w];
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const bool f = agg_f[v];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (v == warp) cw[w] = c[w];
      c[w] = f ? agg_v[v][w] : c[w] + agg_v[v][w];
    }
  }
  // the running sum of the segment open before this thread's first slot
  const bool f1 = __shfl_up_sync(kFull, static_cast<int>(flag), 1) != 0;
  float run[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float u = __shfl_up_sync(kFull, inc[w], 1);
    run[w] = lane == 0 ? cw[w] : (f1 ? u : cw[w] + u);
    carry[w] = c[w];
  }
  // walk the four slots: a head closes the segment before it
  int key = prev;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (head[q] && key >= r0 && key < r1) {
      float* b = buf + (key - r0) * W + off;
#pragma unroll
      for (int w = 0; w < W; ++w) b[w] = run[w];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      run[w] = head[q] ? g.val[q][w] : run[w] + g.val[q][w];
    }
    key = g.key[q];
  }
}

// The sums of one merge-path block: rows [r0, r1), slots [s0, s1).
template <int W, int kMode>
__device__ __forceinline__ void block_sums(
    const int* __restrict__ sidx, const float* __restrict__ vals,
    float* __restrict__ out, int d, int r0, int r1, int s0, int s1,
    float* buf, float (*agg_v)[kWarps][W], int (*agg_f)[kWarps],
    int& parity) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // with W == d the block's rows are one float range; `off` puts its
  // 16-byte-aligned start at buf[0]
  const int off = W == d ? static_cast<int>((static_cast<long long>(r0) * d) & 3)
                         : 0;
  const int n_buf = ((r1 - r0) * W + off + 3) & ~3;
  const int a = s0 & ~(kSlots - 1);

  for (int c0 = 0; c0 < d; c0 += W) {
    for (int e = 4 * tid; e < n_buf; e += 4 * kThreads) {
      *reinterpret_cast<float4*>(buf + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float carry[W];
#pragma unroll
    for (int w = 0; w < W; ++w) carry[w] = 0.0f;
    int last = kDead;
    Group<W> cur, nxt;
    if (a < s1) {
      load_group<W, kMode>(cur, sidx, vals, a + kSlots * tid, s1, d, c0, lane);
    }
    for (int t0 = a; t0 < s1; t0 += kStep) {
      if (t0 + kStep < s1) {
        load_group<W, kMode>(nxt, sidx, vals, t0 + kStep + kSlots * tid, s1,
                             d, c0, lane);
      }
      step_sums<W>(cur, carry, buf, off, r0, r1, agg_v[parity],
                   agg_f[parity], lane, warp);
      last = cur.key[kSlots - 1];
      cur = nxt;
      parity ^= 1;
    }
    // the segment open after the last step ends at the block's last slot
    if (tid == kThreads - 1 && last >= r0 && last < r1) {
      float* b = buf + (last - r0) * W + off;
#pragma unroll
      for (int w = 0; w < W; ++w) b[w] = carry[w];
    }
    __syncthreads();

    if (W == d) {   // rows [r0, r1) are out[r0 d, r1 d)
      const long long g0 = static_cast<long long>(r0) * d;
      const long long g1 = static_cast<long long>(r1) * d;
      const long long base = g0 - off;
      for (long long q = base + 4 * tid; q < g1; q += 4 * kThreads) {
        const float* b = buf + (q - base);
        if (kMode != kScalar && q >= g0 && q + 4 <= g1) {
          *reinterpret_cast<float4*>(out + q) =
              *reinterpret_cast<const float4*>(b);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (q + e >= g0 && q + e < g1) out[q + e] = b[e];
          }
        }
      }
    } else {   // columns c0 .. c0 + W - 1 of each row
      const int wn = d - c0 < W ? d - c0 : W;
      for (int r = r0 + tid; r < r1; r += kThreads) {
        const float* b = buf + (r - r0) * W;
        float* o = out + static_cast<size_t>(r) * d + c0;
        if (kMode == kSlot4) {
          *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(b);
        } else {
          for (int w = 0; w < wn; ++w) o[w] = b[w];
        }
      }
    }
    __syncthreads();   // buf is reused by the next pass or block
  }
}

// Launched cooperatively with every block resident (see the header).
// Phase 1: the grid's warps find the split of each of the n_blocks + 1
// diagonals into `edges` (rows, first slot). Phase 2, after a grid-wide
// barrier: each block takes merge-path blocks blockIdx.x, + gridDim.x,
// ... and reads its two edges.
template <int W, int kMode>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int* __restrict__ sidx, const float* __restrict__ vals,
              float* __restrict__ out, int* __restrict__ edges, int m,
              int n_rows, int d, int items, int n_blocks) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);   // items W + 8 floats
  __shared__ int edge[4];                          // r0, s0, r1, s1
  __shared__ float agg_v[2][kWarps][W];
  __shared__ int agg_f[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // a warp takes diagonals e and e + n_warps together (the second a copy
  // of the first past n_blocks)
  const long long total = static_cast<long long>(n_rows) + m;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long e = static_cast<long long>(blockIdx.x) * kWarps + (tid >> 5);
       e <= n_blocks; e += 2 * n_warps) {
    const long long pair[2] = {e, e + n_warps <= n_blocks ? e + n_warps : e};
    long long k[2];
    int row[2], slot[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      k[n] = pair[n] * items < total ? pair[n] * items : total;
    }
    split(k, sidx, m, n_rows, lane, row, slot);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        edges[2 * pair[n]] = row[n];
        edges[2 * pair[n] + 1] = slot[n];
      }
    }
  }
  cooperative_groups::this_grid().sync();

  int parity = 0;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    if (tid < 4) edge[tid] = __ldcg(edges + 2 * static_cast<long long>(b) + tid);
    __syncthreads();
    block_sums<W, kMode>(sidx, vals, out, d, edge[0], edge[2], edge[1],
                         edge[3], buf, agg_v, agg_f, parity);
  }
}

template <int W, int kMode>
int launch(const int* sidx, const float* vals, float* out, int* edges, int m,
           int n_rows, int d, int items, int n_blocks, cudaStream_t stream) {
  const auto kernel = segsum_kernel<W, kMode>;
  const size_t smem = (static_cast<size_t>(items) * W + 8) * sizeof(float);
  // resident blocks an SM at this shared memory, found once a size and
  // device: no API call but the launch inside a graph capture
  static size_t known_smem = 0;
  static int known_device = -1, resident = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem != known_smem || device != known_device) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    known_smem = smem;
    known_device = device;
    resident = per_sm * sms;
  }
  unsigned grid = static_cast<unsigned>(n_blocks < resident ? n_blocks
                                                            : resident);
  if (grid == 0) grid = 1;
  void* args[] = {&sidx, &vals, &out, &edges, &m, &n_rows, &d, &items,
                  &n_blocks};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// sidx [m] ascending, vals [m, d], out [n_rows, d], all contiguous; every
// element of out is written. `items`: merge-path items (rows + slots) a
// block, at most 14,000 / min(d, 4) (shared memory); n_blocks =
// ceil((n_rows + m) / items); `edges`: scratch of 2 (n_blocks + 1) ints,
// left holding each diagonal's (rows, first slot).
int segsum_launch(const int* sidx, const float* vals, float* out, int* edges,
                  int m, int n_rows, int d, int items, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  if (m < 0 || items <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks =
      (static_cast<long long>(n_rows) + m + items - 1) / items;
  if (n_blocks >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int nb = static_cast<int>(n_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(sidx)
                         | reinterpret_cast<uintptr_t>(vals)
                         | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned) {
    switch (d) {
      case 1: return launch<1, kRow>(sidx, vals, out, edges, m, n_rows, d,
                                     items, nb, st);
      case 2: return launch<2, kRow>(sidx, vals, out, edges, m, n_rows, d,
                                     items, nb, st);
      case 3: return launch<3, kRow>(sidx, vals, out, edges, m, n_rows, d,
                                     items, nb, st);
      case 4: return launch<4, kRow>(sidx, vals, out, edges, m, n_rows, d,
                                     items, nb, st);
      default:
        if (d % 4 == 0) {
          return launch<kCols, kSlot4>(sidx, vals, out, edges, m, n_rows, d,
                                       items, nb, st);
        }
    }
  }
  return launch<kCols, kScalar>(sidx, vals, out, edges, m, n_rows, d, items,
                                nb, st);
}

const char* segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
