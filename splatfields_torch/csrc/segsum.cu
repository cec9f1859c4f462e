// Segment sum of sorted rows, for Hopper (sm_90a).
//
// Replaces splatfields_tpu/ops/segsum_pallas.py::sorted_segment_sum
// (kernel body _seg_kernel). Same contract: for ascending int32 ids
// sidx [M] and f32 rows vals [M, D],
//   out[r] = sum of vals[j] over j with sidx[j] == r,   out [n_rows, D],
// ids below 0 or at or above n_rows are dropped, rows that receive
// nothing are 0. It is the transpose of a row gather: the gradient of the
// NGP hash table, with the ids sorted by the caller.
//
// Design. The TPU kernel streams K-slot chunks of a 128-lane packed
// operand and sums each chunk with a one-hot [K, R] mask matmul on the
// MXU; the row ids ride as floats and the matmul needs HIGHEST precision.
// None of that is needed here: ids stay int32, and the sum is a loop.
// Block b owns the kRows output rows [b kRows, (b + 1) kRows), one thread
// per row. Because sidx is sorted, the block's slots form one contiguous
// range [bounds[b], bounds[b + 1]), found outside the kernel by one
// searchsorted over the block edges (as segsum_pallas.py does). Each
// thread finds the first slot of its row inside that range by binary
// search and publishes it in shared memory; its end is the next thread's
// start. Then the thread sums its rows' values in slot order and writes
// every column of its row, zeros included. No atomics: the order of every
// sum is fixed, so the result is deterministic, bit for bit.
//
// Bound. Each slot is read once (4 bytes of id, 4 D bytes of values) and
// each output row written once (4 D bytes); the adds are one per value.
// At the NGP shape (12.8M slots, D = 2, 2^24 rows) that is ~288 MB, so the
// kernel is bound by memory traffic. A thread with a hot row (the coarse
// dense levels take ~160 updates a row) sums serially; a faster version
// would split long rows over a warp and load the D columns at once.
//
// Build (as ops/cuda_build.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libsegsum.so segsum.cu

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;  // output rows per block, one thread each

__global__ void segsum_kernel(const int* __restrict__ sidx,
                              const float* __restrict__ vals,
                              const int* __restrict__ bounds,
                              float* __restrict__ out, int n_rows, int d) {
  __shared__ int first[kRows + 1];
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + tid;
  const int lo = bounds[blockIdx.x];
  const int hi = bounds[blockIdx.x + 1];

  // first slot in [lo, hi) whose id is >= row (hi for rows past n_rows)
  int a = lo, z = hi;
  while (a < z) {
    const int mid = a + ((z - a) >> 1);
    if (sidx[mid] < row) {
      a = mid + 1;
    } else {
      z = mid;
    }
  }
  first[tid] = a;
  if (tid == 0) first[kRows] = hi;
  __syncthreads();
  if (row >= n_rows) return;

  const int end = first[tid + 1];
  for (int k = 0; k < d; ++k) {
    float acc = 0.0f;
    for (int j = a; j < end; ++j) {
      acc += vals[static_cast<size_t>(j) * d + k];
    }
    out[static_cast<size_t>(row) * d + k] = acc;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `bounds` holds n_blocks + 1 slot offsets, n_blocks = ceil(n_rows / 256):
// bounds[b] = the first slot with id >= min(b * 256, n_rows).
int segsum_launch(const int* sidx, const float* vals, const int* bounds,
                  float* out, int n_rows, int d, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  segsum_kernel<<<n_blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      sidx, vals, bounds, out, n_rows, d);
  return static_cast<int>(cudaGetLastError());
}

const char* segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
