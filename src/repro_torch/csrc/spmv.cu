// ELL sparse matrix-vector product for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spmv/spmv.py:36 (spmv_ell_pallas;
// its oracles are repro/kernels/spmv/ref.py::spmv_ell_ref and
// spmv_coo_ref).  For every row r of a padded (rows, D) ELL layout,
// y[r] = sum over d of w[r, d] * x[idx[r, d]], where idx == -1 is a padding
// slot that gathers 0.
//
// What bounds it on this card: bytes.  Each ELL slot reads idx and w once
// (8 B), x is read once (4 B per vertex) and y written once (4 B per row),
// over 3.35 TB/s.  On the paper graph lj the layout is 75,008 x 31 (largest
// in-degree 31, mean 11.9), about 18.6 MB of idx + w: ~6 us.  x (300 KB)
// stays in the 50 MB L2, so the gathers x[idx] are L2 traffic.
//
// Design: one block of 128 threads per tile of 128 rows, one row a thread.
//  - Loads (rows of at most 32 columns, as on lj).  The row-major layout
//    puts a tile's rows next to each other: the tile is one contiguous,
//    16-byte-aligned run of 128 * D words per array, which the block reads
//    with coalesced 16-byte loads (all of a thread's issued before it stores
//    any) and stages in dynamic shared memory.  There a row has an odd
//    stride (D, or D + 1 when D is even), so the threads' reads of their
//    own rows hit distinct banks.
//  - Gathers.  Each thread issues all of its row's gathers x[idx] before it
//    sums any of them (a 32-wide register array, unrolled, each slot
//    predicated on D), so up to 32 L2 reads per thread are in flight.
//  - Wider rows (the general path, 33 columns or more, as on tw, pk, r21):
//    the tile goes in chunks of 32 columns.  For each chunk, warp w takes
//    the tile's rows 32w..32w+31 one after another, a lane a column, so a
//    row's 32 words of idx and of w are one coalesced 128-byte read; the
//    lane also gathers x[idx] and writes the product w * x[idx] to shared
//    memory (eight rows of loads and gathers in flight before any product
//    is stored).  Then each thread adds its row's 32 products in column
//    order.  Where a product is rounded does not change the sum's order.
//  - Order.  Each row is summed in column order d = 0..D-1 with
//    __fmul_rn / __fadd_rn, so no contraction into an FMA changes a
//    rounding.  The plain version (kernels/spmv/spmv.py::spmv_ell_plain)
//    sums in the same order with the same roundings, so the two are equal
//    bit for bit.  The reference's jnp.sum adds each row in tree order, so
//    against the reference the result is allclose, not equal.
// idx and w must start on a 16-byte boundary (the wrapper checks).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 128;   // rows per block, one per thread
constexpr int kTileCols = 32;  // rows up to this wide are staged as a whole tile
constexpr int kVecs = kTileCols / 4;  // 16-byte loads of a thread per array and tile
constexpr int kAhead = 8;    // rows of a wide chunk a lane loads ahead

// The tile's nr rows of idx and of w's bits (D <= kTileCols words a row)
// into si / sw[row * stride + col].  The tile is one contiguous run of
// nr * D words per array, and r0 * D is a multiple of 128, so the runs
// start 16-byte aligned; every thread issues all its loads before it
// stores any.
__device__ __forceinline__ void stage_tile(int* si, int* sw, const int* __restrict__ idx,
                                           const int* __restrict__ w, long long r0, int nr,
                                           int D, int stride) {
  const int4* ri = reinterpret_cast<const int4*>(idx + r0 * D);
  const int4* rw = reinterpret_cast<const int4*>(w + r0 * D);
  const int words = nr * D;
  const int vecs = words / 4;
  int4 vi[kVecs], vw[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = threadIdx.x + u * kRows;
    if (i < vecs) {
      vi[u] = ri[i];
      vw[u] = rw[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = threadIdx.x + u * kRows;
    if (i < vecs) {
      const int a[4] = {vi[u].x, vi[u].y, vi[u].z, vi[u].w};
      const int b[4] = {vw[u].x, vw[u].y, vw[u].z, vw[u].w};
      int row = (4 * i) / D, col = 4 * i - row * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        si[row * stride + col] = a[e];
        sw[row * stride + col] = b[e];
        if (++col == D) {
          col = 0;
          ++row;
        }
      }
    }
  }
  for (int i = 4 * vecs + threadIdx.x; i < words; i += kRows) {
    const int row = i / D;
    si[row * stride + (i - row * D)] = idx[r0 * D + i];
    sw[row * stride + (i - row * D)] = w[r0 * D + i];
  }
}

__global__ void __launch_bounds__(kRows)
spmv_ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const float* __restrict__ x, float* __restrict__ y,
                long long rows, int D) {
  // a staged tile (rows of at most kTileCols): idx, then w's bits, each
  // kRows rows of (D | 1) words; for wider rows, a chunk's products,
  // kRows rows of kTileCols + 1 words
  extern __shared__ int smem[];
  const int me = threadIdx.x;
  const int stride = D | 1;  // odd: a thread's row lands on its own banks
  int* s_idx = smem;
  int* s_w = smem + kRows * stride;
  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * kRows;
    const int nr = static_cast<int>(rows - r0 < kRows ? rows - r0 : kRows);
    float acc = 0.0f;
    if (D <= kTileCols) {
      __syncthreads();  // the last tile's readers are done
      stage_tile(s_idx, s_w, idx, reinterpret_cast<const int*>(w), r0, nr, D, stride);
      __syncthreads();
      if (me < nr) {
        float g[kTileCols];
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) {
          const int col = c < D ? s_idx[me * stride + c] : -1;
          g[c] = col >= 0 ? x[col] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kTileCols; ++c)
          if (c < D) acc = __fadd_rn(acc, __fmul_rn(__int_as_float(s_w[me * stride + c]), g[c]));
      }
    } else {
      // wide rows: chunks of kTileCols columns, products staged by warps
      float* s_p = reinterpret_cast<float*>(smem);
      const int lane = me % 32, warp = me / 32;
      for (int c0 = 0; c0 < D; c0 += kTileCols) {
        const int c = c0 + lane;
        __syncthreads();  // the last chunk's sums are done
        for (int rb = warp * 32; rb < warp * 32 + 32; rb += kAhead) {
          int col[kAhead];
          float wv[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            const bool live = rb + u < nr && c < D;
            const long long at = (r0 + rb + u) * D + c;
            col[u] = live ? idx[at] : -1;
            wv[u] = live ? w[at] : 0.0f;
          }
          float g[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) g[u] = col[u] >= 0 ? x[col[u]] : 0.0f;
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
            s_p[(rb + u) * (kTileCols + 1) + lane] = __fmul_rn(wv[u], g[u]);
        }
        __syncthreads();
        if (me < nr) {
          const int n = D - c0 < kTileCols ? D - c0 : kTileCols;
          for (int u = 0; u < n; ++u) acc = __fadd_rn(acc, s_p[me * (kTileCols + 1) + u]);
        }
      }
    }
    if (me < nr) y[r0 + me] = acc;
  }
}

}  // namespace

// ``max_blocks``: the grid's cap (8 blocks for each SM of the device, from
// the wrapper); tiles past it loop in the block.
extern "C" int spmv_ell_launch(const void* idx, const void* w, const void* x,
                               void* y, long long rows, int D, int max_blocks,
                               void* stream) {
  if (rows <= 0) return 0;
  if (D <= 0 || max_blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (rows + kRows - 1) / kRows;
  const int blocks = static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
  const size_t smem = sizeof(int) * kRows * (D <= kTileCols ? 2 * (D | 1) : kTileCols + 1);
  spmv_ell_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(x), static_cast<float*>(y), rows, D);
  return static_cast<int>(cudaGetLastError());
}
