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
// stays in the 50 MB L2, so the gathers x[idx] are L2 traffic.  With that
// little padding there is no need for a CSR or hybrid layout yet.
//
// Design, simple and right first: one thread per row walks d = 0..D-1 in
// order with __fmul_rn / __fadd_rn, so no contraction into an FMA changes
// a rounding.  The plain version (kernels/spmv/spmv.py::spmv_ell_plain)
// sums in the same column order with the same roundings, so the two are
// equal bit for bit.  The reference's jnp.sum adds each row in tree order,
// so against the reference the result is allclose, not equal.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride: 16 blocks per SM

__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const float* __restrict__ x, float* __restrict__ y,
                long long rows, int D) {
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       r < rows; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int* ir = idx + r * D;
    const float* wr = w + r * D;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const int c = ir[d];
      const float g = c >= 0 ? x[c] : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(wr[d], g));
    }
    y[r] = acc;
  }
}

}  // namespace

extern "C" int spmv_ell_launch(const void* idx, const void* w, const void* x,
                               void* y, long long rows, int D, void* stream) {
  if (rows <= 0) return 0;
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long b = (rows + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
  spmv_ell_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(x), static_cast<float*>(y), rows, D);
  return static_cast<int>(cudaGetLastError());
}
