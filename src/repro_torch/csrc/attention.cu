// Attention forward (causal or full, grouped-query) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attention/attention.py:79
// (flash_attention_pallas, reached through repro/kernels/attention/ops.py:21
// flash_attention; its oracle is repro/kernels/attention/ref.py::attention_ref).
// For every batch b, query head h and query position i:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / group] * scale) v[b, j, h / group]
// over keys j <= i (causal) or all j, with the online softmax of flash
// attention: a running max m, a running sum l and an output accumulator,
// all f32.  The probabilities are rounded to v's dtype before the PV
// product (attention.py:61); the sum l keeps them unrounded; the output is
// acc / max(l, 1e-30), rounded to q's dtype.  Masked scores are -1e30, as
// in the reference (the bf16 kernel masks with -inf against a running max
// that starts at -1e30, the same thing), so a fully masked tile is an exact
// no-op.
//
// Layout: q (B, S, nq, D), k and v (B, S, nkv, D), out (B, S, nq, D), all
// contiguous; the kernel indexes kv head h / (nq / nkv) itself, so the
// wrapper neither repeats kv heads nor transposes nor pads.  Any S works:
// query rows and keys past S are masked here.  D is 32, 64 or 128
// (templated); f32 and bf16.
//
// What bounds it on this card: at the serving path's largest call
// (B 4, S 1024, nq 16, nkv 8, D 128, bf16, causal) the causal QK^T and PV
// products are ~17 GFLOP, 17 us at 989 TFLOP/s bf16; the bytes (q, k, v
// read once, out written once) are ~50 MB, 15 us at 3.35 TB/s.  Both
// bounds sit near 15-20 us, so a kernel at the bound must run the tensor
// cores and stream K/V at full rate.
//
// bf16 (the serving path): one block per (128-query tile, b, query head),
// numbered so that the longest causal tiles start first; the TPU's
// sequential kv grid axis becomes a loop over 128-key tiles that stops at
// the diagonal.  Two warpgroups of 64 query rows each (wgmma's M), no
// producer warp: a warp-specialised producer would cap every thread at 168
// registers (ptxas allocates for the launch, whatever setmaxnreg later
// moves), and the overlapped loop below needs ~218.
//  - Loads: one thread issues every TMA.  Q once; K and V tiles into a
//    three-stage ring, each stage with a K and a V "full" mbarrier (TMA
//    completes their transactions) and a K and a V "free" mbarrier that
//    all 256 threads arrive on once their products have read it; the
//    issuing thread refills a stage when both warpgroups have freed it.
//    The tensor maps read (B, S, heads, D) in place with a 64- or 128-byte
//    swizzle (boxes of 64 columns at most: a 128-wide row is two boxes);
//    rows past S arrive as zeros.
//  - S = Q K^T is wgmma m64n128k16 with Q's rows in registers (ldmatrix
//    from the swizzled tile, once) and K from shared memory (K-major).  The
//    online softmax runs on the accumulator's registers, in place; P,
//    rounded to bf16, becomes the register A operand of O += P V, wgmma
//    m64nDk16 with V read from shared memory as an MN-major B.
//  - Overlap: tile t's scores are issued with tile t - 1's P V product, and
//    tile t's softmax runs while that product does; the other warpgroup's
//    products fill the tensor cores around both.
//  - Output: acc / max(l, 1e-30) in bf16 goes through the warpgroup's own
//    Q rows in shared memory to a TMA store (rows past S are not written).
// Softmax in base 2: the scores are scaled by scale * log2(e) inside the
// exponent's FMA and exponentiated with ex2, the same function to within
// f32 rounding.  A rescale by alpha == 1 (a row max that did not grow) is
// skipped, which changes no bit.
// f32 keeps scalar FMAs (TF32 would miss the reference's 2e-5): 256
// threads per (b, h, 64-query tile), a 4 x 2 score micro-tile each, then
// four threads per query row for the softmax and PV.
//
// Host side: each instantiation sets its shared-memory limit once per
// device; the four tensor maps are encoded per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // f32 kernel
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per tile of the f32 kernel
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int kQK = D + 4;   // row stride (floats) of the Q and K tiles
  static constexpr int kP = kBK + 1;  // row stride of the score/probability tile
  static constexpr int kFloats = kBQ * kQK + kBK * kQK + kBK * D + kBQ * kP;
  static constexpr int kBytes = kFloats * 4;
};

// f32: scalar FMAs
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int nq, int nkv, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  using L = Smem<D>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // [kBQ][kQK]
  float* sK = sQ + kBQ * L::kQK;   // [kBK][kQK]
  float* sV = sK + kBK * L::kQK;   // [kBK][D]
  float* sP = sV + kBK * D;        // [kBQ][kP]

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / nq;
  const int h = bh - b * nq;
  const int hk = h / (nq / nkv);
  const int q0 = qt * kBQ;
  const long long q_row = static_cast<long long>(nq) * D;  // elements per token
  const long long kv_row = static_cast<long long>(nkv) * D;
  const float* qb = q + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * D;
  const float* kb = k + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * D;
  const float* vb = v + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * D;
  float* ob = o + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int s = q0 + r;
    sQ[r * L::kQK + c] = s < S ? qb[s * q_row + c] : 0.0f;
  }

  // score phase: a 16 x 16 thread grid, rows ty*4 + i, columns tx + 16*j
  const int ty = tid >> 4, tx = tid & 15;
  // softmax and PV phase: four threads (pi) per query row rr, one warp
  // holds eight whole rows; thread pi owns columns pi*4 + 16*j4 + {0..3}
  const int rr = tid >> 2, pi = tid & 3;
  constexpr int kCols = kBK / 4;  // softmax columns per thread
  float m = kNegInf, l = 0.0f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.0f;

  const int k_end = kCausal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q is staged; the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int s = k0 + r;
      const bool in = s < S;
      sK[r * L::kQK + c] = in ? kb[s * kv_row + c] : 0.0f;
      sV[r * D + c] = in ? vb[s * kv_row + c] : 0.0f;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * L::kQK + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * L::kQK + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int kj = k0 + c;
        float s = sc[i][j] * scale;
        if (kj >= S || (kCausal && kj > q0 + r)) s = kNegInf;
        sP[r * L::kP + c] = s;
      }
    __syncthreads();

    // online softmax of row rr over this tile
    float sv[kCols];
    float mc = kNegInf;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      sv[c] = sP[rr * L::kP + pi * kCols + c];
      mc = fmaxf(mc, sv[c]);
    }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m, mc);
    float ps = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float p = expf(sv[c] - m_new);
      ps += p;
      sP[rr * L::kP + pi * kCols + c] = p;  // already in v's dtype, f32
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + ps;
    m = m_new;
    __syncwarp();  // the row's four threads, one warp, wrote its probabilities

#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = sP[rr * L::kP + c];
#pragma unroll
      for (int j4 = 0; j4 < D / 16; ++j4) {
        const float4 vv = *reinterpret_cast<const float4*>(&sV[c * D + j4 * 16 + pi * 4]);
        acc[j4 * 4 + 0] = fmaf(p, vv.x, acc[j4 * 4 + 0]);
        acc[j4 * 4 + 1] = fmaf(p, vv.y, acc[j4 * 4 + 1]);
        acc[j4 * 4 + 2] = fmaf(p, vv.z, acc[j4 * 4 + 2]);
        acc[j4 * 4 + 3] = fmaf(p, vv.w, acc[j4 * 4 + 3]);
      }
    }
  }

  const int s = q0 + rr;
  if (s < S) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = ob + s * q_row;
#pragma unroll
    for (int j4 = 0; j4 < D / 16; ++j4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[j4 * 16 + pi * 4 + e] = acc[j4 * 4 + e] / den;
  }
}


// Sets a kernel's dynamic shared-memory limit on the current device the
// first time that device launches it.
template <typename Kernel>
int set_smem_limit_once(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed, wgmma for both products
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWgThreads = 128;
constexpr int kTcThreads = 2 * kWgThreads;  // two warpgroups, 64 query rows each
constexpr int kTcBQ = 128;                  // query rows per block
constexpr int kTcBK = 128;                  // keys per K/V tile
constexpr int kSmemLimit = 232448;          // bytes of shared memory a block may use
constexpr int kMaxStages = 3;

template <int D>
struct TcLayout {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes of a shared row
  static constexpr int kCols = kSwizzle / 2;                   // bf16 columns of a TMA box
  static constexpr int kChunks = D / kCols;                    // boxes across D
  static constexpr int kQBytes = kTcBQ * D * 2;
  static constexpr int kTileBytes = kTcBK * D * 2;  // one K or V tile
  // K/V tiles in flight: as many as fit beside Q, at most kMaxStages
  static constexpr int kFit = (kSmemLimit - 1024 - 256 - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // Q, then per stage K and V; each chunk of kCols columns is a block of
  // rows x kSwizzle bytes.  +1,024 to align the base for the swizzle.
  static constexpr int kSmemBytes = kQBytes + kStages * 2 * kTileBytes + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A B, A (64 x 16) in registers, B (16 x N) in shared memory,
// K-major (kTransB 0: K rows for Q K^T) or MN-major (1: V for P V)
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) hopper::wgmma_rs_n32<kTransB>(d, a, db, scale_d);
  else if constexpr (N == 64) hopper::wgmma_rs_n64<kTransB>(d, a, db, scale_d);
  else hopper::wgmma_rs_n128<kTransB>(d, a, db, scale_d);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads, 1)
attention_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          int S, int nq, int nkv, float scale_log2) {
  using namespace hopper;
  using L = TcLayout<D>;
  constexpr int SW = L::kSwizzle;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  // q; per stage: K full, V full, K free, V free
  __shared__ __align__(8) uint64_t bars[1 + 4 * kMaxStages];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto sK = [&](int s) { return sQ + L::kQBytes + s * 2 * L::kTileBytes; };
  auto sV = [&](int s) { return sK(s) + L::kTileBytes; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_k = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_v = [&](int s) { return smem_u32(&bars[1 + kStages + s]); };
  auto bar_kfree = [&](int s) { return smem_u32(&bars[1 + 2 * kStages + s]); };
  auto bar_vfree = [&](int s) { return smem_u32(&bars[1 + 3 * kStages + s]); };

  // one block per (query tile, b, h); blocks start in order of their index,
  // so the longest causal tiles (the last query tiles) come first
  const int n_qt = (S + kTcBQ - 1) / kTcBQ;
  const int bh = blockIdx.x % (gridDim.x / n_qt);
  const int qt = n_qt - 1 - blockIdx.x / (gridDim.x / n_qt);
  const int b = bh / nq;
  const int h = bh - b * nq;
  const int hk = h / (nq / nkv);
  const int q0 = qt * kTcBQ;
  const int k_end = kCausal ? min(S, q0 + kTcBQ) : S;
  const int n_tiles = (k_end + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const bool issuer = threadIdx.x == 0;  // the one thread that issues TMA

  // K and V of tile t into stage t % kStages, once the stage is free
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_arrive_expect_tx(bar_k(s), L::kTileBytes);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sK(s) + c * kTcBK * SW, &tk, bar_k(s), c * L::kCols, hk, t * kTcBK, b);
    mbar_arrive_expect_tx(bar_v(s), L::kTileBytes);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sV(s) + c * kTcBK * SW, &tv, bar_v(s), c * L::kCols, hk, t * kTcBK, b);
  };

  if (issuer) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_kfree(s), kTcThreads);
      mbar_init(bar_vfree(s), kTcThreads);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, L::kQBytes);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sQ + c * kTcBQ * SW, &tq, bar_q, c * L::kCols, h, q0, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  }
  __syncthreads();

  // warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63
  const int warp = tid >> 5, lane = tid & 31;
  const int r_first = q0 + wg * 64;
  const int row = r_first + warp * 16 + (lane >> 2);  // this lane's rows: row, row + 8
  const int col = 2 * (lane & 3);                     // and columns 8 j + col + {0, 1}
  const uint32_t sQw = sQ + wg * 64 * SW;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max, in units of scale * log2(e)
  float l[2] = {0.0f, 0.0f};        // this lane's share of the row sums
  float alpha[2];                   // the factor the output rows are rescaled by
  float sc[kTcBK / 2];              // scores of one tile, unscaled, then P in f32
  uint32_t pa[kTcBK / 16][4];       // P of one tile as A operands, in v's dtype
  uint32_t qa[D / 16][4];           // this warpgroup's Q rows as A operands

  // S = Q K^T of tile t into sc, over D in steps of 16 (issued, not waited)
  auto issue_qk = [&](int t) {
    const int s = t % kStages;
    mbar_wait(bar_k(s), (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / L::kCols;
      const uint32_t off = (kk * 16 % L::kCols) * 2;
      wgmma_rs<kTcBK, 0>(sc, qa[kk], make_desc<SW>(sK(s) + c * kTcBK * SW + off, 16, 8 * SW),
                         kk);
    }
    wgmma_commit();
  };
  // O += P V of tile t over its keys in steps of 16 (issued, not waited)
  auto issue_pv = [&](int t) {
    const int s = t % kStages;
    mbar_wait(bar_v(s), (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk], make_desc<SW>(sV(s) + kk * 16 * SW, kTcBK * SW, 8 * SW), 1);
    wgmma_commit();
  };
  // online softmax of tile t's scores for rows row and row + 8 (a row's
  // four lanes are adjacent), in place: sc becomes P in f32; updates m, l
  // and alpha
  auto softmax = [&](int t) {
    const int k0 = t * kTcBK;
    if (k0 + kTcBK > S || (kCausal && k0 + kTcBK - 1 > r_first)) {
#pragma unroll
      for (int i = 0; i < kTcBK / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + col + (i & 1);
        if (key >= S || (kCausal && key > row + 8 * ((i >> 1) & 1))) sc[i] = -INFINITY;
      }
    }
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kTcBK / 2; ++i) mc[(i >> 1) & 1] = fmaxf(mc[(i >> 1) & 1], sc[i]);
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_new = fmaxf(m[r], mc[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kTcBK / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
  };
  // P (f32, in sc) rounded to v's dtype into the A operands
  auto pack_p = [&] {
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j) {
      pa[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };
  // the issuer refills the stage of tile t once both warpgroups freed it
  auto refill = [&](int t) {
    if (issuer && t + kStages < n_tiles) {
      const int s = t % kStages;
      mbar_wait(bar_kfree(s), (t / kStages) & 1);
      mbar_wait(bar_vfree(s), (t / kStages) & 1);
      load_kv(t + kStages);
    }
  };

  // Q's rows as A operands, once: warp w holds rows 16 w .. 16 w + 15; an
  // ldmatrix lane addresses row l % 8 of matrix l / 8 (8 rows on for odd
  // matrices, 8 columns on for the last two)
  mbar_wait(bar_q, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int mi = lane >> 3;
    const int qrow = warp * 16 + (mi & 1) * 8 + (lane & 7);
    const int qcol = kk * 16 + (mi >> 1) * 8;
    ldmatrix_x4(qa[kk], sQw + (qcol / L::kCols) * kTcBQ * SW +
                            swizzle<SW>(qrow * SW + (qcol % L::kCols) * 2));
  }

  // Tile t's scores and softmax overlap tile t - 1's P V product.  The A
  // operands and the output rows are rewritten only while no product is in
  // flight; the register fences keep the compiler from reading sc or acc
  // before the wait that completes the product writing them, or sinking
  // their writes past the fence of the next products.
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(bar_kfree(0));
  softmax(0);  // acc is 0: no rescale
  pack_p();
  fence_regs(pa);
  for (int t = 1; t < n_tiles; ++t) {
    issue_qk(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S of tile t is done; P V of tile t - 1 may still run
    fence_regs(sc);
    mbar_arrive(bar_kfree(t % kStages));
    softmax(t);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_vfree((t - 1) % kStages));
    refill(t - 1);
    // alpha is exactly 1 where a row's max did not grow: skip the no-op
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    pack_p();
    fence_regs(acc);
    fence_regs(pa);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  // The output rows: acc / max(l, 1e-30) in bf16, written into this
  // warpgroup's own Q rows (read only into qa) in the output map's swizzled
  // layout, then stored by one TMA per column chunk; rows past S are
  // outside the map and not written.
  const int lr = warp * 16 + (lane >> 2);  // this lane's first row of the 64
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = __frcp_rn(fmaxf(sum, 1e-30f));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col;
      const uint32_t at = sQw + (c / L::kCols) * kTcBQ * SW +
                          swizzle<SW>((lr + 8 * r) * SW + (c % L::kCols) * 2);
      const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at), "r"(v) : "memory");
    }
  }
  fence_proxy_async();
  if (wg == 0) named_barrier_sync<1, kWgThreads>();
  else named_barrier_sync<2, kWgThreads>();
  if (tid == 0) {
    for (int c = 0; c < L::kChunks; ++c)
      tma_store_4d(&to, sQw + c * kTcBQ * SW, c * L::kCols, h, r_first, b);
    bulk_commit();
    bulk_wait_read();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A map over a contiguous (B, S, heads, D) bf16 tensor, read in boxes of
// (rows tokens, one head, kCols columns); rows past S read as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads, int rows) {
  using L = TcLayout<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {D * 2, row_bytes, row_bytes * S};  // bytes, dims 1..3
  const cuuint32_t box[4] = {L::kCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kCausal>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S,
              int nq, int nkv, float scale, cudaStream_t stream) {
  using L = TcLayout<D>;
  auto kernel = attention_fwd_bf16_kernel<D, kCausal>;
  static std::atomic<uint64_t> limit_set{0};
  const int err = set_smem_limit_once(kernel, L::kSmemBytes, limit_set);
  if (err != 0) return err;
  CUtensorMap tq, tk, tv, to;
  if (!make_map<D>(&tq, q, B, S, nq, kTcBQ) || !make_map<D>(&tk, k, B, S, nkv, kTcBK) ||
      !make_map<D>(&tv, v, B, S, nkv, kTcBK) || !make_map<D>(&to, o, B, S, nq, kTcBQ / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>((S + kTcBQ - 1) / kTcBQ) * B * nq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, L::kSmemBytes, stream>>>(
      tq, tk, tv, to, S, nq, nkv, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int nq, int nkv, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_tc<D, kCausal>(q, k, v, o, B, S, nq, nkv, scale, stream);
  } else {
    auto kernel = attention_fwd_f32_kernel<D, kCausal>;
    static std::atomic<uint64_t> limit_set{0};
    const int err = set_smem_limit_once(kernel, Smem<D>::kBytes, limit_set);
    if (err != 0) return err;
    const dim3 grid((S + kBQ - 1) / kBQ, B * nq);
    kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, nq, nkv, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch_causal(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int nq, int nkv, int causal, float scale, cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, o, B, S, nq, nkv, scale, stream)
                : launch<T, D, false>(q, k, v, o, B, S, nq, nkv, scale, stream);
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B, int S,
               int nq, int nkv, int D, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_causal<T, 32>(q, k, v, o, B, S, nq, nkv, causal, scale, stream);
    case 64: return launch_causal<T, 64>(q, k, v, o, B, S, nq, nkv, causal, scale, stream);
    case 128: return launch_causal<T, 128>(q, k, v, o, B, S, nq, nkv, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v,
                                    void* o, int B, int S, int nq, int nkv, int D,
                                    int dtype, int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || nq <= 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || static_cast<long long>(B) * nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float>(q, k, v, o, B, S, nq, nkv, D, causal, scale, st);
    case 1: return launch_dim<bf16>(q, k, v, o, B, S, nq, nkv, D, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
