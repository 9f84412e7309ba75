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
// in the reference, so a fully masked tile is an exact no-op.
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
// The design is a simple, correct first version, not that kernel.  One
// thread block owns one (b, h, 64-query tile).  The TPU's sequential kv grid
// axis becomes a loop inside the block over key tiles, which stops at the
// diagonal for a causal tile.  Q is staged once and each K/V tile in turn in
// shared memory.
//  - bf16 (the serving path): four warps, sixteen query rows each, 64-key
//    tiles.  QK^T and PV run on the tensor cores as mma.sync m16n8k16 (bf16
//    in, f32 accumulation) with ldmatrix loads.  Q's fragments, the scores,
//    m, l and the output accumulator stay in registers; the scores' f32
//    accumulator layout is that of an A fragment, so P is rounded to bf16
//    and fed to the PV product without touching shared memory.
//  - f32: scalar FMAs, since TF32 would miss the reference's 2e-5.  256
//    threads: a 4 x 2 score micro-tile each, then four threads per query row
//    for the softmax and PV, each holding D/4 accumulators in registers.
// Neither pipelines its global loads (no cp.async or TMA: each tile is
// loaded, then computed, behind a barrier), and mma.sync reaches only part
// of what wgmma could; those are the next steps toward the bound.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// bf16: the same algorithm on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // four warps, sixteen query rows each
constexpr int kTcBK = 64;        // keys per tile

// Row stride (bf16) of the staged Q, K and V tiles: 8 bf16 of padding put
// the eight 16-byte rows an ldmatrix reads in distinct banks.
template <int D>
constexpr int kLd = D + 8;

template <int D>
constexpr int kTcSmemBytes = (kBQ + 2 * kTcBK) * kLd<D> * 2;

// Copies rows [r0, r0 + rows) of one head (row stride `stride` elements)
// into a padded shared tile, 16 bytes at a time; rows at or past S are 0.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride,
                                           int r0, int rows, int S, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < rows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + s * stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd<D> + c) = val;
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Without .trans lane t receives row t / 4,
// columns 2 (t % 4) and 2 (t % 4) + 1 of each; with .trans the transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row-major) * b (16x8, column-major); f32 accumulation.
// Lane t = 4 g + i holds a = {(g, 2i..2i+1), (g+8, 2i..), (g, 2i+8..),
// (g+8, 2i+8..)}, b = {(k 2i..2i+1, n g), (k 2i+8.., n g)} and
// d = {(g, 2i), (g, 2i+1), (g+8, 2i), (g+8, 2i+1)}.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int S, int nq, int nkv, float scale) {
  constexpr int LD = kLd<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* sK = sQ + kBQ * LD;                      // [kTcBK][LD]
  bf16* sV = sK + kTcBK * LD;                    // [kTcBK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / nq;
  const int h = bh - b * nq;
  const int hk = h / (nq / nkv);
  const int q0 = qt * kBQ;
  const long long q_row = static_cast<long long>(nq) * D;
  const long long kv_row = static_cast<long long>(nkv) * D;
  const bf16* qb = q + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * D;
  const bf16* kb = k + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * D;
  const bf16* vb = v + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * D;
  bf16* ob = o + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * D;

  // fragment roles: g = lane / 4 picks the rows (g, g + 8) of this warp's
  // sixteen, i = lane % 4 the column pair; an ldmatrix lane addresses row
  // lane % 8 of matrix lane / 8
  const int g = lane >> 2, i2 = (lane & 3) * 2;
  const int lr = lane & 7, lm = lane >> 3;

  stage_rows<D>(sQ, qb, q_row, q0, kBQ, S, tid);
  __syncthreads();
  uint32_t qa[D / 16][4];  // this warp's Q as A fragments, for every tile
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], sQ + (warp * 16 + (lm & 1) * 8 + lr) * LD + kk * 16 + (lm >> 1) * 8);

  float acc[D / 8][4];  // output accumulator: rows g, g + 8; columns 8n + i2 + {0, 1}
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
  const int qrow = q0 + warp * 16 + g;

  const int k_end = kCausal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTcBK) {
    __syncthreads();  // every warp is done with the last K/V tile
    stage_rows<D>(sK, kb, kv_row, k0, kTcBK, S, tid);
    stage_rows<D>(sV, vb, kv_row, k0, kTcBK, S, tid);
    __syncthreads();

    // scores S = Q K^T: eight n-tiles of eight keys
    float sc[kTcBK / 8][4];
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kTcBK / 8; j += 2) {
        uint32_t kf[4];  // B fragments of key tiles j and j + 1
        ldmatrix_x4(kf, sK + ((j + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
        mma_16816(sc[j], qa[kk], kf[0], kf[1]);
        mma_16816(sc[j + 1], qa[kk], kf[2], kf[3]);
      }

    // online softmax of rows g and g + 8 (a row's four lanes are adjacent)
    float mc[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + j * 8 + i2 + (e & 1);
        float x = sc[j][e] * scale;
        if (key >= S || (kCausal && key > qrow + 8 * r)) x = kNegInf;
        sc[j][e] = x;
        mc[r] = fmaxf(mc[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float m_new = fmaxf(m[r], mc[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t pa[kTcBK / 16][4];  // P as A fragments, rounded to v's dtype
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j) {
      const float p0 = expf(sc[j][0] - m[0]), p1 = expf(sc[j][1] - m[0]);
      const float p2 = expf(sc[j][2] - m[1]), p3 = expf(sc[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: V's B fragments through the transposing ldmatrix
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vf[4];  // B fragments of column tiles n and n + 1
        ldmatrix_x4_trans(vf, sV + (kk * 16 + (lm & 1) * 8 + lr) * LD + (n + (lm >> 1)) * 8);
        mma_16816(acc[n], pa[kk], vf[0], vf[1]);
        mma_16816(acc[n + 1], pa[kk], vf[2], vf[3]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = qrow + 8 * r;
    if (row < S) {
      const float den = fmaxf(sum, 1e-30f);
      bf16* orow = ob + row * q_row + i2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

template <int D, bool kCausal>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S,
              int nq, int nkv, float scale, cudaStream_t stream) {
  auto kernel = attention_fwd_bf16_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * nq);
  kernel<<<grid, kTcThreads, kTcSmemBytes<D>, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, nq, nkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int nq, int nkv, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_tc<D, kCausal>(q, k, v, o, B, S, nq, nkv, scale, stream);
  } else {
    auto kernel = attention_fwd_f32_kernel<D, kCausal>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
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
