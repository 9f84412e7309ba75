// Edge-centric min-propagation (scatter-min) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/edge_update/edge_update.py:53
// (edge_update_pallas; its oracle is repro/kernels/edge_update/ref.py).
// For every edge e with src[e] >= 0 whose source value sv = values[src[e]]
// is not the sentinel, out[dst[e]] = min(out[dst[e]], sv + delta[e]);
// out starts at the sentinel (+inf for f32, INT_MAX for int32), so a
// vertex without a live in-edge keeps it.  dst is taken as the reference
// takes it: a negative dst is vertex 0, and an edge with dst >= n is
// dropped.
//
// What bounds it on this card: bytes.  Each edge reads src, dst and delta
// once (12 B) and each vertex is read once from values and written once to
// out (8 B), over 3.35 TB/s: 6.6 us for the semantic engine's largest call
// (1,784,584 edges, 75,000 vertices).  The values vector and the output
// stay in the 50 MB L2, so the gathers of values[src] and the atomics on
// out[dst] are L2 traffic.  The first design (one atomic per live edge, a
// grid-stride loop, a separate fill launch) took ~120 us at that call,
// nearly all of it in the edge pass: HitGraph sorts its edges by destination within
// each routed block, so the lanes of a warp mostly hit one to three
// addresses, and the L2 applies same-address atomics one after another.
//
// Design, lever by lever.  The choices were made on the card by timing
// each variant (replayed CUDA graphs, torch.profiler) at the largest call
// and at ForeGraph's median call of 10,209 edges (PERF.md, PR 16);
// chip_smoke.py and kernel_ab.py time the kept design against the first.
// - Warp-aggregated atomics (kept: the edge pass at the largest call went
//   from ~114 us to ~10 us).  A round is 32 * P consecutive edges of a
//   warp, lane l on edges P l .. P l + P - 1.  A lane's candidate is a key:
//   for f32 the order-preserving uint32 view (b ^ (sign ? 0xFFFFFFFF :
//   0x80000000), -0.0 below +0.0), for int32 the value.  An edge with no
//   candidate (src < 0, a sentinel source) holds the key of no candidate
//   (above every real key) and keeps its dst, so a masked edge inside a run
//   of one destination does not break the run; past the end, dst is -1.
//   Each run of equal consecutive dst in a round gets one atomic of its
//   min: a run inside a lane's P edges from that lane; a run that may go on
//   into the next lanes through a segmented min over the lanes' first runs
//   (five shuffle-down steps, lane l taking lane l + o's min when their dst
//   are equal), applied by the lane where the run starts.  Lanes of equal
//   dst that are not adjacent may merge too: every key merged into a lane
//   is a candidate for that lane's dst and min is idempotent, so nothing
//   changes.  A run none of whose edges has a candidate applies nothing, so
//   a masked edge's dst is never used as an address.  A round without a
//   candidate, or in which no lane's first dst equals the next lane's
//   (ThunderGP's and ForeGraph's edges), skips the shuffles (rounds past
//   the end that still ran them made small calls slower).
//   __match_any_sync with __reduce_min_sync was not tried: lanes in
//   different groups would call the reduction with different masks at once.
// - The leader's atomic: int32 atomicMin; f32 through the integer view, a
//   value with the sign bit clear by atomicMin on its int bits, one with it
//   set by atomicMax on its unsigned bits (any negative float is below any
//   non-negative one in both views).  Inputs are taken to hold no NaN.
// - Wider loads (kept for large calls).  P = 4: a lane loads its four edges
//   with one 16-byte load an array where the three arrays are 16-byte
//   aligned (the kernel checks the pointers; else one load an edge), and a
//   round takes a quarter of the shuffles of P = 1.  It was faster than
//   P = 1 at the largest call and slower at the median call, where P = 1
//   spreads the edges over four times the warps; so the wrapper takes
//   P = 4 only when the card cannot give every 32 edges a warp of their own.
// - The grid from the card (kept).  The wrapper passes the blocks: up to
//   the SM count (from the wrapper) times the 6 blocks an SM holds, enough
//   for a warp per round; each warp takes one chunk of consecutive rounds
//   (kernels/edge_update/edge_update.py::launch_plan), chunk c to warp
//   c / gridDim.x of block c % gridDim.x, so that few chunks spread over
//   the SMs.
// - The fill stays its own kernel (one float4 store a thread), launched
//   from the same host call.  Folding it into one cooperative launch (fill,
//   grid barrier, edges) cost more on the card than the second launch: the
//   fill and the barrier alone took longer than the fill kernel and the
//   launch gap together, at both sizes.  Instead the edge kernel is a
//   programmatic dependent launch: the fill lets it start at once, and each
//   thread loads and gathers its first round before it waits for the
//   fill's grid (griddepcontrol), so its launch and first loads overlap the
//   fill.  Loading the first round ahead of a cooperative grid barrier
//   (plainly, or by cp.async into shared memory) was slower and dropped.
// - sv + delta uses __fadd_rn; int32 adds wrap, as XLA's do.
// Min is order-independent, so the result equals the plain version and the
// reference bit for bit, whatever order the atomics land in.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 6;  // the launch bounds (edge_update.py BLOCKS_PER_SM)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Keys;

template <>
struct Keys<float> {
  using K = unsigned;
  static constexpr K kNone = 0xffffffffu;  // no candidate: above every key
  static constexpr K kTop = 0xff800000u;   // the key of +inf, the sentinel
  __device__ static float top() { return __int_as_float(0x7f800000); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float from_bits(int b) { return __int_as_float(b); }
  __device__ static K key(float v) {
    const unsigned b = __float_as_uint(v);
    return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
  }
  __device__ static void apply(float* at, K k) {
    const unsigned b = k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu);
    if (static_cast<int>(b) >= 0) {
      atomicMin(reinterpret_cast<int*>(at), static_cast<int>(b));
    } else {
      atomicMax(reinterpret_cast<unsigned*>(at), b);
    }
  }
};

template <>
struct Keys<int> {
  using K = int;
  static constexpr K kNone = INT_MAX;
  static constexpr K kTop = INT_MAX;
  __device__ static int top() { return INT_MAX; }
  __device__ static int add(int a, int b) {  // wraps, as XLA does
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
  __device__ static int from_bits(int b) { return b; }
  __device__ static K key(int v) { return v; }
  __device__ static void apply(int* at, K k) { atomicMin(at, k); }
};

// A loaded edge's dst as the reference takes it (repro/kernels/
// edge_update/ref.py: segment_min over max(dst, 0), n segments): below 0
// it is vertex 0; from n on the edge is dropped, as a skipped edge (src
// -1) whose dst, clamped to n - 1, is never used as an address.
__device__ __forceinline__ void take_dst(int& s, int& d, long long n) {
  if (d >= n) {
    s = -1;
    d = static_cast<int>(n - 1);
  } else if (d < 0) {
    d = 0;
  }
}

// A lane's P consecutive edges from e: one 16-byte load an array when P is
// 4, ``vec`` (the three arrays 16-byte aligned) and the edges end by
// ``end``; else one load an edge, and past ``end`` an edge is (src -1,
// dst -1).  Every loaded dst goes through take_dst, so each dst lies in
// [0, n) but past the end.
template <typename T, int P>
__device__ __forceinline__ void load_edges(const int* __restrict__ src,
                                           const int* __restrict__ dst,
                                           const T* __restrict__ delta, long long e,
                                           long long end, long long n, bool vec, int (&s)[P],
                                           int (&d)[P], T (&dl)[P]) {
  if constexpr (P == 4) {
    if (vec && e + P <= end) {
      const int4 a = *reinterpret_cast<const int4*>(src + e);
      const int4 b = *reinterpret_cast<const int4*>(dst + e);
      const int4 c = *reinterpret_cast<const int4*>(delta + e);
      s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
      d[0] = b.x, d[1] = b.y, d[2] = b.z, d[3] = b.w;
      dl[0] = Keys<T>::from_bits(c.x), dl[1] = Keys<T>::from_bits(c.y);
      dl[2] = Keys<T>::from_bits(c.z), dl[3] = Keys<T>::from_bits(c.w);
#pragma unroll
      for (int j = 0; j < P; ++j) take_dst(s[j], d[j], n);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool in = e + j < end;
    s[j] = in ? src[e + j] : -1;
    d[j] = in ? dst[e + j] : -1;
    dl[j] = in ? delta[e + j] : T(0);
    if (in) take_dst(s[j], d[j], n);
  }
}

// One round: lane l holds edges P l + j as (d[j], k[j]).  Each run of equal
// consecutive dst gets one atomic of its min: a run inside the lane's P
// edges from the lane; a lane's first run ("head") and last ("tail") may go
// on into the next lanes, so the heads' mins go through a segmented min.
template <typename T, int P>
__device__ __forceinline__ void apply_round(const int (&d)[P],
                                            const typename Keys<T>::K (&k)[P],
                                            T* __restrict__ out, int lane) {
  using KT = Keys<T>;
  using K = typename KT::K;
  bool live = false;
#pragma unroll
  for (int j = 0; j < P; ++j) live |= k[j] < KT::kTop;
  if (!__any_sync(kFull, live)) return;  // nothing to apply: masked or past the end
  // the lane's runs in order: the head's min, the inner runs (applied
  // here), the tail's min in cur; one run (single): the lane's min in cur
  K head = k[0], cur = k[0];
  bool single = true;
#pragma unroll
  for (int j = 1; j < P; ++j) {
    if (d[j] != d[j - 1]) {
      if (single) {
        head = cur;
      } else if (cur < KT::kTop) {
        KT::apply(out + d[j - 1], cur);
      }
      single = false;
      cur = k[j];
    } else if (k[j] < cur) {
      cur = k[j];
    }
  }
  const int dh = d[0], dt = d[P - 1];
  // h: the min over the chain of heads from this lane on: lane l takes lane
  // l + o's h when their heads' dst are equal
  K h = single ? cur : head;
  const int dh_next = __shfl_down_sync(kFull, dh, 1);
  if (__any_sync(kFull, lane < 31 && dh_next == dh)) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      // past lane 31 a shuffle returns the lane's own dh and h: a no-op
      const int d2 = __shfl_down_sync(kFull, dh, o);
      const K h2 = __shfl_down_sync(kFull, h, o);
      if (d2 == dh && h2 < h) h = h2;
    }
  }
  const int dt_prev = __shfl_up_sync(kFull, dt, 1);
  const K h_next = __shfl_down_sync(kFull, h, 1);
  // the head leads unless the previous lane's tail goes on into it
  if ((lane == 0 || dt_prev != dh) && h < KT::kTop) KT::apply(out + dh, h);
  if (!single) {  // the tail, with the chain of heads it goes on into
    if (lane < 31 && dh_next == dt && h_next < cur) cur = h_next;
    if (cur < KT::kTop) KT::apply(out + dt, cur);
  }
}

template <typename T>
struct alignas(16) Four {
  T x, y, z, w;
};

// out = the sentinel, four values a thread (out comes from a fresh
// allocation, 16-byte aligned).  It lets the edge kernel launch at once
// (programmatic dependent launch): that kernel loads and gathers its first
// round, then waits for this grid before its first atomic.
template <typename T>
__global__ void __launch_bounds__(kThreads) fill_kernel(T* __restrict__ out, long long n) {
  asm volatile("griddepcontrol.launch_dependents;");
  const T top = Keys<T>::top();
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (4 * i + 3 < n) {
    reinterpret_cast<Four<T>*>(out)[i] = Four<T>{top, top, top, top};
  } else {
    for (long long j = 4 * i; j < n; ++j) out[j] = top;
  }
}

// The edges in chunks of ``chunk``: chunk c to warp c / gridDim.x of block
// c % gridDim.x, a round at a time (its loads, then its gathers, then its
// atomics).  Every thread waits for the fill's grid once: before its first
// atomic, or at the end when it has none.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
edge_update_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                   const T* __restrict__ delta, const T* __restrict__ values,
                   T* __restrict__ out, long long m, long long n, long long chunk) {
  using KT = Keys<T>;
  const T top = KT::top();
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const long long begin = c * chunk;
  const long long end = begin + chunk < m ? begin + chunk : m;
  const bool vec = ((reinterpret_cast<unsigned long long>(src) |
                     reinterpret_cast<unsigned long long>(dst) |
                     reinterpret_cast<unsigned long long>(delta)) & 15) == 0;
  bool filled = false;
  for (long long base = begin; base < end; base += 32 * P) {
    int s[P], d[P];
    T dl[P];
    load_edges<T, P>(src, dst, delta, base + P * lane, end, n, vec, s, d, dl);
    typename KT::K k[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      k[j] = KT::kNone;
      if (s[j] >= 0) {
        const T sv = values[s[j]];
        if (sv != top) k[j] = KT::key(KT::add(sv, dl[j]));
      }
    }
    if (!filled) {
      asm volatile("griddepcontrol.wait;" ::: "memory");
      filled = true;
    }
    apply_round<T, P>(d, k, out, lane);
  }
  if (!filled) asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, int P>
int launch(const void* src, const void* dst, const void* delta, const void* values,
           void* out, long long m, long long n, int blocks, long long chunk,
           cudaStream_t s) {
  T* o = static_cast<T*>(out);
  const long long fill = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  fill_kernel<T><<<static_cast<unsigned>(fill), kThreads, 0, s>>>(o, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, edge_update_kernel<T, P>, static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const T*>(delta),
      static_cast<const T*>(values), o, m, n, chunk));
}

}  // namespace

// dtype: 0 = float32, 1 = int32 (repro_torch/kernels/edge_update/edge_update.py).
// The fill, then the edges: ``blocks`` x 256 threads, ``per_lane`` (1 or 4)
// edges a lane in a round, each warp over ``chunk`` edges, a multiple of
// 32 * per_lane (edge_update.py::launch_plan); ``out`` 16-byte aligned.
extern "C" int edge_update_launch(const void* src, const void* dst, const void* delta,
                                  const void* values, void* out, long long m,
                                  long long n, int dtype, int per_lane, int blocks,
                                  long long chunk, void* stream) {
  if (n <= 0) return 0;
  if (m < 0 || blocks <= 0 || chunk <= 0 || (per_lane != 1 && per_lane != 4) ||
      chunk % (32 * per_lane) || static_cast<long long>(blocks) * (kThreads / 32) * chunk < m ||
      reinterpret_cast<unsigned long long>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool four = per_lane == 4;
  switch (dtype) {
    case 0:
      return four ? launch<float, 4>(src, dst, delta, values, out, m, n, blocks, chunk, s)
                  : launch<float, 1>(src, dst, delta, values, out, m, n, blocks, chunk, s);
    case 1:
      return four ? launch<int, 4>(src, dst, delta, values, out, m, n, blocks, chunk, s)
                  : launch<int, 1>(src, dst, delta, values, out, m, n, blocks, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
