// DRAM bank state-machine timing engine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dram_timing/dram_timing.py:120
// (dram_timing_pallas_batch; its lax.scan twin is
// repro/core/engine.py::_scan_engine_impl).  Same int32 semantics, so the
// results are bit-equal: for each row of a padded [B, L] bank/row batch
// (bank == -1 is a no-op; the walk stops at lengths[b]) run the sequential
// bank state machine (per-bank open_row, row_ready, last_data, last_act;
// per-trace bus_free and hit/miss/conflict counters; lookahead window;
// static open/closed page) and write (cycles + tCL, hits, misses,
// conflicts) to out[B, 4].
//
// What bounds it on this card.  The bytes are 8 B per request read (bank,
// row) and 16 B per trace written: about a microsecond at 3.35 TB/s for
// the main path's largest call.  Walked as written, one request after
// another, a trace is a dependent chain of a few dozen int32 instructions a
// request, and a call holds only a few traces (B = 1..8 on the paper
// graphs), so one thread a trace leaves nearly all 132 SMs idle and the
// call takes the chain's latency, about 0.1 us a request.  That chain is not
// the least time: the work can be split.
//
// The segmented design (the matrix path).
//  * A request's class (hit / miss / conflict) depends only on the last row
//    its bank saw, never on time.  Every timing update is a max or a + of
//    int32 state and constants, and row_ready[k] always equals
//    max(last_act[k] + tRCD, 0) (the wrapper checks the timings for which
//    that holds).  So, once classes are known, a run of requests is a
//    max-plus linear map of the state (0, bus_free, last_act[0..nb),
//    last_data[0..nb)), a D x D matrix with D = 2 nb + 2 (34 for 16 banks).
//  * The wrapper cuts each trace into S segments (of 256 requests, or fewer
//    segments where B x S warps would overfill the card).  Kernel 1 records
//    the last row each segment leaves in each bank; kernel 2 scans those
//    over each trace's segments, which gives each segment its banks' open
//    rows at its start.  Kernel 3 runs one warp per segment: it classifies
//    32 requests at a time (match_any finds the previous request to the same
//    bank inside the chunk), counts the classes, and builds the segment's
//    map from the identity.  Lanes own columns, so a request rewrites the
//    rows bus_free (registers), last_act and last_data of its bank (shared
//    memory, a warp's private columns) with no cross-lane traffic; the next
//    request's bank rows are loaded before this one's are stored and
//    forwarded from registers when the bank repeats.  Entries that stand for
//    -inf start at NEG = -2^30 and stay above it (the only negative
//    constant, -lookahead, is maxed with the 0 / NEG column), so no sum
//    wraps.  Kernel 4 multiplies groups of about sqrt(S / 3) consecutive maps
//    into one, in parallel over groups; kernel 5 folds each trace's group
//    products in order over the start vector (0, 0, -(tRC+1).., 0..),
//    reading an entry below NEG / 2 as -inf.  Max and + are exact in
//    integers, so the result is bit-equal to the one-request walk.
//  * What bounds it now is no longer the bytes or the operations (the maps
//    cost about 8 int32 operations a request in each of D columns, about a
//    microsecond of the card's scalar rate at the largest call) but three
//    shorter dependent chains: a warp's walk over its segment, a group's
//    sequence of 34 x 34 products, and the fold's sequence of mat-vecs.  The
//    segment length and the group size balance them (PERF.md has the times
//    of each kernel).
//  * Batches too short to cut (S = 1) and banks past the matrix path
//    (nbanks > 16, up to 128) take the direct walk: a warp per trace, the
//    warp's lanes stage requests into shared memory by cp.async while lane 0
//    walks them with the bank state in shared memory.  A step is set by the
//    in-order issue of its few dozen dependent instructions: loading the
//    next request's bank state ahead and forwarding it when the bank repeats
//    added instructions and was slower on the card, so the walk reads its
//    bank state where it needs it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBanks = 128;
constexpr int kMatrixBanks = 16;     // D = 34: two columns a lane
constexpr int kNeg = -(1 << 30);     // max-plus -inf, saturated
constexpr int kNegHalf = -(1 << 29); // entries below this are read as -inf
constexpr int kNone = INT_MIN;       // "the segment left no row in this bank"

constexpr int kWalkWarps = 4;        // direct walk: traces per block
constexpr int kChunk = 512;          // direct walk: requests per staged chunk
constexpr int kSegWarps = 4;         // segments per block (kernels 1 and 3)
constexpr int kMaxD = 2 * kMatrixBanks + 2;
constexpr int kPad = 36;             // map products: padded row, 16-byte aligned
constexpr int kCombineThreads = 32 * ((kMaxD / 2 * kPad / 4 + 31) / 32);  // a 2 x 4 tile each
constexpr int kCombineLoads = (kMaxD * kMaxD + kCombineThreads - 1) / kCombineThreads;
constexpr int kScanThreads = 1024;   // open rows: segments a step
constexpr int kFoldThreads = 2 * 32 * ((kMaxD + 31) / 32);  // two threads a row

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int L) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > L ? L : len);
}

// ---------------------------------------------------------------------------
// Direct walk: one warp per trace, lane 0 walks, the warp stages.
// ---------------------------------------------------------------------------

template <bool kPageOpen>
__global__ void __launch_bounds__(32 * kWalkWarps)
walk_kernel(const int* __restrict__ bank, const int* __restrict__ row,
            const int* __restrict__ lengths, int* __restrict__ out, int B, int L,
            int nbanks, int tCL, int tRCD, int tRP, int tRC, int tBL, int lookahead) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= B) return;
  int* s_bank = smem + warp * (4 * kChunk + 4 * nbanks);  // [2][kChunk]
  int* s_row = s_bank + 2 * kChunk;                         // [2][kChunk]
  int* s_open = s_row + 2 * kChunk;
  int* s_ready = s_open + nbanks;
  int* s_act = s_ready + nbanks;
  int* s_data = s_act + nbanks;

  const long long base = static_cast<long long>(b) * L;
  const int len = clamp_len(lengths, b, L);
  const int nchunks = (len + kChunk - 1) / kChunk;
  for (int k = lane; k < nbanks; k += 32) {
    s_open[k] = -1;
    s_ready[k] = 0;
    s_act[k] = -(tRC + 1);
    s_data[k] = 0;
  }
  auto stage = [&](int c) {
    const int start = c * kChunk;
    const int cnt = min(kChunk, len - start);
    int* db = s_bank + (c & 1) * kChunk;
    int* dr = s_row + (c & 1) * kChunk;
    for (int i = lane; i < cnt; i += 32) {
      cp_async4(db + i, bank + base + start + i);
      cp_async4(dr + i, row + base + start + i);
    }
  };
  if (nchunks > 0) stage(0);
  cp_async_commit();

  int bus_free = 0, hits = 0, misses = 0, conflicts = 0;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) stage(c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    if (lane == 0) {
      const int cnt = min(kChunk, len - c * kChunk);
      const int* cb = s_bank + (c & 1) * kChunk;
      const int* cr = s_row + (c & 1) * kChunk;
      for (int i = 0; i < cnt; ++i) {
        const int k = cb[i];
        if (k < 0) continue;
        const int r = cr[i];
        const int open = s_open[k], act = s_act[k], data = s_data[k];
        bool is_hit, is_miss, is_conf;
        if (kPageOpen) {
          is_hit = open == r;
          is_miss = open == -1;
          is_conf = !is_hit && !is_miss;
        } else {
          is_hit = false;
          is_miss = true;
          is_conf = false;
        }
        const int horizon = max(bus_free - lookahead, 0);
        int new_ready;
        if (is_hit) {
          new_ready = s_ready[k];
        } else {
          int t_act;
          if (is_conf) {
            t_act = max(max(data, horizon) + tRP, act + tRC);
          } else {
            t_act = max(max(act + tRC, data), horizon);
          }
          new_ready = t_act + tRCD;
          s_act[k] = t_act;
        }
        const int slot_end = max(new_ready, bus_free) + tBL;
        bus_free = slot_end;
        s_open[k] = r;
        s_ready[k] = new_ready;
        s_data[k] = slot_end;
        hits += is_hit;
        misses += is_miss;
        conflicts += is_conf;
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    out[b * 4 + 0] = bus_free + tCL;
    out[b * 4 + 1] = hits;
    out[b * 4 + 2] = misses;
    out[b * 4 + 3] = conflicts;
  }
}

// ---------------------------------------------------------------------------
// Matrix path.  Segment m = b * S + s covers requests [s * seg, (s+1) * seg)
// of trace b, cut at lengths[b]; a segment past it is empty (the identity)
// and no kernel touches its matrix or counters.
// ---------------------------------------------------------------------------

struct Segment {
  int b, s;
  long long base, start, end;  // base of the trace; its [start, end)
};

__device__ __forceinline__ Segment segment_of(int m, int S, int seg, int L,
                                              const int* lengths) {
  Segment g;
  g.b = m / S;
  g.s = m - g.b * S;
  g.base = static_cast<long long>(g.b) * L;
  g.start = static_cast<long long>(g.s) * seg;
  g.end = min(g.start + seg, static_cast<long long>(clamp_len(lengths, g.b, L)));
  return g;
}

// Kernel 1 (open page): the last row each segment leaves in each bank, or
// kNone where it leaves none.  last[m][nbanks].
__global__ void __launch_bounds__(32 * kSegWarps)
last_rows_kernel(const int* __restrict__ bank, const int* __restrict__ row,
                 const int* __restrict__ lengths, int* __restrict__ last, int B, int L,
                 int S, int seg, int nbanks) {
  __shared__ int s_idx[kSegWarps][kMatrixBanks];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kSegWarps + warp;
  if (m >= B * S) return;
  const Segment g = segment_of(m, S, seg, L, lengths);
  if (lane < nbanks) s_idx[warp][lane] = -1;
  __syncwarp();
  for (long long i = g.start + lane; i < g.end; i += 32) {
    const int bk = bank[g.base + i];
    if (bk >= 0) atomicMax(&s_idx[warp][bk], static_cast<int>(i));
  }
  __syncwarp();
  if (lane < nbanks) {
    const int idx = s_idx[warp][lane];
    last[static_cast<long long>(m) * nbanks + lane] = idx >= 0 ? row[g.base + idx] : kNone;
  }
}

// Kernel 2 (open page): the open row of each bank at each segment's start,
// an exclusive scan over the trace's segments of "the latest segment that
// left a row".  One block per (trace, bank), a segment a thread,
// kScanThreads segments a step.
__global__ void __launch_bounds__(kScanThreads)
open_rows_kernel(const int* __restrict__ last, int* __restrict__ open0, int S, int nbanks) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_incl[kScanThreads];
  const int b = blockIdx.x / nbanks, k = blockIdx.x - b * nbanks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = static_cast<long long>(b) * S;
  int carry = -1;  // the latest segment before this step with a row, or -1
  for (int c = 0; c < S; c += kScanThreads) {
    const int s = c + tid;
    int idx = (s < S && last[(base + s) * nbanks + k] != kNone) ? s : -1;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, idx, off);
      if (lane >= off) idx = max(idx, t);
    }
    if (lane == 31) s_warp[warp] = idx;
    __syncthreads();
    int before = carry;  // over earlier warps of this step
    for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
    s_incl[tid] = max(idx, before);
    __syncthreads();
    const int excl = tid > 0 ? s_incl[tid - 1] : carry;
    // a bank no request has touched is closed
    if (s < S) open0[(base + s) * nbanks + k] = excl >= 0 ? last[(base + excl) * nbanks + k] : -1;
    carry = s_incl[kScanThreads - 1];
    __syncthreads();
  }
}

// Kernel 3: one warp per segment builds its max-plus matrix (row-major,
// mats[m][D][D]; row i is the new value of state i as max_j (M[i][j] +
// x_j)) and its counters (counts[m][3]: hits, misses, conflicts).  Lane l
// owns columns l + 32 i, i < NC.
template <int NC, bool kPageOpen>
__global__ void __launch_bounds__(32 * kSegWarps)
segment_maps_kernel(const int* __restrict__ bank, const int* __restrict__ row,
                    const int* __restrict__ lengths, const int* __restrict__ open0,
                    int* __restrict__ mats, int* __restrict__ counts, int B, int L, int S,
                    int seg, int nbanks, int tRCD, int tRP, int tRC, int tBL,
                    int lookahead) {
  constexpr int W = 32 * NC;  // shared-memory row stride: a lane's columns
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kSegWarps + warp;
  if (m >= B * S) return;
  const Segment g = segment_of(m, S, seg, L, lengths);
  if (g.start >= g.end) return;
  const int D = 2 * nbanks + 2;
  int* s_rows = smem + warp * (2 * nbanks * W + 32);  // last_act rows, then last_data rows
  int* s_open = s_rows + 2 * nbanks * W;

  int zc[NC], bf[NC];  // the constant row (0 in column 0) and bus_free's row
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    zc[i] = c == 0 ? 0 : kNeg;
    bf[i] = c == 1 ? 0 : kNeg;
  }
  for (int k = 0; k < nbanks; ++k) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      s_rows[k * W + c] = c == 2 + k ? 0 : kNeg;
      s_rows[(nbanks + k) * W + c] = c == 2 + nbanks + k ? 0 : kNeg;
    }
  }
  if (kPageOpen && lane < nbanks) s_open[lane] = open0[static_cast<long long>(m) * nbanks + lane];
  __syncwarp();

  int hits = 0, misses = 0, conflicts = 0;
  // chunk of 32 requests, one a lane, coalesced; the next chunk is loaded
  // before this one is walked
  long long i0 = g.start;
  int cb, cr;
  {
    const long long i = i0 + lane;
    cb = i < g.end ? bank[g.base + i] : -1;
    cr = i < g.end ? row[g.base + i] : 0;
  }
  for (; i0 < g.end; i0 += 32) {
    const long long ni = i0 + 32 + lane;
    const int next_b = ni < g.end ? bank[g.base + ni] : -1;
    const int next_r = ni < g.end ? row[g.base + ni] : 0;
    const bool valid = cb >= 0;
    const unsigned vm = __ballot_sync(kFull, valid);
    unsigned hm = 0, cm = 0;
    if (kPageOpen) {
      // the row this request finds open: that of the previous request to
      // its bank in the chunk, else the bank's open row before the chunk
      const unsigned peers = __match_any_sync(kFull, valid ? cb : -1 - lane);
      const unsigned before = peers & ((1u << lane) - 1u);
      const int prev = before ? 31 - __clz(before) : lane;
      const int prev_row = __shfl_sync(kFull, cr, prev);
      const int open = before ? prev_row : (valid ? s_open[cb] : 0);
      const bool is_hit = valid && open == cr;
      const bool is_miss = valid && open == -1;
      hm = __ballot_sync(kFull, is_hit);
      const unsigned mm = __ballot_sync(kFull, is_miss);
      cm = vm & ~(hm | mm);  // a hit that is also a miss is no conflict
      hits += __popc(hm);
      misses += __popc(mm);
      conflicts += __popc(cm);
      __syncwarp();
      const unsigned after = peers & ~((2u << lane) - 1u);
      if (valid && after == 0) s_open[cb] = cr;  // the chunk's last request to its bank
      __syncwarp();
    } else {
      misses += __popc(vm);
    }

    unsigned todo = vm;
    if (todo) {
      int j = __ffs(todo) - 1;
      int k = __shfl_sync(kFull, cb, j);
      int a[NC], d[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        a[i] = s_rows[k * W + lane + 32 * i];
        d[i] = s_rows[(nbanks + k) * W + lane + 32 * i];
      }
      while (true) {
        todo &= todo - 1u;
        const int jn = todo ? __ffs(todo) - 1 : j;
        const int kn = __shfl_sync(kFull, cb, jn);
        int an[NC], dn[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) {  // the next request's rows, before this one's store
          an[i] = s_rows[kn * W + lane + 32 * i];
          dn[i] = s_rows[(nbanks + kn) * W + lane + 32 * i];
        }
        const bool is_hit = (hm >> j) & 1u;
        const bool is_conf = (cm >> j) & 1u;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int horizon = max(bf[i] - lookahead, zc[i]);
          int t_act, ready;
          if (is_hit) {  // warp-uniform
            t_act = a[i];
            ready = max(a[i] + tRCD, zc[i]);
          } else {
            t_act = is_conf ? max(max(d[i], horizon) + tRP, a[i] + tRC)
                            : max(max(a[i] + tRC, d[i]), horizon);
            ready = t_act + tRCD;
          }
          const int slot_end = max(ready, bf[i]) + tBL;
          bf[i] = slot_end;
          s_rows[k * W + lane + 32 * i] = t_act;
          s_rows[(nbanks + k) * W + lane + 32 * i] = slot_end;
          if (kn == k) {
            an[i] = t_act;
            dn[i] = slot_end;
          }
        }
        if (!todo) break;
        j = jn;
        k = kn;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          a[i] = an[i];
          d[i] = dn[i];
        }
      }
    }
    cb = next_b;
    cr = next_r;
  }

  int* M = mats + static_cast<long long>(m) * D * D;
  for (int r = 0; r < D; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        M[r * D + c] = r == 0 ? zc[i] : (r == 1 ? bf[i] : s_rows[(r - 2) * W + c]);
      }
    }
  }
  if (lane == 0) {
    counts[m * 3 + 0] = hits;
    counts[m * 3 + 1] = misses;
    counts[m * 3 + 2] = conflicts;
  }
}

__device__ __forceinline__ int live_segments(const int* lengths, int b, int L, int S, int seg) {
  const long long len = clamp_len(lengths, b, L);
  return static_cast<int>(min(static_cast<long long>(S), (len + seg - 1) / seg));
}

// Kernel 4: one block per group of G consecutive non-empty segments of a
// trace multiplies their maps into one, P = M_last (x) ... (x) M_first, and
// writes it over the group's first map.  A product entry that falls to
// NEG / 2 or below is -inf and is stored as NEG again, so -inf entries never
// drift towards the int32 edge.  In shared memory the maps' rows are padded
// to kPad entries (NEG outside the map); a thread computes a 2 x 4 tile of
// the product from 16-byte loads, and the next map is loaded into registers
// while this one is multiplied.
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(int* __restrict__ mats, const int* __restrict__ lengths, int L, int S,
               int seg, int G, int groups, int nbanks) {
  __shared__ __align__(16) int sP[kMaxD * kPad];  // the product so far
  __shared__ __align__(16) int sM[kMaxD * kPad];  // the map to apply next
  const int b = blockIdx.x / groups, g = blockIdx.x - b * groups, tid = threadIdx.x;
  const int first = g * G;
  const int last = min(first + G, live_segments(lengths, b, L, S, seg));
  if (last - first < 2) return;
  const int D = 2 * nbanks + 2, DD = D * D;
  int* mg = mats + (static_cast<long long>(b) * S + first) * DD;
  for (int e = tid; e < kMaxD * kPad; e += kCombineThreads) {
    sP[e] = kNeg;
    sM[e] = kNeg;
  }
  __syncthreads();
  for (int e = tid; e < DD; e += kCombineThreads) {
    const int i = e / D, k = e - i * D;
    sP[i * kPad + k] = mg[e];
    sM[i * kPad + k] = mg[DD + e];
  }
  __syncthreads();
  const int i0 = 2 * (tid / (kPad / 4)), k0 = 4 * (tid % (kPad / 4));
  const bool tiled = i0 < kMaxD;
  for (int s = first + 1; s < last; ++s) {
    int nxt[kCombineLoads];
#pragma unroll
    for (int u = 0; u < kCombineLoads; ++u) {
      const int e = tid + u * kCombineThreads;
      if (s + 1 < last && e < DD) nxt[u] = mg[static_cast<long long>(s + 1 - first) * DD + e];
    }
    int acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = INT_MIN;
    if (tiled) {
#pragma unroll
      for (int j = 0; j < kMaxD; ++j) {
        if (j < D) {
          const int m0 = sM[i0 * kPad + j], m1 = sM[(i0 + 1) * kPad + j];
          const int4 p = *reinterpret_cast<const int4*>(sP + j * kPad + k0);
          acc[0][0] = max(acc[0][0], m0 + p.x);
          acc[0][1] = max(acc[0][1], m0 + p.y);
          acc[0][2] = max(acc[0][2], m0 + p.z);
          acc[0][3] = max(acc[0][3], m0 + p.w);
          acc[1][0] = max(acc[1][0], m1 + p.x);
          acc[1][1] = max(acc[1][1], m1 + p.y);
          acc[1][2] = max(acc[1][2], m1 + p.z);
          acc[1][3] = max(acc[1][3], m1 + p.w);
        }
      }
    }
    __syncthreads();
    if (tiled) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        int4 q;
        q.x = acc[a][0] > kNegHalf ? acc[a][0] : kNeg;
        q.y = acc[a][1] > kNegHalf ? acc[a][1] : kNeg;
        q.z = acc[a][2] > kNegHalf ? acc[a][2] : kNeg;
        q.w = acc[a][3] > kNegHalf ? acc[a][3] : kNeg;
        *reinterpret_cast<int4*>(sP + (i0 + a) * kPad + k0) = q;
      }
    }
#pragma unroll
    for (int u = 0; u < kCombineLoads; ++u) {
      const int e = tid + u * kCombineThreads;
      if (s + 1 < last && e < DD) {
        const int i = e / D, k = e - i * D;
        sM[i * kPad + k] = nxt[u];
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < DD; e += kCombineThreads) {
    const int i = e / D, k = e - i * D;
    mg[e] = sP[i * kPad + k];
  }
}

// Kernel 5: one block per trace folds its maps in order over the start
// vector and sums the segments' counters.  With groups, the maps are the
// groups' products (every G-th slot).  Two threads a row; the next map's
// entries are loaded into registers while this one is applied.
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const int* __restrict__ mats, const int* __restrict__ counts,
            const int* __restrict__ lengths, int* __restrict__ out, int L, int S, int seg,
            int G, int nbanks, int tCL, int tRC) {
  __shared__ int xs[kMaxD];
  __shared__ int s_sum[kFoldThreads / 32][3];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int D = 2 * nbanks + 2, DD = D * D;
  const int nseg = live_segments(lengths, b, L, S, seg);
  const int steps = (nseg + G - 1) / G;
  if (tid < D) xs[tid] = (tid >= 2 && tid < 2 + nbanks) ? -(tRC + 1) : 0;
  const int r = tid >> 1, part = tid & 1;
  constexpr int kPer = kMaxD / 2;  // entries of a row a thread applies
  const int* mrow = mats + static_cast<long long>(b) * S * DD + r * D;
  const long long stride = static_cast<long long>(G) * DD;
  int m[kPer], n[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = 2 * u + part;
    m[u] = (steps > 0 && r < D && j < D) ? mrow[j] : INT_MIN;
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = 2 * u + part;
      n[u] = (t + 1 < steps && r < D && j < D) ? mrow[(t + 1) * stride + j] : INT_MIN;
    }
    int y = INT_MIN;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = 2 * u + part;
      if (j < D) y = max(y, m[u] > kNegHalf ? m[u] + xs[j] : INT_MIN);
    }
    y = max(y, __shfl_xor_sync(kFull, y, 1));
    __syncthreads();
    if (r < D && part == 0) xs[r] = y;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) m[u] = n[u];
  }

  int h = 0, mi = 0, co = 0;
  for (int s = tid; s < nseg; s += kFoldThreads) {
    const int* c = counts + (static_cast<long long>(b) * S + s) * 3;
    h += c[0];
    mi += c[1];
    co += c[2];
  }
  for (int off = 16; off > 0; off >>= 1) {
    h += __shfl_xor_sync(kFull, h, off);
    mi += __shfl_xor_sync(kFull, mi, off);
    co += __shfl_xor_sync(kFull, co, off);
  }
  if ((tid & 31) == 0) {
    s_sum[tid >> 5][0] = h;
    s_sum[tid >> 5][1] = mi;
    s_sum[tid >> 5][2] = co;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kFoldThreads / 32; ++w) {
      h += s_sum[w][0];
      mi += s_sum[w][1];
      co += s_sum[w][2];
    }
    out[b * 4 + 0] = xs[1] + tCL;
    out[b * 4 + 1] = h;
    out[b * 4 + 2] = mi;
    out[b * 4 + 3] = co;
  }
}

// Scratch of the matrix path, in int32 elements, laid out as
// mats[B*S][D][D], counts[B*S][3], last[B*S][nbanks], open0[B*S][nbanks]
// (mats first, so that every matrix starts 16-byte aligned).
long long scratch_ints(int B, int S, int nbanks) {
  const long long segs = static_cast<long long>(B) * S;
  const long long D = 2 * nbanks + 2;
  return segs * (D * D + 3 + 2 * nbanks);
}

template <int NC, bool kPageOpen>
cudaError_t launch_matrix(const int* bk, const int* rw, const int* ln, int* o, int B, int L,
                          int S, int nbanks, int tCL, int tRCD, int tRP, int tRC, int tBL,
                          int lookahead, int* scratch, cudaStream_t st) {
  const int seg = static_cast<int>((static_cast<long long>(L) + S - 1) / S);
  const long long segs = static_cast<long long>(B) * S;
  const int D = 2 * nbanks + 2;
  int* mats = scratch;
  int* counts = mats + segs * D * D;
  int* last = counts + segs * 3;
  int* open0 = last + segs * nbanks;
  const int blocks = static_cast<int>((segs + kSegWarps - 1) / kSegWarps);
  if (kPageOpen) {
    last_rows_kernel<<<blocks, 32 * kSegWarps, 0, st>>>(bk, rw, ln, last, B, L, S, seg, nbanks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    open_rows_kernel<<<B * nbanks, kScanThreads, 0, st>>>(last, open0, S, nbanks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t maps_smem = sizeof(int) * kSegWarps * (2 * nbanks * 32 * NC + 32);
  segment_maps_kernel<NC, kPageOpen><<<blocks, 32 * kSegWarps, maps_smem, st>>>(
      bk, rw, ln, open0, mats, counts, B, L, S, seg, nbanks, tRCD, tRP, tRC, tBL, lookahead);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // groups of about sqrt(S / 3) segments: a group's G - 1 products and the
  // fold's S / G steps then take about as long (a product costs about three
  // fold steps); the products run in parallel over groups
  int G = 1;
  while (3 * G * G < S) ++G;
  if (G < 3) G = 1;
  if (G > 1) {
    const int groups = (S + G - 1) / G;
    combine_kernel<<<B * groups, kCombineThreads, 0, st>>>(
        mats, ln, L, S, seg, G, groups, nbanks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fold_kernel<<<B, kFoldThreads, 0, st>>>(mats, counts, ln, o, L, S, seg, G, nbanks, tCL, tRC);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long dram_timing_scratch_ints(int B, int segments, int nbanks) {
  return segments > 1 ? scratch_ints(B, segments, nbanks) : 0;
}

// Banks the matrix path holds (the wrapper's MATRIX_BANKS must agree).
extern "C" int dram_timing_matrix_banks() { return kMatrixBanks; }

// segments == 1: the direct walk (any nbanks up to kMaxBanks).  segments >
// 1: the matrix path with each trace cut into that many segments of
// ceil(L / segments) requests (nbanks up to kMatrixBanks; scratch of
// dram_timing_scratch_ints elements).
extern "C" int dram_timing_batch_launch(
    const void* bank, const void* row, const void* lengths, void* out,
    int B, int L, int nbanks, int tCL, int tRCD, int tRP, int tRC, int tBL,
    int lookahead, int page_open, int segments, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (nbanks <= 0 || nbanks > kMaxBanks || segments < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bk = static_cast<const int*>(bank);
  const int* rw = static_cast<const int*>(row);
  const int* ln = static_cast<const int*>(lengths);
  int* o = static_cast<int*>(out);
  int* sc = static_cast<int*>(scratch);
  if (segments == 1) {
    const int blocks = (B + kWalkWarps - 1) / kWalkWarps;
    const size_t smem = sizeof(int) * kWalkWarps * (4 * kChunk + 4 * nbanks);
    if (page_open) {
      walk_kernel<true><<<blocks, 32 * kWalkWarps, smem, st>>>(
          bk, rw, ln, o, B, L, nbanks, tCL, tRCD, tRP, tRC, tBL, lookahead);
    } else {
      walk_kernel<false><<<blocks, 32 * kWalkWarps, smem, st>>>(
          bk, rw, ln, o, B, L, nbanks, tCL, tRCD, tRP, tRC, tBL, lookahead);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (nbanks > kMatrixBanks || sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (2 * nbanks + 2 <= 32) {
    err = page_open ? launch_matrix<1, true>(bk, rw, ln, o, B, L, segments, nbanks, tCL, tRCD,
                                             tRP, tRC, tBL, lookahead, sc, st)
                    : launch_matrix<1, false>(bk, rw, ln, o, B, L, segments, nbanks, tCL, tRCD,
                                              tRP, tRC, tBL, lookahead, sc, st);
  } else {
    err = page_open ? launch_matrix<2, true>(bk, rw, ln, o, B, L, segments, nbanks, tCL, tRCD,
                                             tRP, tRC, tBL, lookahead, sc, st)
                    : launch_matrix<2, false>(bk, rw, ln, o, B, L, segments, nbanks, tCL, tRCD,
                                              tRP, tRC, tBL, lookahead, sc, st);
  }
  return static_cast<int>(err);
}
