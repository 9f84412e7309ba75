// DRAM bank state-machine timing engine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dram_timing/dram_timing.py:120
// (dram_timing_pallas_batch; its lax.scan twin is
// repro/core/engine.py::_scan_engine_impl).  Same int32 semantics, so the
// results are bit-equal: for each row of a padded [B, L] bank/row batch
// (bank == -1 is a no-op) walk the sequential bank state machine (per-bank
// open_row, row_ready, last_data, last_act; per-trace bus_free and
// hit/miss/conflict counters; lookahead window; static open/closed page)
// and write (cycles + tCL, hits, misses, conflicts) to out[B, 4].
//
// What bounds it on this card: the bytes it must move are 8 B per true
// request read (bank + row) plus 16 B per trace written, over 3.35 TB/s --
// microseconds for a whole scenario.  The real limit is the serial
// per-trace dependency chain (bus_free -> horizon -> t_act -> row_ready ->
// bus_free), walked by one thread: ~95 ns per request on an H100 80GB HBM3
// at 700 W (chip_smoke.py).  With the B <= ~60 traces of a scenario, most
// of the 132 SMs sit idle.
//
// Design: one thread block per trace.  Warps 1.. stage the trace's
// bank/row through double-buffered shared-memory chunks with coalesced
// loads while lane 0 of warp 0 walks the previous chunk with the per-bank
// state in shared memory.  The walk stops at lengths[b]; padding past it is
// a no-op in the reference, so stopping there is exact.
//
// A later version would shorten the chain itself: keep the bank state of
// the common nbanks <= 16 presets in registers, and time many scenarios'
// traces per launch so the card's SMs fill.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, loaded by ctypes)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;     // requests per staged chunk
constexpr int kMaxBanks = 128;

template <bool kPageOpen>
__global__ void __launch_bounds__(kThreads)
dram_timing_kernel(const int* __restrict__ bank, const int* __restrict__ row,
                   const int* __restrict__ lengths, int* __restrict__ out,
                   int L, int nbanks, int tCL, int tRCD, int tRP, int tRC,
                   int tBL, int lookahead) {
  __shared__ int s_bank[2][kChunk];
  __shared__ int s_row[2][kChunk];
  __shared__ int s_open[kMaxBanks];
  __shared__ int s_ready[kMaxBanks];
  __shared__ int s_data[kMaxBanks];
  __shared__ int s_act[kMaxBanks];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(b) * L;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int nchunks = (len + kChunk - 1) / kChunk;

  for (int i = tid; i < nbanks; i += kThreads) {
    s_open[i] = -1;
    s_ready[i] = 0;
    s_data[i] = 0;
    s_act[i] = -(tRC + 1);
  }
  // prologue: every thread stages chunk 0
  {
    const int cnt = len < kChunk ? len : kChunk;
    for (int i = tid; i < cnt; i += kThreads) {
      s_bank[0][i] = bank[base + i];
      s_row[0][i] = row[base + i];
    }
  }
  __syncthreads();

  int bus_free = 0, hits = 0, misses = 0, conflicts = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int cur = c & 1;
    if (tid < 32) {
      if (tid == 0) {
        const int start = c * kChunk;
        const int cnt = (len - start) < kChunk ? (len - start) : kChunk;
        const int* cb = s_bank[cur];
        const int* cr = s_row[cur];
        for (int i = 0; i < cnt; ++i) {
          const int bk = cb[i];
          if (bk < 0) continue;  // padding request: no-op
          const int r = cr[i];
          const int open = s_open[bk];
          const int act = s_act[bk];
          const int data = s_data[bk];
          bool is_hit, is_miss, is_conf;
          if (kPageOpen) {
            is_hit = open == r;
            is_miss = open == -1;
            is_conf = !is_hit && !is_miss;
          } else {  // closed page: every access activates
            is_hit = false;
            is_miss = true;
            is_conf = false;
          }
          const int horizon = max(bus_free - lookahead, 0);
          int new_ready;
          if (is_hit) {
            new_ready = s_ready[bk];
          } else {
            int t_act;
            if (is_conf) {
              const int t_pre = max(data, horizon);
              t_act = max(t_pre + tRP, act + tRC);
            } else {
              t_act = max(max(act + tRC, data), horizon);
            }
            new_ready = t_act + tRCD;
            s_act[bk] = t_act;
          }
          const int slot_end = max(new_ready, bus_free) + tBL;
          bus_free = slot_end;
          s_open[bk] = r;
          s_ready[bk] = new_ready;
          s_data[bk] = slot_end;
          hits += is_hit;
          misses += is_miss;
          conflicts += is_conf;
        }
      }
    } else {
      // warps 1..: stage chunk c + 1 into the other buffer
      const int start = (c + 1) * kChunk;
      if (start < len) {
        const int cnt = (len - start) < kChunk ? (len - start) : kChunk;
        const int nxt = cur ^ 1;
        for (int i = tid - 32; i < cnt; i += kThreads - 32) {
          s_bank[nxt][i] = bank[base + start + i];
          s_row[nxt][i] = row[base + start + i];
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[b * 4 + 0] = bus_free + tCL;
    out[b * 4 + 1] = hits;
    out[b * 4 + 2] = misses;
    out[b * 4 + 3] = conflicts;
  }
}

}  // namespace

extern "C" int dram_timing_batch_launch(
    const void* bank, const void* row, const void* lengths, void* out,
    int B, int L, int nbanks, int tCL, int tRCD, int tRP, int tRC, int tBL,
    int lookahead, int page_open, void* stream) {
  if (B <= 0) return 0;
  if (nbanks <= 0 || nbanks > kMaxBanks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bk = static_cast<const int*>(bank);
  const int* rw = static_cast<const int*>(row);
  const int* ln = static_cast<const int*>(lengths);
  int* o = static_cast<int*>(out);
  if (page_open) {
    dram_timing_kernel<true><<<B, kThreads, 0, s>>>(
        bk, rw, ln, o, L, nbanks, tCL, tRCD, tRP, tRC, tBL, lookahead);
  } else {
    dram_timing_kernel<false><<<B, kThreads, 0, s>>>(
        bk, rw, ln, o, L, nbanks, tCL, tRCD, tRP, tRC, tBL, lookahead);
  }
  return static_cast<int>(cudaGetLastError());
}
