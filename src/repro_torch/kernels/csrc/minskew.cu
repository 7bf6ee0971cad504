// Bounded-skew dispatch eligibility (paper §3.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/minskew.py
// (_minima_kernel, _elig_kernel, wrapper minskew).  For V variants of
// N vtasks and S scopes:
//   minima[v, j] = min vtime[v, i] over runnable members i of scope j,
//                  INF = 2^30 when there are none;
//   elig[v, i]   = runnable[v, i] and, for every scope j holding i with
//                  minima[v, j] < INF, vtime[v, i] <= minima[v, j] + skew[v, j].
// Layout: vtime (V,N) int32, runnable (V,N) int8, membership (V,N,S)
// int8, skew (V,S) int32 -> minima (V,S) int32, elig (V,N) int8, all
// contiguous.  minima must be pre-filled with INF by the caller.
//
// Bound on the H100: memory.  The kernel reads the N*S membership bytes
// twice (once per pass) and does one compare per byte; at N = 16,384 and
// S = 256 that is about 8.4 MB, about 2.5 us at 3.35 TB/s.  At the main
// path's N = 16,384 and S = 1 it moves 64 KB and is bound by launch
// latency instead.  The design keeps every membership read coalesced
// (pass 1 runs threads along S; pass 2 runs one warp per row with lanes
// along S), keeps the running minimum in a register and does one
// atomicMin per column and block.  An int32 min does not depend on
// order, so the atomics leave the result deterministic.  minima + skew
// stays within int32: at most 2^30 + (2^30 - 1).
#include <cuda_runtime.h>
#include <stdint.h>

#define INF_TICKS (1 << 30)
#define COLS 32          // pass 1: threads along S per block
#define ROW_THREADS 8    // pass 1: threads along N per block
#define ROWS_PER_BLOCK 128
#define WARPS_PER_BLOCK 8

// Pass 1: running min per column over a chunk of rows, reduced in
// shared memory, one atomicMin per column.
__global__ void minima_kernel(const int32_t* __restrict__ vtime,
                              const int8_t* __restrict__ runnable,
                              const int8_t* __restrict__ member,
                              int32_t* __restrict__ minima,
                              int n, int s) {
  __shared__ int32_t part[ROW_THREADS][COLS];
  const int v = blockIdx.z;
  const int col = blockIdx.x * COLS + threadIdx.x;
  const int row0 = blockIdx.y * ROWS_PER_BLOCK;
  const int row1 = min(row0 + ROWS_PER_BLOCK, n);
  const int32_t* vt = vtime + (size_t)v * n;
  const int8_t* run = runnable + (size_t)v * n;
  const int8_t* mem = member + (size_t)v * n * s;
  int32_t best = INF_TICKS;
  if (col < s) {
    for (int i = row0 + threadIdx.y; i < row1; i += ROW_THREADS) {
      if (run[i] != 0 && mem[(size_t)i * s + col] != 0) {
        best = min(best, vt[i]);
      }
    }
  }
  part[threadIdx.y][threadIdx.x] = best;
  __syncthreads();
  if (threadIdx.y == 0 && col < s) {
#pragma unroll
    for (int k = 1; k < ROW_THREADS; ++k) best = min(best, part[k][threadIdx.x]);
    if (best < INF_TICKS) atomicMin(&minima[(size_t)v * s + col], best);
  }
}

// Pass 2: one warp per row, lanes striding over S, a warp vote for the
// conjunction.  All lanes of a warp share the row, so the vote is
// reached by the whole warp or by none of it.
__global__ void elig_kernel(const int32_t* __restrict__ vtime,
                            const int8_t* __restrict__ runnable,
                            const int8_t* __restrict__ member,
                            const int32_t* __restrict__ skew,
                            const int32_t* __restrict__ minima,
                            int8_t* __restrict__ elig, int n, int s) {
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n) return;
  const size_t r = (size_t)v * n + row;
  const int32_t t = vtime[r];
  const int8_t* mem = member + r * s;
  const int32_t* mins = minima + (size_t)v * s;
  const int32_t* sk = skew + (size_t)v * s;
  bool ok = true;
  for (int j = lane; j < s; j += 32) {
    const int32_t mj = mins[j];
    if (mem[j] != 0 && mj != INF_TICKS && t > mj + sk[j]) ok = false;
  }
  ok = __all_sync(0xffffffffu, ok);
  if (lane == 0) elig[r] = (ok && runnable[r] != 0) ? 1 : 0;
}

extern "C" int minskew_launch(const void* vtime, const void* runnable,
                              const void* member, const void* skew,
                              void* minima, void* elig, int v, int n, int s,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 b1(COLS, ROW_THREADS);
  dim3 g1((s + COLS - 1) / COLS, (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, v);
  minima_kernel<<<g1, b1, 0, st>>>(
      (const int32_t*)vtime, (const int8_t*)runnable, (const int8_t*)member,
      (int32_t*)minima, n, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, v);
  elig_kernel<<<g2, WARPS_PER_BLOCK * 32, 0, st>>>(
      (const int32_t*)vtime, (const int8_t*)runnable, (const int8_t*)member,
      (const int32_t*)skew, (const int32_t*)minima, (int8_t*)elig, n, s);
  return (int)cudaGetLastError();
}
