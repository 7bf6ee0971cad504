// Batched hub message visibility (paper §3.4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hub_route.py
// (_kernel, wrapper hub_route).  Messages are sorted by (link, send);
// per link the FIFO queue gives
//   end_i = max(send_i, end_{i-1, same link}) + ser_i,
//   out_i = end_i + lat[link_i],
// a segmented max-plus scan.  Each message is the element
// (S, A, G) = (send_i, ser_i, segment start); the combine of an earlier
// x and a later y is
//   s = y.G ? y.S : max(x.S, y.S - x.A),  a = y.G ? y.A : x.A + y.A,
//   g = x.G | y.G,
// with identity (NEG = -2^30, 0, false).  Integer max and + are exact
// and associative, so any bracketing equals the sequential oracle bit
// for bit.  Segment starts (i == 0 or link[i] != link[i-1]) are found
// here, so the caller pads nothing and needs no fake link.
//
// Three phases, all on the caller's stream:
//   1. tile_aggregate: each block scans its tile of TILE messages
//      (ITEMS per thread in registers, __shfl_up_sync across a warp,
//      warp totals across the block in shared memory) and writes the
//      tile's aggregate;
//   2. scan_aggregates: one block scans the tile aggregates into each
//      tile's incoming carry;
//   3. tile_output: each block scans its tile again and folds the carry
//      into the elements whose prefix holds no segment start (the fold
//      of the TPU kernel's cross-tile carry), writing S + A + lat[link].
//
// Bound on the H100: memory and launches.  A message moves about 20 B
// (send, ser, link read, lat gathered, out written); at the main path's
// M = 65,600 that is about 1.3 MB, under 1 us at 3.35 TB/s, so the three
// launches dominate.  Phase 3 re-reads the inputs rather than storing
// the tile-local scan, which moves fewer bytes than a scratch round
// trip.  Built without --use_fast_math; the kernel does integer work only.
//
// A link id outside the latency table trips a device-side assert, which
// surfaces as a CUDA error at the caller's next synchronisation (as
// PyTorch's own indexing kernels do), so the launch itself never waits
// on the device.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_TICKS (-(1 << 30))
#define THREADS 256
#define ITEMS 4
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)

struct Elt {
  int32_t s;
  int32_t a;
  int32_t g;
};

__device__ __forceinline__ Elt identity() { return Elt{NEG_TICKS, 0, 0}; }

// x earlier, y later
__device__ __forceinline__ Elt combine(Elt x, Elt y) {
  Elt r;
  if (y.g) {
    r.s = y.s;
    r.a = y.a;
  } else {
    r.s = max(x.s, y.s - x.a);
    r.a = x.a + y.a;
  }
  r.g = x.g | y.g;
  return r;
}

__device__ __forceinline__ Elt load_msg(const int32_t* send, const int32_t* ser,
                                        const int32_t* link, int i, int m) {
  if (i >= m) return identity();
  Elt e;
  e.s = send[i];
  e.a = ser[i];
  e.g = (i == 0 || link[i] != link[i - 1]) ? 1 : 0;
  return e;
}

// Block-wide exclusive scan of one element per thread; also returns
// the block's inclusive total.  Needs blockDim.x == THREADS.
__device__ Elt block_exclusive(Elt x, Elt* total) {
  __shared__ Elt warp_tot[WARPS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  Elt inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Elt o;
    o.s = __shfl_up_sync(0xffffffffu, inc.s, d);
    o.a = __shfl_up_sync(0xffffffffu, inc.a, d);
    o.g = __shfl_up_sync(0xffffffffu, inc.g, d);
    if (lane >= d) inc = combine(o, inc);
  }
  Elt lane_ex;
  lane_ex.s = __shfl_up_sync(0xffffffffu, inc.s, 1);
  lane_ex.a = __shfl_up_sync(0xffffffffu, inc.a, 1);
  lane_ex.g = __shfl_up_sync(0xffffffffu, inc.g, 1);
  if (lane == 0) lane_ex = identity();
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    Elt t = lane < WARPS ? warp_tot[lane] : identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Elt o;
      o.s = __shfl_up_sync(0xffffffffu, t.s, d);
      o.a = __shfl_up_sync(0xffffffffu, t.a, d);
      o.g = __shfl_up_sync(0xffffffffu, t.g, d);
      if (lane >= d) t = combine(o, t);
    }
    if (lane < WARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  Elt warp_ex = w > 0 ? warp_tot[w - 1] : identity();
  *total = warp_tot[WARPS - 1];
  __syncthreads();  // warp_tot is reused by the caller's next scan
  return combine(warp_ex, lane_ex);
}

// Per-thread aggregate of its ITEMS consecutive messages of the tile.
__device__ Elt thread_aggregate(const int32_t* send, const int32_t* ser,
                                const int32_t* link, int base, int m) {
  Elt agg = identity();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) agg = combine(agg, load_msg(send, ser, link, base + k, m));
  return agg;
}

__global__ void tile_aggregate(const int32_t* __restrict__ send,
                               const int32_t* __restrict__ ser,
                               const int32_t* __restrict__ link,
                               int32_t* __restrict__ agg, int m, int tiles) {
  const int base = blockIdx.x * TILE + threadIdx.x * ITEMS;
  Elt mine = thread_aggregate(send, ser, link, base, m);
  Elt total;
  block_exclusive(mine, &total);
  if (threadIdx.x == 0) {
    agg[blockIdx.x] = total.s;
    agg[tiles + blockIdx.x] = total.a;
    agg[2 * tiles + blockIdx.x] = total.g;
  }
}

// One block: exclusive scan of the tile aggregates, TILE at a time,
// with the running total carried between chunks.
__global__ void scan_aggregates(const int32_t* __restrict__ agg,
                                int32_t* __restrict__ carry, int tiles) {
  Elt run = identity();
  for (int c0 = 0; c0 < tiles; c0 += TILE) {
    const int base = c0 + threadIdx.x * ITEMS;
    Elt items[ITEMS];
    Elt mine = identity();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int t = base + k;
      items[k] = t < tiles ? Elt{agg[t], agg[tiles + t], agg[2 * tiles + t]}
                           : identity();
      mine = combine(mine, items[k]);
    }
    Elt total;
    Elt ex = combine(run, block_exclusive(mine, &total));
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int t = base + k;
      if (t < tiles) {
        carry[t] = ex.s;
        carry[tiles + t] = ex.a;
        carry[2 * tiles + t] = ex.g;
      }
      ex = combine(ex, items[k]);
    }
    run = combine(run, total);
  }
}

__global__ void tile_output(const int32_t* __restrict__ send,
                            const int32_t* __restrict__ ser,
                            const int32_t* __restrict__ link,
                            const int32_t* __restrict__ lat,
                            const int32_t* __restrict__ carry,
                            int32_t* __restrict__ out, int m, int tiles,
                            int n_links) {
  const int base = blockIdx.x * TILE + threadIdx.x * ITEMS;
  Elt items[ITEMS];
  Elt mine = identity();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    items[k] = load_msg(send, ser, link, base + k, m);
    mine = combine(mine, items[k]);
  }
  Elt total;
  const Elt in = Elt{carry[blockIdx.x], carry[tiles + blockIdx.x],
                     carry[2 * tiles + blockIdx.x]};
  // the carry folds into every prefix that holds no segment start
  Elt run = combine(in, block_exclusive(mine, &total));
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = base + k;
    run = combine(run, items[k]);
    if (i < m) {
      const int l = link[i];
      assert(l >= 0 && l < n_links);
      out[i] = run.s + run.a + lat[l];
    }
  }
}

// scratch: 6 * tiles int32 (aggregates, then carries), tiles =
// ceil(m / TILE).  m >= 1; lat holds n_links entries.
extern "C" int hub_route_launch(const void* send, const void* ser,
                                const void* link, const void* lat, void* out,
                                void* scratch, int m, int n_links,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (m + TILE - 1) / TILE;
  int32_t* agg = (int32_t*)scratch;
  int32_t* carry = agg + 3 * (size_t)tiles;
  tile_aggregate<<<tiles, THREADS, 0, st>>>(
      (const int32_t*)send, (const int32_t*)ser, (const int32_t*)link, agg, m,
      tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_aggregates<<<1, THREADS, 0, st>>>(agg, carry, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_output<<<tiles, THREADS, 0, st>>>(
      (const int32_t*)send, (const int32_t*)ser, (const int32_t*)link,
      (const int32_t*)lat, carry, (int32_t*)out, m, tiles, n_links);
  return (int)cudaGetLastError();
}

// Tile size, so the caller can size the scratch buffer.
extern "C" int hub_route_tile() { return TILE; }
