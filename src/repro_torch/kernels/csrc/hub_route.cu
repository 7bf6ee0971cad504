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
// Bound on the H100: bytes, about 16 B a message (send, ser, link read,
// out written) plus the latency table: 1.05 MB at the main path's
// M = 65,600, 0.3 us at 3.35 TB/s, so a launch costs more than the work.
// ITEMS = 4 (TILE = 1,024) was picked with tools/engine_kernels.py
// against 8 and 16 at the main path's M (times in PERF.md).
//
// Design: one launch a call, a single-pass scan with decoupled look-back
// (Merrill and Garland).  One block of THREADS threads per tile of TILE
// messages:
//   1. The tile index comes from an atomic ticket, not from blockIdx, so
//      a tile's predecessors were all taken by blocks that started
//      earlier: they are resident or done, and waiting on them cannot
//      deadlock.  The block loads tile blockIdx while its ticket is in
//      flight (the usual case) and loads again where they differ.
//   2. The block scans its tile on chip: ITEMS consecutive messages a
//      thread in registers (16-byte loads where the pointers allow),
//      __shfl_up_sync across a warp, warp totals in shared memory.
//   3. It publishes the tile's aggregate with status AGG, or at once its
//      inclusive prefix with status INC where it needs none from its
//      predecessors: tile 0, or an aggregate with G set (a segment start
//      makes everything before it irrelevant).
//   4. Warp 0 looks back over the predecessors 32 at a time, lane l on
//      tile T - 1 - l, each lane waiting for its tile's flag; the window
//      stops at the nearest tile that has published INC or whose
//      aggregate has G set, and its elements fold in order by a
//      shuffle-down suffix scan.  A tile whose first message starts a
//      segment needs no prefix and skips the look-back.
//   5. Thread 0 publishes the inclusive prefix (INC), and every thread
//      folds the prefix into its elements and writes S + A + lat[link].
// Payloads are written (st.cg) before their flag; the flag is stored
// with st.release.gpu and read with ld.acquire.gpu, and its payload is
// read after it through L2 (ld.cg).  A wait past SPIN_LIMIT polls traps:
// a CUDA error, not a hung card.
//
// Scratch (the caller's, persistent, zero-filled once when allocated,
// for a capacity of `cap` tiles): a header {ticket, done, epoch}, then
// cap 64-bit flags (epoch << 3 | G << 2 | status), then cap AGG and cap
// INC (S, A) payloads.
// Flags carry the call's epoch, so a flag left by an earlier call (of
// any size) never matches; the epoch lives on the device and the last
// block to finish advances it and resets the ticket and done counters,
// so a call is one device operation, no memset.  Calls on one stream are
// ordered, so each finds the counters reset; the caller keeps one
// scratch per (device, stream) and never shares it between streams.
// The 61-bit epoch does not wrap.
//
// A link id outside the latency table trips a device-side assert, which
// surfaces as a CUDA error at the caller's next synchronisation (as
// PyTorch's own indexing kernels do), so the launch itself never waits
// on the device.  Built without --use_fast_math; the kernel does
// integer work only.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_TICKS (-(1 << 30))
#define THREADS 256
#ifndef ITEMS
#define ITEMS 4  // a multiple of 4 (tools/engine_kernels.py builds others)
#endif
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)
#define SPIN_LIMIT (1 << 26)
#define ST_AGG 1ull
#define ST_INC 2ull
#define HEADER_BYTES 16  // ticket u32, done u32, epoch u64

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

__device__ __forceinline__ Elt shfl_up(Elt x, int d) {
  Elt o;
  o.s = __shfl_up_sync(0xffffffffu, x.s, d);
  o.a = __shfl_up_sync(0xffffffffu, x.a, d);
  o.g = __shfl_up_sync(0xffffffffu, x.g, d);
  return o;
}

__device__ __forceinline__ Elt shfl_down(Elt x, int d) {
  Elt o;
  o.s = __shfl_down_sync(0xffffffffu, x.s, d);
  o.a = __shfl_down_sync(0xffffffffu, x.a, d);
  o.g = __shfl_down_sync(0xffffffffu, x.g, d);
  return o;
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
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
    const Elt o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  Elt lane_ex = shfl_up(inc, 1);
  if (lane == 0) lane_ex = identity();
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    Elt t = lane < WARPS ? warp_tot[lane] : identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Elt o = shfl_up(t, d);
      if (lane >= d) t = combine(o, t);
    }
    if (lane < WARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  const Elt warp_ex = w > 0 ? warp_tot[w - 1] : identity();
  *total = warp_tot[WARPS - 1];
  return combine(warp_ex, lane_ex);
}

// The exclusive prefix of tile `tile` (> 0), by warp 0: windows of 32
// predecessors, nearest first, until a tile with INC or with G.
__device__ Elt look_back(const uint64_t* flags, const int2* agg,
                         const int2* inc, int tile, uint64_t epoch) {
  const int lane = threadIdx.x & 31;
  Elt acc = identity();  // the predecessors folded so far (the later ones)
  for (int j0 = tile - 1;; j0 -= 32) {
    const int j = j0 - lane;
    Elt e = identity();
    bool stop = false;
    if (j >= 0) {
      uint64_t f;
      int spins = 0;
      while (((f = ld_acquire(flags + j)) & 3ull) == 0 || (f >> 3) != epoch) {
        if (++spins > SPIN_LIMIT) __trap();
        if (spins > 16) __nanosleep(32);
      }
      const bool is_inc = (f & 3ull) == ST_INC;
      const int2 p = __ldcg(is_inc ? inc + j : agg + j);
      e = Elt{p.x, p.y, (int)((f >> 2) & 1ull)};
      stop = is_inc || e.g;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, stop);
    const int last = mask ? __ffs(mask) - 1 : 31;  // the earliest lane used
    if (lane > last) e = identity();
    // suffix scan toward lane 0: lane 0 ends with lanes last..0 in order
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Elt o = shfl_down(e, d);
      if (lane + d < 32) e = combine(o, e);
    }
    Elt window;
    window.s = __shfl_sync(0xffffffffu, e.s, 0);
    window.a = __shfl_sync(0xffffffffu, e.a, 0);
    window.g = __shfl_sync(0xffffffffu, e.g, 0);
    acc = combine(window, acc);
    if (mask) return acc;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_items(const int32_t* send,
                                           const int32_t* ser,
                                           const int32_t* link, int base,
                                           int m, Elt (&items)[ITEMS],
                                           int (&lk)[ITEMS]) {
  if (VEC && base + ITEMS <= m) {
    int prev = base > 0 ? link[base - 1] : -1;
#pragma unroll
    for (int q = 0; q < ITEMS; q += 4) {
      const int4 s4 = *reinterpret_cast<const int4*>(send + base + q);
      const int4 a4 = *reinterpret_cast<const int4*>(ser + base + q);
      const int4 l4 = *reinterpret_cast<const int4*>(link + base + q);
      const int ss[4] = {s4.x, s4.y, s4.z, s4.w};
      const int aa[4] = {a4.x, a4.y, a4.z, a4.w};
      const int ll[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lk[q + k] = ll[k];
        items[q + k] = Elt{ss[k], aa[k],
                           (base + q + k == 0 || ll[k] != prev) ? 1 : 0};
        prev = ll[k];
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = base + k;
    if (i < m) {
      lk[k] = link[i];
      items[k] = Elt{send[i], ser[i], (i == 0 || lk[k] != link[i - 1]) ? 1 : 0};
    } else {
      lk[k] = 0;
      items[k] = identity();
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hub_lookback_kernel(const int32_t* __restrict__ send,
                    const int32_t* __restrict__ ser,
                    const int32_t* __restrict__ link,
                    const int32_t* __restrict__ lat,
                    int32_t* __restrict__ out, unsigned char* scratch, int m,
                    int n_links, int cap) {
  __shared__ int tile_s;
  __shared__ Elt prefix_s;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned* done = ticket + 1;
  uint64_t* epoch_p = reinterpret_cast<uint64_t*>(scratch + 8);
  const int tiles = gridDim.x;
  // a fixed layout for the scratch's capacity, whatever this call's size:
  // a flag slot never lies where an earlier call wrote a payload
  uint64_t* flags = reinterpret_cast<uint64_t*>(scratch + HEADER_BYTES);
  int2* agg = reinterpret_cast<int2*>(flags + cap);
  int2* inc = agg + cap;

  // Blocks mostly take tickets in blockIdx order: the messages of tile
  // blockIdx are loaded while the ticket is in flight, and loaded again
  // where the ticket names another tile.
  Elt items[ITEMS];
  int lk[ITEMS];
  int base = blockIdx.x * TILE + threadIdx.x * ITEMS;
  load_items<VEC>(send, ser, link, base, m, items, lk);
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = tile_s;
  if (tile != (int)blockIdx.x) {
    base = tile * TILE + threadIdx.x * ITEMS;
    load_items<VEC>(send, ser, link, base, m, items, lk);
  }
  // the latency gather, in flight during the scan
  int32_t lv[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    lv[k] = 0;
    if (base + k < m) {
      assert(lk[k] >= 0 && lk[k] < n_links);
      lv[k] = lat[lk[k]];
    }
  }
  // read before this block counts itself done, so before the last block
  // advances it
  const uint64_t epoch = *reinterpret_cast<volatile uint64_t*>(epoch_p);

  Elt mine = identity();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) mine = combine(mine, items[k]);
  Elt total;
  const Elt ex = block_exclusive(mine, &total);

  // publish: INC at once where no prefix can change it, else AGG
  const bool early = tile == 0 || total.g;
  if (threadIdx.x == 0) {
    const uint64_t tag = (epoch << 3) | ((uint64_t)(total.g & 1) << 2);
    if (early) {
      __stcg(inc + tile, make_int2(total.s, total.a));
      st_release(flags + tile, tag | ST_INC);
    } else {
      __stcg(agg + tile, make_int2(total.s, total.a));
      st_release(flags + tile, tag | ST_AGG);
    }
  }
  // the tile's first message starts a segment (thread 0's first item)
  // when no prefix can reach any of its elements
  if (threadIdx.x < 32) {
    const int first_g = __shfl_sync(0xffffffffu, items[0].g, 0);
    Elt prefix = identity();
    if (tile > 0 && !first_g)
      prefix = look_back(flags, agg, inc, tile, epoch);
    if (threadIdx.x == 0) {
      prefix_s = prefix;
      if (!early) {
        const Elt p = combine(prefix, total);
        __stcg(inc + tile, make_int2(p.s, p.a));
        st_release(flags + tile,
                   (epoch << 3) | ((uint64_t)(p.g & 1) << 2) | ST_INC);
      }
    }
  }
  __syncthreads();

  Elt run = combine(prefix_s, ex);
  int32_t o[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    run = combine(run, items[k]);
    o[k] = run.s + run.a + lv[k];
  }
  if (VEC && base + ITEMS <= m) {
#pragma unroll
    for (int q = 0; q < ITEMS; q += 4)
      *reinterpret_cast<int4*>(out + base + q) =
          make_int4(o[q], o[q + 1], o[q + 2], o[q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (base + k < m) out[base + k] = o[k];
  }

  // the last block to finish resets the counters and advances the epoch
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(done, 1u) == (unsigned)(tiles - 1)) {
      *ticket = 0;
      *done = 0;
      *epoch_p = epoch + 1;
    }
  }
}

// Scratch bytes for a capacity of `cap` tiles (the caller allocates
// this, zero-filled, and keeps it).
extern "C" long long hub_route_scratch_bytes(int cap) {
  return HEADER_BYTES + (long long)cap * (8 + 8 + 8);
}

// m >= 1; lat holds n_links entries; scratch is
// hub_route_scratch_bytes(cap) bytes with cap >= ceil(m / TILE).
extern "C" int hub_route_launch(const void* send, const void* ser,
                                const void* link, const void* lat, void* out,
                                void* scratch, int m, int n_links, int cap,
                                void* stream) {
  const int tiles = (m + TILE - 1) / TILE;
  if (m < 1 || tiles > cap) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = ((uintptr_t)send | (uintptr_t)ser | (uintptr_t)link |
                    (uintptr_t)out) % 16 == 0;
  if (vec)
    hub_lookback_kernel<true><<<tiles, THREADS, 0, st>>>(
        (const int32_t*)send, (const int32_t*)ser, (const int32_t*)link,
        (const int32_t*)lat, (int32_t*)out, (unsigned char*)scratch, m,
        n_links, cap);
  else
    hub_lookback_kernel<false><<<tiles, THREADS, 0, st>>>(
        (const int32_t*)send, (const int32_t*)ser, (const int32_t*)link,
        (const int32_t*)lat, (int32_t*)out, (unsigned char*)scratch, m,
        n_links, cap);
  return (int)cudaGetLastError();
}

// Messages per tile, so the caller can size the scratch.
extern "C" int hub_route_tile() { return TILE; }
