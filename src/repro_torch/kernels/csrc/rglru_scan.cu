// RG-LRU linear recurrence for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (_kernel, wrapper rglru_scan).  For log_a, b (B, S, W) and h0 (B, W),
// all float32 and contiguous:
//   h[b, t, w] = exp(log_a[b, t, w]) * h[b, t-1, w] + b[b, t, w],
//   h[b, -1, w] = h0[b, w]  (0 where there is no h0).
//
// Bound on the H100: bytes.  The function reads log_a and b and writes h
// once, 12 bytes per element: at recurrentgemma's prefill shape (B=4,
// S=3,072, W=4,096) 604 MB, 0.180 ms at 3.35 TB/s, against 2 operations
// per element.  The only parallelism of a plain loop is B * W channels,
// too few threads with too few loads in flight to cover the memory
// latency; the design cuts S into chunks as well.
//
// Design: a single-pass chained scan over S.  One block of one warp per
// tile of TILE_W = 32 channels of one batch row and one chunk of `chunk`
// time steps (T_c); lane l owns channel w0 + l.
//   1. Tiles come from an atomic ticket counter, chunk-major, never from
//      blockIdx: a block's predecessor (the same tile, the chunk before)
//      holds a lower ticket, so it is resident or done, and waiting on it
//      cannot deadlock.
//   2. At block start the warp issues the whole tile's log_a and b
//      (T_c rows of 128 bytes each, W floats apart) as asynchronous
//      copies into shared memory: 16-byte cp.async where W % 4 == 0 and
//      both pointers are 16-byte aligned, 4-byte ones otherwise, in
//      commit groups of GROUP rows.  They are in flight before the block
//      waits on anything.
//   3. Local pass, each group as it lands: h from 0 over the chunk, keeping
//      its end value B_c and LA_c = sum of log_a (float32, in order);
//      exp(log_a) is written back over log_a for the output pass.
//   4. The carry, strictly chained: chunk c waits for chunk c-1's
//      inclusive prefix P_{c-1} (chunk 0 takes h0) and publishes
//      P_c = fmaf(expf(LA_c), P_{c-1}, B_c): each lane stores its P to
//      the workspace, the warp syncs, and lane 0 stores the flag with
//      st.release.gpu (a release fence, then the store; a second
//      __threadfence before it only lengthened each hop); every lane
//      polls the flag with ld.acquire.gpu, then reads P.  No look-back over
//      several predecessors: the association never changes, so every
//      call gives the same bits.
//   5. Output pass from P_{c-1}: h = fmaf(exp(log_a), h, b) row by row
//      from shared memory, the sequential loop's arithmetic given the
//      carry; each row's 32 stores are one coalesced 128-byte write.
// The chain has S / T_c hops of a flag through L2, off the output pass.
// T_c = 256 stages 64 KB a block (three blocks an SM); at the serving
// shape that is 12 hops and 12 x 4 x 128 = 6,144 blocks.  T_c was picked
// with tools/rglru_chunks.py (times in PERF.md): at the serving shape 128
// is a few percent faster than 256 and 64 is slower; at B=1, S=16,384,
// W=1,024, where the chain is the critical path, each halving of T_c
// doubles the hops and takes well over half again the time, so 256.
// W_t = 32 makes a warp's row one 128-byte line and
// gives each lane one channel in both passes.  A broken chain
// would spin forever, so a wait that outlasts SPIN_LIMIT polls traps: a
// launch error, not a hang.  Built without --use_fast_math: expf is the
// accurate one.
//
// Workspace (int32 then float32, allocated by the caller, the ints reset
// here on the caller's stream each call): [0] the ticket counter,
// [1 + (c * B + b) * n_wt + wt] the flag of chunk c's tile, then, from a
// 16-byte boundary, P of each (c, b, wt) as TILE_W floats, for every chunk
// but the last.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define TILE_W 32       // channels per block: one warp, one lane each
#define GROUP 32        // rows per cp.async commit group
#define MAX_CHUNK 256   // rows per chunk: 8 groups, 64 KB of shared memory
#define SPIN_LIMIT (1 << 26)

// 4 bytes from global to shared; zeros where src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Waits until at most n (< MAX_CHUNK / GROUP) of this thread's commit
// groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

static int64_t flag_ints(int bsz, int s, int w, int chunk) {
  const int64_t n_chunks = (s + chunk - 1) / chunk;
  const int64_t tiles = (int64_t)bsz * ((w + TILE_W - 1) / TILE_W);
  return 1 + (n_chunks - 1) * tiles;
}

template <bool VEC>
__global__ void __launch_bounds__(TILE_W)
rglru_chained_kernel(const float* __restrict__ log_a,
                     const float* __restrict__ b,
                     const float* __restrict__ h0, float* __restrict__ out,
                     int* __restrict__ sync, float* __restrict__ carry,
                     int s, int w, int chunk, int n_wt, int per_chunk,
                     int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                   // [chunk][TILE_W]: log_a, then exp
  float* sb = smem + chunk * TILE_W;  // [chunk][TILE_W]: b
  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(sync, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int c = ticket / per_chunk;
  const int tile = ticket - c * per_chunk;  // bi * n_wt + wt
  const int bi = tile / n_wt;
  const int w0 = (tile - bi * n_wt) * TILE_W;
  const int t0 = c * chunk;
  const int rows = min(chunk, s - t0);
  const int n_groups = (rows + GROUP - 1) / GROUP;
  const int64_t base = ((int64_t)bi * s + t0) * w + w0;  // (bi, t0, w0)

  // Stage the tile: every copy issued before any wait.
  for (int g = 0; g < n_groups; ++g) {
    const int r1 = min(rows, (g + 1) * GROUP);
    if (VEC) {  // 8 lanes a row, 4 channels a lane, 4 rows a step
      const int col = (lane & 7) * 4;
      const int n = w0 + col < w ? 16 : 0;  // W % 4 == 0: all or none
      for (int r = g * GROUP + (lane >> 3); r < r1; r += 4) {
        const int64_t off = n ? base + (int64_t)r * w + col : 0;
        cp_async16(smem_u32(sa + r * TILE_W + col), log_a + off, n);
        cp_async16(smem_u32(sb + r * TILE_W + col), b + off, n);
      }
    } else {
      const int n = w0 + lane < w ? 4 : 0;
      for (int r = g * GROUP; r < r1; ++r) {
        const int64_t off = n ? base + (int64_t)r * w + lane : 0;
        cp_async4(smem_u32(sa + r * TILE_W + lane), log_a + off, n);
        cp_async4(smem_u32(sb + r * TILE_W + lane), b + off, n);
      }
    }
    cp_async_commit();
  }

  // Local pass from 0, a group at a time as it lands.  Past W the copies
  // wrote zeros: log_a = 0, b = 0 keep h at 0.
  float hl = 0.f, la_sum = 0.f;
  for (int g = 0; g < n_groups; ++g) {
    cp_async_wait_upto(n_groups - 1 - g);
    __syncwarp();  // the other lanes' 16-byte copies of these rows
    const int r1 = min(rows, (g + 1) * GROUP);
#pragma unroll 8
    for (int r = g * GROUP; r < r1; ++r) {
      const float la = sa[r * TILE_W + lane];
      const float a = expf(la);
      la_sum += la;
      hl = fmaf(a, hl, sb[r * TILE_W + lane]);
      sa[r * TILE_W + lane] = a;
    }
  }

  // The carry: P_{c-1} in, P_c out.
  const bool valid = w0 + lane < w;
  float p = 0.f;
  if (c == 0) {
    if (h0 != nullptr && valid) p = h0[(int64_t)bi * w + w0 + lane];
  } else {
    const int* flag = sync + 1 + (c - 1) * per_chunk + tile;
    int spins = 0;
    while (ld_acquire(flag) == 0) {
      if (++spins > SPIN_LIMIT) __trap();
      __nanosleep(32);
    }
    p = __ldcg(carry + ((int64_t)(c - 1) * per_chunk + tile) * TILE_W + lane);
  }
  if (c + 1 < n_chunks) {
    __stcg(carry + ((int64_t)c * per_chunk + tile) * TILE_W + lane,
           fmaf(expf(la_sum), p, hl));
    __syncwarp();  // every lane's P before lane 0's release
    if (lane == 0) st_release(sync + 1 + c * per_chunk + tile, 1);
  }

  // Output pass from the carry.
  if (valid) {
    float* o = out + base + lane;
    float h = p;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      h = fmaf(sa[r * TILE_W + lane], h, sb[r * TILE_W + lane]);
      o[(int64_t)r * w] = h;
    }
  }
}

// Bytes of workspace a call needs (the wrapper allocates at least this).
extern "C" long long rglru_scan_workspace_bytes(int bsz, int s, int w,
                                                int chunk) {
  if (bsz <= 0 || s <= 0 || w <= 0 || chunk <= 0) return 0;
  const int64_t flags = flag_ints(bsz, s, w, chunk);
  return 4 * (((flags + 3) & ~(int64_t)3) + (flags - 1) * TILE_W);
}

template <bool VEC>
static int launch(const void* log_a, const void* b, const void* h0, void* out,
                  void* ws, int bsz, int s, int w, int chunk,
                  cudaStream_t st) {
  const int n_wt = (w + TILE_W - 1) / TILE_W;
  const int64_t per_chunk = (int64_t)bsz * n_wt;
  const int64_t n_chunks = (s + chunk - 1) / chunk;
  if (per_chunk * n_chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int64_t flags = flag_ints(bsz, s, w, chunk);
  cudaError_t err = cudaMemsetAsync(ws, 0, 4 * flags, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)chunk * TILE_W * 2 * sizeof(float);
  static size_t smem_set = 48 * 1024;  // the opt-in so far, per path
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(rglru_chained_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rglru_chained_kernel<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int* sync = (int*)ws;
  float* carry = (float*)(sync + ((flags + 3) & ~(int64_t)3));
  rglru_chained_kernel<VEC><<<(unsigned)(per_chunk * n_chunks), TILE_W, smem,
                              st>>>(
      (const float*)log_a, (const float*)b, (const float*)h0, (float*)out,
      sync, carry, s, w, chunk, n_wt, (int)per_chunk, (int)n_chunks);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t.  The caller checks dtypes and shapes; h0 may
// be null (zeros).  chunk is a multiple of GROUP up to MAX_CHUNK, tile_w is
// TILE_W, ws holds ws_bytes >= rglru_scan_workspace_bytes(...).
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* out, void* ws,
                                 long long ws_bytes, int bsz, int s, int w,
                                 int chunk, int tile_w, void* stream) {
  if (bsz < 0 || s < 0 || w < 0 || tile_w != TILE_W || chunk <= 0 ||
      chunk % GROUP != 0 || chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || s == 0 || w == 0) return 0;
  if (ws_bytes < rglru_scan_workspace_bytes(bsz, s, w, chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && ((uintptr_t)log_a & 15) == 0 &&
                   ((uintptr_t)b & 15) == 0;
  if (vec) return launch<true>(log_a, b, h0, out, ws, bsz, s, w, chunk, st);
  return launch<false>(log_a, b, h0, out, ws, bsz, s, w, chunk, st);
}
