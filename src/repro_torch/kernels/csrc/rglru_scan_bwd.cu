// The gradient of the RG-LRU linear recurrence for Hopper (sm_90a),
// float32.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp
// recurrence (src/repro/models/rglru.py rglru_scan, an associative scan)
// and has no backward Pallas kernel.  This is the gradient of the
// forward kernel csrc/rglru_scan.cu, which replaces
// src/repro/kernels/rglru_scan.py (wrapper rglru_scan).  For the forward
// h_t = a_t h_{t-1} + b_t (a = exp(log_a), h_{-1} = h0 or 0), given its
// output h and dh, all (B, S, W) float32 and contiguous:
//   g_t = dh_t + a_{t+1} g_{t+1}      (g_{S-1} = dh_{S-1}),
//   db_t = g_t,  dlog_a_t = g_t a_t h_{t-1},  dh0 = a_0 g_0.
//
// Bound on the H100: bytes.  log_a, h and dh read, db and dlog_a written,
// 20 bytes per element: at recurrentgemma's train shape (B=4, S=1,024,
// W=4,096) 335.5 MB, 0.100 ms at 3.35 TB/s, against 5 operations per
// element.
//
// Design: the forward's single-pass chained scan run from the last
// chunk.  One block of one warp per tile of TILE_W = 32 channels of one
// batch row and one chunk of `chunk` time steps; lane l owns channel
// w0 + l.
//   1. Tiles come from an atomic ticket counter, last chunk first, so a
//      block's predecessor (the same tile, the chunk after) holds a lower
//      ticket: resident or done, and waiting on it cannot deadlock.
//   2. At block start the warp issues the tile's log_a and dh as
//      asynchronous copies into shared memory, the last commit group of
//      rows first.
//   3. Local pass from the chunk's end, each group as it lands: the carry
//      from 0, g = carry + dh, carry = a g, keeping the end value B_c =
//      a_{t0} g_{t0} and LA_c = sum of log_a (float32, in order); exp(log_a)
//      is written back over log_a.
//   4. The carry, strictly chained: chunk c waits for chunk c+1's P_{c+1}
//      (the last chunk takes 0: no a_{t+1} past the end) and publishes
//      P_c = fmaf(expf(LA_c), P_{c+1}, B_c) through a flag (st.release /
//      ld.acquire, as the forward).  The association never changes, so
//      every call gives the same bits.
//   5. Output pass from P_{c+1}, row by row from the chunk's end: g =
//      carry + dh, db = g, dlog_a = g a h_{t-1} with h_{t-1} read from the
//      saved output (row t0 - 1 of the chunk before, h0 or 0 at t = 0),
//      carry = a g; chunk 0's last carry is dh0.  Each row's 32 loads and
//      stores are coalesced 128-byte lines.
// A wait that outlasts SPIN_LIMIT polls traps: a launch error, not a
// hang.  Built without --use_fast_math.
//
// Workspace (as csrc/rglru_scan.cu; the ints reset here on the caller's
// stream each call): [0] the ticket counter, [1 + (c - 1) * tiles + tile]
// the flag chunk c publishes for chunk c - 1, then, from a 16-byte
// boundary, P of each (c - 1, tile) as TILE_W floats, for every chunk
// but the first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define TILE_W 32       // channels per block: one warp, one lane each
#define GROUP 32        // rows per cp.async commit group
#define MAX_CHUNK 256   // rows per chunk: 8 groups, 64 KB of shared memory
#define SPIN_LIMIT (1 << 26)

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

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
rglru_bwd_chained_kernel(const float* __restrict__ log_a,
                         const float* __restrict__ h,
                         const float* __restrict__ h0,
                         const float* __restrict__ dh,
                         float* __restrict__ dlog_a, float* __restrict__ db,
                         float* __restrict__ dh0, int* __restrict__ sync,
                         float* __restrict__ carry, int s, int w, int chunk,
                         int n_wt, int per_chunk, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                   // [chunk][TILE_W]: log_a, then exp
  float* sd = smem + chunk * TILE_W;  // [chunk][TILE_W]: dh
  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(sync, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int c = n_chunks - 1 - ticket / per_chunk;
  const int tile = ticket - (n_chunks - 1 - c) * per_chunk;
  const int bi = tile / n_wt;
  const int w0 = (tile - bi * n_wt) * TILE_W;
  const int t0 = c * chunk;
  const int rows = min(chunk, s - t0);
  const int n_groups = (rows + GROUP - 1) / GROUP;
  const int64_t base = ((int64_t)bi * s + t0) * w + w0;  // (bi, t0, w0)

  // Stage the tile, the last group first: every copy issued before any
  // wait.
  for (int k = 0; k < n_groups; ++k) {
    const int g = n_groups - 1 - k;
    const int r1 = min(rows, (g + 1) * GROUP);
    if (VEC) {  // 8 lanes a row, 4 channels a lane, 4 rows a step
      const int col = (lane & 7) * 4;
      const int n = w0 + col < w ? 16 : 0;  // W % 4 == 0: all or none
      for (int r = g * GROUP + (lane >> 3); r < r1; r += 4) {
        const int64_t off = n ? base + (int64_t)r * w + col : 0;
        cp_async16(smem_u32(sa + r * TILE_W + col), log_a + off, n);
        cp_async16(smem_u32(sd + r * TILE_W + col), dh + off, n);
      }
    } else {
      const int n = w0 + lane < w ? 4 : 0;
      for (int r = g * GROUP; r < r1; ++r) {
        const int64_t off = n ? base + (int64_t)r * w + lane : 0;
        cp_async4(smem_u32(sa + r * TILE_W + lane), log_a + off, n);
        cp_async4(smem_u32(sd + r * TILE_W + lane), dh + off, n);
      }
    }
    cp_async_commit();
  }

  // Local pass from the chunk's end with a zero carry, a group at a time
  // as it lands.  Past W the copies wrote zeros: dh = 0 keeps g at 0.
  float cl = 0.f, la_sum = 0.f;
  for (int k = 0; k < n_groups; ++k) {
    const int g = n_groups - 1 - k;
    cp_async_wait_upto(n_groups - 1 - k);
    __syncwarp();  // the other lanes' 16-byte copies of these rows
    const int r1 = min(rows, (g + 1) * GROUP);
#pragma unroll 8
    for (int r = r1 - 1; r >= g * GROUP; --r) {
      const float la = sa[r * TILE_W + lane];
      const float a = expf(la);
      la_sum += la;
      cl = a * (cl + sd[r * TILE_W + lane]);
      sa[r * TILE_W + lane] = a;
    }
  }

  // The carry: P_{c+1} in, P_c out.
  const bool valid = w0 + lane < w;
  float p = 0.f;
  if (c + 1 < n_chunks) {
    const int* flag = sync + 1 + c * per_chunk + tile;
    int spins = 0;
    while (ld_acquire(flag) == 0) {
      if (++spins > SPIN_LIMIT) __trap();
      __nanosleep(32);
    }
    p = __ldcg(carry + ((int64_t)c * per_chunk + tile) * TILE_W + lane);
  }
  if (c > 0) {
    __stcg(carry + ((int64_t)(c - 1) * per_chunk + tile) * TILE_W + lane,
           fmaf(expf(la_sum), p, cl));
    __syncwarp();  // every lane's P before lane 0's release
    if (lane == 0) st_release(sync + 1 + (c - 1) * per_chunk + tile, 1);
  }

  // Output pass from the carry, from the chunk's end.
  if (valid) {
    const float* hp = h + base + lane - w;  // row r - 1 of the tile
    float* oa = dlog_a + base + lane;
    float* ob = db + base + lane;
    const float first =
        c > 0 ? hp[0] : (h0 != nullptr ? h0[(int64_t)bi * w + w0 + lane]
                                       : 0.f);
    float cr = p;
#pragma unroll 8
    for (int r = rows - 1; r >= 0; --r) {
      const float a = sa[r * TILE_W + lane];
      const float g = cr + sd[r * TILE_W + lane];
      const float prev = r > 0 ? hp[(int64_t)r * w] : first;
      ob[(int64_t)r * w] = g;
      oa[(int64_t)r * w] = g * a * prev;
      cr = a * g;
    }
    if (c == 0 && dh0 != nullptr) dh0[(int64_t)bi * w + w0 + lane] = cr;
  }
}

// Bytes of workspace a call needs (the wrapper allocates at least this).
extern "C" long long rglru_scan_bwd_workspace_bytes(int bsz, int s, int w,
                                                    int chunk) {
  if (bsz <= 0 || s <= 0 || w <= 0 || chunk <= 0) return 0;
  const int64_t flags = flag_ints(bsz, s, w, chunk);
  return 4 * (((flags + 3) & ~(int64_t)3) + (flags - 1) * TILE_W);
}

template <bool VEC>
static int launch(const void* log_a, const void* h, const void* h0,
                  const void* dh, void* dlog_a, void* db, void* dh0, void* ws,
                  int bsz, int s, int w, int chunk, cudaStream_t st) {
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
    err = cudaFuncSetAttribute(rglru_bwd_chained_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rglru_bwd_chained_kernel<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int* sync = (int*)ws;
  float* carry = (float*)(sync + ((flags + 3) & ~(int64_t)3));
  rglru_bwd_chained_kernel<VEC><<<(unsigned)(per_chunk * n_chunks), TILE_W,
                                  smem, st>>>(
      (const float*)log_a, (const float*)h, (const float*)h0,
      (const float*)dh, (float*)dlog_a, (float*)db, (float*)dh0, sync, carry,
      s, w, chunk, n_wt, (int)per_chunk, (int)n_chunks);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t.  The caller checks dtypes and shapes; h0
// and dh0 may be null (no initial state, no gradient of it).  chunk is a
// multiple of GROUP up to MAX_CHUNK, tile_w is TILE_W, ws holds ws_bytes
// >= rglru_scan_bwd_workspace_bytes(...).
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* h,
                                     const void* h0, const void* dh,
                                     void* dlog_a, void* db, void* dh0,
                                     void* ws, long long ws_bytes, int bsz,
                                     int s, int w, int chunk, int tile_w,
                                     void* stream) {
  if (bsz < 0 || s < 0 || w < 0 || tile_w != TILE_W || chunk <= 0 ||
      chunk % GROUP != 0 || chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || s == 0 || w == 0) return 0;
  if (ws_bytes < rglru_scan_bwd_workspace_bytes(bsz, s, w, chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && ((uintptr_t)log_a & 15) == 0 &&
                   ((uintptr_t)dh & 15) == 0;
  if (vec)
    return launch<true>(log_a, h, h0, dh, dlog_a, db, dh0, ws, bsz, s, w,
                        chunk, st);
  return launch<false>(log_a, h, h0, dh, dlog_a, db, dh0, ws, bsz, s, w,
                       chunk, st);
}
