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
// Design: a single-pass chained scan from the last chunk, every input in
// flight before any wait.  One block of WARPS = 8 warps per tile of
// TILE_W = 32 channels of one batch row and one chunk of CHUNK = 256 time
// steps (T_c); lane l of every warp owns channel w0 + l, and warp k owns
// the k-th sub-chunk of ceil(rows / WARPS) rows (32 in a full chunk).
//   1. Tiles come from an atomic ticket counter, last chunk first, so a
//      block's predecessor (the same tile, the chunk after) holds a lower
//      ticket: resident or done, and waiting on it cannot deadlock.
//   2. At block start each warp issues its sub-chunk's log_a and dh as
//      one commit group of asynchronous copies into shared memory, then
//      the rows of h_{t-1} (row t0 + r - 1 for row r; h0, or zeros, at
//      t = 0) as a second: 16-byte cp.async where W % 4 == 0 and the
//      pointers are 16-byte aligned, 4-byte ones otherwise, zeros past
//      W.  All three inputs are in flight before the block waits on
//      anything; h lands during the local pass and the chain's wait.
//   3. Local pass of each sub-chunk from its end once log_a and dh have
//      landed: g = fmaf(a_{t+1}, g, dh_t) from 0, giving the sub-chunk's
//      carry out B_k = a_{r0} g_{r0} and A_k = expf(LA_k), LA_k the
//      float32 sum of its log_a from its end; exp(log_a) is written over
//      log_a.
//   4. The carry, strictly chained through the chunks and composed in a
//      fixed order within one: warp 0 waits for P_{c+1} (the last chunk
//      takes 0), runs x = fmaf(A_k, x, B_k) from the last sub-chunk to
//      the first (x entering sub-chunk k is its entry carry), and
//      publishes P_c = x.  P goes as one 64-bit word a lane, its float
//      bits under a nonzero flag word, stored and polled relaxed at gpu
//      scope: the successor needs nothing but the word, so no fence, no
//      warp sync and no separate flag sit on a hop.  The association
//      never changes, so every call gives the same bits.
//   5. Output pass of each sub-chunk from its entry carry, from its end,
//      out of shared memory only: g = fmaf(a_{t+1}, g, dh_t), db = g,
//      dlog_a = g a_t h_{t-1}; each row's 32 stores are one coalesced
//      128-byte line.  Chunk 0's warp 0 ends with dh0 = a_0 g_0.
// Why warps and not a shorter chunk: three staged inputs take 384 bytes
// a time step, so T_c = 256 is 96 KB a block (two an SM) and T_c = 128
// 48 KB (four an SM, but twice the hops where the chain is the critical
// path).  Splitting a chunk over warps keeps the hops, cuts a block's
// serial passes by the warp count, and puts 16 warps on an SM.  A sweep
// of (T_c, warps) over (128, 1-4), (256, 1-8) and (512, 8-16) on an H100
// (PERF.md) put all of them within 7% of each other at recurrentgemma's
// train shape, T_c = 128 about 13% behind at B=1, S=16,384, W=1,024, and
// (256, 8) fastest or level at every shape timed: it is the one built.
// A wait that outlasts SPIN_LIMIT polls traps: a launch error, not a
// hang.  No atomics but the ticket.  Built without --use_fast_math.
//
// Workspace (reset here on the caller's stream each call): the ticket
// counter in the first 16 bytes, then one 64-bit word per (c - 1, tile,
// lane) that chunk c publishes for chunk c - 1, for every chunk but the
// first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define TILE_W 32             // channels per block: a lane each, in every warp
#define CHUNK 256             // time steps per chunk (T_c): hops of the chain
#define WARPS 8               // warps per block, a sub-chunk each
#define SMEM_BYTES ((3 * CHUNK + 3 * WARPS) * TILE_W * 4)
#define SPIN_LIMIT (1 << 26)

typedef unsigned long long u64;

// One asynchronous copy of a lane's 16 bytes (VEC) or 4 bytes; src_bytes
// 0 writes zeros.
template <bool VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src,
                                         int src_bytes) {
  if (VEC) {
    cp_async16(dst, src, src_bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

static int64_t carry_words(int bsz, int s, int w, int chunk) {
  const int64_t n_chunks = (s + chunk - 1) / chunk;
  const int64_t tiles = (int64_t)bsz * ((w + TILE_W - 1) / TILE_W);
  return (n_chunks - 1) * tiles * TILE_W;
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * TILE_W)
rglru_bwd_subchunk_kernel(const float* __restrict__ log_a,
                          const float* __restrict__ h,
                          const float* __restrict__ h0,
                          const float* __restrict__ dh,
                          float* __restrict__ dlog_a,
                          float* __restrict__ db, float* __restrict__ dh0,
                          int* __restrict__ ticket_counter,
                          u64* __restrict__ carry, int s, int w, int n_wt,
                          int per_chunk, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                    // [CHUNK][TILE_W]: log_a, then exp
  float* sd = sa + CHUNK * TILE_W;     // [CHUNK][TILE_W]: dh
  float* sh = sd + CHUNK * TILE_W;     // [CHUNK][TILE_W]: h_{t-1}
  float* s_ak = sh + CHUNK * TILE_W;   // [WARPS][TILE_W]: A_k
  float* s_bk = s_ak + WARPS * TILE_W; // [WARPS][TILE_W]: B_k
  float* s_ek = s_bk + WARPS * TILE_W; // [WARPS][TILE_W]: entry carries
  __shared__ int s_ticket;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket_counter, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int c = n_chunks - 1 - ticket / per_chunk;
  const int tile = ticket - (n_chunks - 1 - c) * per_chunk;
  const int bi = tile / n_wt;
  const int w0 = (tile - bi * n_wt) * TILE_W;
  const int t0 = c * CHUNK;
  const int rows = min(CHUNK, s - t0);
  const int sub = (rows + WARPS - 1) / WARPS;
  const int r0 = min(rows, wid * sub);
  const int r1 = min(rows, r0 + sub);
  const int64_t base = ((int64_t)bi * s + t0) * w + w0;  // (bi, t0, w0)

  // Stage the sub-chunk: log_a and dh, then h_{t-1}, each a commit group,
  // every copy issued before any wait.  VEC: 8 lanes a row, 4 channels a
  // lane, 4 rows a step (W % 4 == 0: a lane's 4 channels all or none).
  const int col = VEC ? (lane & 7) * 4 : lane;
  const int n = w0 + col < w ? (VEC ? 16 : 4) : 0;
  const int first = r0 + (VEC ? lane >> 3 : 0);
  const int step = VEC ? 4 : 1;
  for (int r = first; r < r1; r += step) {
    const int64_t off = n ? base + (int64_t)r * w + col : 0;
    cp_async<VEC>(smem_u32(sa + r * TILE_W + col), log_a + off, n);
    cp_async<VEC>(smem_u32(sd + r * TILE_W + col), dh + off, n);
  }
  cp_async_commit();
  for (int r = first; r < r1; r += step) {
    const float* src = h;  // zeros where bytes is 0
    int bytes = n;
    if (n && t0 + r > 0) {
      src = h + base + (int64_t)(r - 1) * w + col;
    } else if (n && h0 != nullptr) {
      src = h0 + (int64_t)bi * w + w0 + col;
    } else {
      bytes = 0;
    }
    cp_async<VEC>(smem_u32(sh + r * TILE_W + col), src, bytes);
  }
  cp_async_commit();

  // Local pass from the sub-chunk's end with a zero carry, once log_a and
  // dh have landed (h still pending).  Past W the copies wrote zeros:
  // dh = 0 keeps g at 0.
  cp_async_wait<1>();
  __syncwarp();  // the other lanes' 16-byte copies of these rows
  float g = 0.f, a_next = 0.f, la_sum = 0.f;
#pragma unroll 8
  for (int r = r1 - 1; r >= r0; --r) {
    const float la = sa[r * TILE_W + lane];
    const float a = expf(la);
    la_sum += la;
    g = fmaf(a_next, g, sd[r * TILE_W + lane]);
    a_next = a;
    sa[r * TILE_W + lane] = a;
  }
  s_ak[wid * TILE_W + lane] = expf(la_sum);  // 1 for an empty sub-chunk
  s_bk[wid * TILE_W + lane] = a_next * g;     // 0 for an empty one
  __syncthreads();

  // The carry: P_{c+1} in, through the sub-chunks last to first, P_c out.
  if (wid == 0) {
    float ak[WARPS], bk[WARPS], ek[WARPS];
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      ak[k] = s_ak[k * TILE_W + lane];
      bk[k] = s_bk[k * TILE_W + lane];
    }
    float x = 0.f;
    if (c + 1 < n_chunks) {
      const u64* word = carry + ((int64_t)c * per_chunk + tile) * TILE_W + lane;
      u64 v;
      int spins = 0;
      while (((v = ld_relaxed(word)) >> 32) == 0) {
        if (++spins > SPIN_LIMIT) __trap();
        __nanosleep(32);
      }
      x = __uint_as_float((unsigned)v);
    }
#pragma unroll
    for (int k = WARPS - 1; k >= 0; --k) {
      ek[k] = x;
      x = fmaf(ak[k], x, bk[k]);
    }
    if (c > 0)
      st_relaxed(carry + ((int64_t)(c - 1) * per_chunk + tile) * TILE_W + lane,
                 (1ull << 32) | __float_as_uint(x));
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s_ek[k * TILE_W + lane] = ek[k];
  }
  cp_async_wait<0>();
  __syncthreads();  // the entry carries, and every lane's rows of h

  // Output pass from the entry carry, from the sub-chunk's end.
  if (w0 + lane < w) {
    float* oa = dlog_a + base + lane;
    float* ob = db + base + lane;
    g = s_ek[wid * TILE_W + lane];
    a_next = 1.f;  // the first step adds dh to the entry carry
#pragma unroll 8
    for (int r = r1 - 1; r >= r0; --r) {
      const float a = sa[r * TILE_W + lane];
      g = fmaf(a_next, g, sd[r * TILE_W + lane]);
      ob[(int64_t)r * w] = g;
      oa[(int64_t)r * w] = g * a * sh[r * TILE_W + lane];
      a_next = a;
    }
    if (c == 0 && wid == 0 && dh0 != nullptr)
      dh0[(int64_t)bi * w + w0 + lane] = a_next * g;
  }
}

// Bytes of workspace a call needs (the wrapper allocates at least this).
extern "C" long long rglru_scan_bwd_workspace_bytes(int bsz, int s, int w,
                                                    int chunk) {
  if (bsz <= 0 || s <= 0 || w <= 0 || chunk <= 0) return 0;
  return 16 + 8 * carry_words(bsz, s, w, chunk);
}

template <bool VEC>
static int launch(const void* log_a, const void* h, const void* h0,
                  const void* dh, void* dlog_a, void* db, void* dh0, void* ws,
                  int bsz, int s, int w, cudaStream_t st) {
  const int n_wt = (w + TILE_W - 1) / TILE_W;
  const int64_t per_chunk = (int64_t)bsz * n_wt;
  const int64_t n_chunks = (s + CHUNK - 1) / CHUNK;
  if (per_chunk * n_chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      ws, 0, rglru_scan_bwd_workspace_bytes(bsz, s, w, CHUNK), st);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set = false;  // the opt-in, once per kernel
  if (!smem_set) {
    err = cudaFuncSetAttribute(rglru_bwd_subchunk_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rglru_bwd_subchunk_kernel<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  rglru_bwd_subchunk_kernel<VEC>
      <<<(unsigned)(per_chunk * n_chunks), WARPS * TILE_W, SMEM_BYTES, st>>>(
          (const float*)log_a, (const float*)h, (const float*)h0,
          (const float*)dh, (float*)dlog_a, (float*)db, (float*)dh0,
          (int*)ws, (u64*)((char*)ws + 16), s, w, n_wt, (int)per_chunk,
          (int)n_chunks);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// Returns 0 or a cudaError_t.  The caller checks dtypes and shapes; h0
// and dh0 may be null (no initial state, no gradient of it).  chunk is
// CHUNK and tile_w TILE_W (the wrapper's statement of the tiling), ws
// holds ws_bytes >= rglru_scan_bwd_workspace_bytes(...).
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* h,
                                     const void* h0, const void* dh,
                                     void* dlog_a, void* db, void* dh0,
                                     void* ws, long long ws_bytes, int bsz,
                                     int s, int w, int chunk, int tile_w,
                                     void* stream) {
  if (bsz < 0 || s < 0 || w < 0 || tile_w != TILE_W || chunk != CHUNK)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || s == 0 || w == 0) return 0;
  if (ws_bytes < rglru_scan_bwd_workspace_bytes(bsz, s, w, chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && aligned16(log_a) && aligned16(h) &&
                   aligned16(h0) && aligned16(dh);
  if (vec)
    return launch<true>(log_a, h, h0, dh, dlog_a, db, dh0, ws, bsz, s, w, st);
  return launch<false>(log_a, h, h0, dh, dlog_a, db, dh0, ws, bsz, s, w, st);
}
