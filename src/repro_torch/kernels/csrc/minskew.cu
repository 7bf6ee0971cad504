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
// contiguous.  The kernel writes both outputs whole.
//
// Bound on the H100: bytes (N*S membership bytes, 5 N + 8 S more, one
// compare per byte); at the main path's N = 16,384 and S = 1 that is
// 115 KB, 0.03 us at 3.35 TB/s, so a call is bound by the launch and
// by the two dependent passes: eligibility needs every row's minimum.
//
// Design: one launch a call, one thread block cluster per variant.
// The grid is R x V blocks of THREADS threads, clusters of R along x
// (R from 1 to 16, chosen by the caller from N*S); block `rank` of
// variant v owns the slab of rows [rank * slab_rows, + slab_rows).
// Scopes go in chunks of at most CHUNK_S (one chunk for S <= CHUNK_S),
// and for each chunk:
//   1. Pass 1: partial minima over the slab's runnable members.
//      Membership is read along S, W bytes a thread: 16-byte loads
//      (W = 16) where S % 16 == 0 and the pointer is 16-byte aligned,
//      single bytes (W = 1) otherwise.  tpr threads share a row (tpr =
//      ng = S / W rounded up to a power of two, at most THREADS), so rows
//      are read whole and coalesced, BATCH rows a thread loaded before
//      any is used: the passes are latency-bound, a slab being a few
//      steps of the block's threads.  W = 16 works on the member scopes
//      only (a vtask belongs to one or two): a 16-bit mask of the
//      nonzero bytes (__vcmpne4) and one shared atomicMin per member.
//      W = 1 keeps a column's running minimum in a register, folds the
//      lanes that share the column with shuffles, and does one
//      atomicMin per lane group.  The first kept_rows rows of the slab
//      (as many as fit in SLAB_MAX bytes: the whole slab at the engine's
//      shapes) stay in shared memory for pass 2.
//   2. Cluster barrier; then a thread a column reads every rank's
//      `part` through distributed shared memory (mapa +
//      ld.shared::cluster, the loads of all ranks in flight at once) and
//      folds them: an int32 min does not depend on order, so every block
//      ends with the same minima, and every call with the same bits.
//      thr[j] = minima[j] + skew[j] (INT_MAX where minima[j] is INF, so
//      the scope constrains nothing); rank 0 writes `minima`.  Then an
//      arrive on the cluster barrier: this block is done reading remote
//      shared memory.
//   3. Pass 2: each block's own rows, g2 = min(ng, 32) lanes a row
//      (one warp a row for S > 32 W, 32 rows a warp for S = 1), kept
//      rows from shared memory and the rest again from L2; t > thr[j]
//      is tested for the member scopes j only, the conjunction is a
//      shuffle-AND over the row's lanes, and elig = runnable AND ok
//      (later chunks AND into it).
//   4. The wait on that barrier: no block leaves, or overwrites `part`
//      for the next chunk, while another may still read it.
// minima + skew stays within int32 (at most 2^30 + 2^30 - 1); the sum is
// taken unsigned so that it wraps as the plain version's does regardless.
// V, N or S of 0 never reach the kernel (the wrapper answers them).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF_TICKS (1 << 30)
#ifndef THREADS
#define THREADS 1024  // tools/engine_kernels.py builds others
#endif
#define WARPS (THREADS / 32)
#define MAX_CLUSTER 16
#define CHUNK_S 2048             // scopes per chunk held on chip
#define SLAB_MAX (192 * 1024)    // membership bytes a block may keep
#ifndef BATCH
#define BATCH 2  // rows a thread has in flight at once
#endif

// -- cluster primitives ---------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// p's int32 in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ int32_t ld_cluster(const int32_t* p,
                                              uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  int32_t v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// -- W membership bytes as 32-bit words -----------------------------------------

template <int W>
struct Group {
  uint32_t w[(W + 3) / 4];
  __device__ __forceinline__ bool on(int k) const {
    return ((w[k >> 2] >> ((k & 3) * 8)) & 0xffu) != 0;
  }
};

template <int W>
__device__ __forceinline__ Group<W> load_group(const int8_t* p) {
  Group<W> g;
  if constexpr (W == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    g.w[0] = u.x; g.w[1] = u.y; g.w[2] = u.z; g.w[3] = u.w;
  } else {
    g.w[0] = static_cast<uint8_t>(*p);
  }
  return g;
}

template <int W>
__device__ __forceinline__ void store_group(int8_t* p, const Group<W>& g) {
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(g.w[0], g.w[1], g.w[2], g.w[3]);
  } else {
    *p = static_cast<int8_t>(g.w[0]);
  }
}

__host__ __device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Bytes of dynamic shared memory a block uses: part and thr (chunk
// width rounded up to 4 ints each), then the kept rows of the slab.
static size_t smem_bytes(int s, int kept_rows) {
  const int cs = s < CHUNK_S ? s : CHUNK_S;
  const size_t pad = (size_t)((cs + 3) & ~3);
  return 8 * pad + (size_t)kept_rows * cs;
}

// Bit k set where byte k of the 16 is nonzero.
__device__ __forceinline__ uint32_t on_mask(const Group<16>& g) {
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // 0xff per nonzero byte; bits 7, 15, 23, 31 gathered into 28..31
    const uint32_t c = __vcmpne4(g.w[q], 0u) & 0x80808080u;
    m |= ((c * 0x00204081u) >> 28) << (4 * q);
  }
  return m;
}

// Pass 2 over rows [lo, hi): g2 lanes a row, rpw rows a warp, BATCH
// steps of the warps' rows loaded before any is used; `rows` is the
// chunk's membership of row lo (stride `stride`), in shared memory or in
// device memory (inlined at each call, so the loads are of that space).
template <int W>
__device__ __forceinline__ void elig_rows(
    int lo, int hi, const int8_t* rows, size_t stride, const int32_t* vt,
    const int8_t* run, const int32_t* thr, int32_t th0,
    int8_t* elig, int ng, int g2, bool one, bool first_chunk) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpw = 32 / g2;
  const int gr = lane / g2;
  const int gl = lane - gr * g2;
  const int step = WARPS * rpw;
  for (int base = lo + warp * rpw; base < hi; base += BATCH * step) {
    Group<W> g[BATCH];
    int32_t t[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = base + u * step + gr;
      t[u] = 0;
#pragma unroll
      for (int q = 0; q < (W + 3) / 4; ++q) g[u].w[q] = 0;
      if (r < hi) {
        t[u] = vt[r];
        if (one && gl < ng)
          g[u] = load_group<W>(rows + (size_t)(r - lo) * stride + gl * W);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = base + u * step + gr;
      int ok = 1;
      if (r < hi) {
        const int8_t* row = rows + (size_t)(r - lo) * stride;
        for (int cg = gl; cg < ng; cg += g2) {
          const Group<W> gg = one ? g[u] : load_group<W>(row + cg * W);
          if constexpr (W == 16) {  // sparse: only the member scopes
            for (uint32_t m = on_mask(gg); m; m &= m - 1)
              if (t[u] > thr[cg * W + __ffs(m) - 1]) ok = 0;
          } else {
            if (gg.on(0) && t[u] > (one ? th0 : thr[cg])) ok = 0;
          }
          if (one) break;
        }
      }
      for (int off = 1; off < g2; off <<= 1)
        ok &= __shfl_xor_sync(0xffffffffu, ok, off);
      if (r < hi && gl == 0) {
        const bool prev = first_chunk ? run[r] != 0 : elig[r] != 0;
        elig[r] = (prev && ok) ? 1 : 0;
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
minskew_cluster_kernel(const int32_t* __restrict__ vtime,
                       const int8_t* __restrict__ runnable,
                       const int8_t* __restrict__ member,
                       const int32_t* __restrict__ skew,
                       int32_t* __restrict__ minima,
                       int8_t* __restrict__ elig, int n, int s,
                       int slab_rows, int kept_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = s < CHUNK_S ? s : CHUNK_S;
  const int pad = (cs + 3) & ~3;
  int32_t* part = reinterpret_cast<int32_t*>(smem);
  int32_t* thr = part + pad;
  int8_t* slab = reinterpret_cast<int8_t*>(thr + pad);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rank = blockIdx.x;          // the cluster spans grid x
  const int n_ranks = gridDim.x;
  const int v = blockIdx.y;
  const int r0 = min(n, rank * slab_rows);
  const int r1 = min(n, r0 + slab_rows);
  const int rk = min(r1, r0 + kept_rows);  // rows below rk stay on chip
  const int32_t* vt = vtime + (size_t)v * n;
  const int8_t* run = runnable + (size_t)v * n;
  const int8_t* mem = member + (size_t)v * n * s;

  for (int c0 = 0; c0 < s; c0 += CHUNK_S) {
    const int sc = min(CHUNK_S, s - c0);
    const int ng = sc / W;              // groups of W scopes in the chunk

    // Pass 1: partial minima of this slab.
    for (int j = tid; j < sc; j += THREADS) part[j] = INF_TICKS;
    __syncthreads();
    const int tpr = min(pow2_ceil(ng), THREADS);
    const int rps = THREADS / tpr;
    const int tr = tid / tpr;
    const int tc = tid - tr * tpr;
    for (int g0 = 0; g0 < ng; g0 += tpr) {
      const int cg = g0 + tc;
      int32_t best = INF_TICKS;  // W = 1: the column's running minimum
      if (cg < ng) {
        for (int r = r0 + tr; r < r1; r += BATCH * rps) {
          Group<W> g[BATCH];
          int32_t t[BATCH];
          bool live[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {  // every load in flight first
            const int rr = r + u * rps;
            live[u] = false;
            if (rr < r1) {
              g[u] = load_group<W>(mem + (size_t)rr * s + c0 + cg * W);
              t[u] = vt[rr];
              live[u] = run[rr] != 0;
            }
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const int rr = r + u * rps;
            if (rr < rk)
              store_group<W>(slab + (size_t)(rr - r0) * sc + cg * W, g[u]);
            if (!live[u]) continue;
            if constexpr (W == 16) {  // sparse: one atomic per member
              for (uint32_t m = on_mask(g[u]); m; m &= m - 1)
                atomicMin(&part[cg * W + __ffs(m) - 1], t[u]);
            } else {
              if (g[u].on(0)) best = min(best, t[u]);
            }
          }
        }
      }
      if constexpr (W == 1) {
        for (int off = 16; off >= tpr; off >>= 1)
          best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
        if (cg < ng && (tpr >= 32 || lane < tpr) && best < INF_TICKS)
          atomicMin(&part[cg], best);
      }
    }

    // Combine: every rank's partial minima, through the cluster, a
    // thread a column, its loads of the ranks all in flight at once.
    cluster_arrive();
    cluster_wait();
    const int32_t* sk = skew + (size_t)v * s + c0;
    for (int j = tid; j < sc; j += THREADS) {
      int32_t m = INF_TICKS;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < n_ranks) m = min(m, ld_cluster(part + j, q));
      thr[j] = m == INF_TICKS ? INT_MAX
                              : (int32_t)((uint32_t)m + (uint32_t)sk[j]);
      if (rank == 0) minima[(size_t)v * s + c0 + j] = m;
    }
    __syncthreads();  // thr
    cluster_arrive();  // done reading the other blocks' part

    // Pass 2: eligibility of this slab's rows, the kept ones from shared
    // memory, the rest again from device memory (L2).
    const int g2 = min(pow2_ceil(ng), 32);
    const bool one = ng <= g2;
    const int gl = lane % g2;
    // W = 1 with at most 32 scopes: a lane's one threshold in a register
    const int32_t th0 = (W == 1 && one && gl < ng) ? thr[gl] : INT_MAX;
    int8_t* el = elig + (size_t)v * n;
    elig_rows<W>(r0, rk, slab, sc, vt, run, thr, th0, el, ng, g2, one,
                 c0 == 0);
    elig_rows<W>(rk, r1, mem + (size_t)rk * s + c0, s, vt, run, thr, th0, el,
                 ng, g2, one, c0 == 0);
    cluster_wait();
  }
}

// -- host -----------------------------------------------------------------------

typedef void (*KernelFn)(const int32_t*, const int8_t*, const int8_t*,
                         const int32_t*, int32_t*, int8_t*, int, int, int,
                         int);

// Per kernel instance: the dynamic shared memory opted in so far, and
// the last few (cluster, smem) configurations found to fit on the card.
struct Setup {
  size_t smem_set;
  int fits_cluster[8];
  size_t fits_smem[8];
  int fits_next;
};
static Setup setups[2];

static cudaError_t set_up(KernelFn fn, Setup* st, int cluster, size_t smem,
                          const cudaLaunchConfig_t* cfg) {
  cudaError_t err;
  if (st->smem_set == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    st->smem_set = 48 * 1024;
  }
  if (smem > st->smem_set) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    st->smem_set = smem;
  }
  for (int i = 0; i < 8; ++i)
    if (st->fits_cluster[i] == cluster && st->fits_smem[i] == smem)
      return cudaSuccess;
  // Once per configuration: can one cluster of this shape be resident?
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  st->fits_cluster[st->fits_next] = cluster;
  st->fits_smem[st->fits_next] = smem;
  st->fits_next = (st->fits_next + 1) & 7;
  return cudaSuccess;
}

// v, n, s >= 1; 1 <= cluster <= MAX_CLUSTER; slab_rows = ceil(n /
// cluster); 0 <= kept_rows <= slab_rows with kept_rows * min(s, CHUNK_S)
// <= SLAB_MAX; vec needs s % 16 == 0 and a 16-byte aligned membership
// pointer.
extern "C" int minskew_launch(const void* vtime, const void* runnable,
                              const void* member, const void* skew,
                              void* minima, void* elig, int v, int n, int s,
                              int cluster, int kept_rows, int vec,
                              void* stream) {
  if (v < 1 || n < 1 || s < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
      v > 65535 || (vec && (s % 16 != 0 || (uintptr_t)member % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const int slab_rows = (n + cluster - 1) / cluster;
  const int cs = s < CHUNK_S ? s : CHUNK_S;
  if (kept_rows < 0 || kept_rows > slab_rows ||
      (size_t)kept_rows * cs > SLAB_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, kept_rows);
  KernelFn fn = vec ? minskew_cluster_kernel<16> : minskew_cluster_kernel<1>;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, v, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = set_up(fn, &setups[vec ? 1 : 0], cluster, smem, &cfg);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, fn, (const int32_t*)vtime,
                           (const int8_t*)runnable, (const int8_t*)member,
                           (const int32_t*)skew, (int32_t*)minima,
                           (int8_t*)elig, n, s, slab_rows, kept_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The constants the caller plans with: [THREADS, MAX_CLUSTER, CHUNK_S,
// SLAB_MAX].
extern "C" void minskew_constants(int* out) {
  out[0] = THREADS;
  out[1] = MAX_CLUSTER;
  out[2] = CHUNK_S;
  out[3] = SLAB_MAX;
}
