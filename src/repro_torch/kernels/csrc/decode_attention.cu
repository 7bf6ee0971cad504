// Decode attention for Hopper (sm_90a): one new query token per row
// against a KV cache, float32 or bfloat16, split over the cache
// (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_kernel, wrapper decode_attention).  For q (B, H, hd), caches k, v
// (B, S, Hkv, hd) and lengths (B,) int32, all contiguous:
//   out[b, h] = sum_{s < len_b} p_s v[b, s, h / qpk],
//   p = softmax_s(scale * q[b, h] . k[b, s, h / qpk]),
// with len_b = lengths[b] clamped to [0, S].  Sums in float32, output in
// q's dtype.  A row with length 0 gives 0.
//
// Bound on the H100: bytes.  The valid cache is read once, 2 * len * Hkv *
// hd elements per row, for about 4 hd FLOPs per element per query head of
// the group: at qwen3_4b's decode (B=4, Hkv=8, hd 128, bf16, len about
// 1,056) 17 MB, 5.2 us at 3.35 TB/s; at recurrentgemma's ring buffer (B=4,
// Hkv=1, hd 256, 2,048 slots) 8.4 MB, 2.5 us.
//
// Design.  Two kernels on the caller's stream.
// (1) decode_split_kernel: one block of 256 threads per (chunk of `chunk`
//     positions, batch row b, kv head g), `chunk` a multiple of 32 chosen by
//     the wrapper from S (the capacity, never from lengths, which stay on
//     the card), so that B * Hkv alone (4 blocks under MQA) no longer
//     bounds the grid.  A block takes its chunk for the whole GQA group of
//     qpk query heads, so each K and V byte is still read once.  A block
//     whose chunk starts at or past len_b writes the empty partial (m =
//     -1e30, l = 0, acc = 0) and exits.  Otherwise it walks its chunk in
//     tiles of 32 positions, which cp.async brings (16 bytes a thread,
//     zero-filled past the chunk or len_b) into a two-stage ring of K and V
//     kept in the input dtype, rows padded by 16 bytes so the score loop
//     reads them without bank conflicts.  q, pre-scaled, is in shared
//     memory as float32 once per block.  Scores: warp w takes heads w, w+8,
//     ..., one lane per position (8 independent partial sums per dot), so
//     a head's max and sum over the tile are warp shuffles; its running max
//     and denominator live in shared memory.  P.V: each thread owns a group
//     of 8 output columns of one head and reads V rows 16 bytes at a time;
//     where the block has fewer groups than threads (qpk * hd / 8 < 256, as
//     at qwen3_4b's shape), up to 8 threads share a group, each summing
//     every P-th position, and their sums meet once at the chunk's end.
//     The block writes its partial (m, l, acc[hd]) per head in float32.
// (2) decode_combine_kernel: one block per (b, head) merges the partials:
//     M = max m_i, out = sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i,
//     1e-30); its 4 warps split the partials and read them 16 bytes a lane.
//     An empty split adds exp(-1e30 - M) = 0, or, when every split of the
//     row is empty (length 0), exp(0) * 0 to both sums: the row is 0.
//
// The masked-row trap: masked positions get no score (p = 0) and the
// empty partial holds m = -1e30, l = 0, acc = 0, never -inf, so no inf -
// inf reaches the combine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define THREADS 128           // combine kernel
#define WARPS (THREADS / 32)
#define TS 32                 // positions per tile: one per lane
#define STAGES 2
#define SPLIT_THREADS 256     // split kernel
#define SPLIT_WARPS (SPLIT_THREADS / 32)
#define SPLIT_GROUPS 4        // 8-column output groups per thread
#define NEG_INF_SCORE (-1e30f)
#define FULL 0xffffffffu

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements of a row in shared memory, as float32.
__device__ __forceinline__ void load8(const unsigned char* p, float (&f)[8],
                                      const __nv_bfloat16*) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const unsigned char* p, float (&f)[8],
                                      const float*) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Position subsets of the P.V loop: where a block has fewer 8-column output
// groups than threads, up to 8 threads share a group, each taking every
// P-th position of a tile, and their sums meet once at the chunk's end.
__host__ __device__ inline int pv_subsets(int n_groups) {
  int p = 1;
  while (p < 8 && 2 * p * n_groups <= SPLIT_THREADS) p *= 2;
  return p;
}

// Shared-memory layout in bytes: the K/V ring, then q (qpk x hd floats),
// the tile's probabilities (qpk x TS), running max, denominator and
// correction (qpk each), and the subsets' sums (subsets x qpk x hd).
static size_t row_bytes(int hd, int elt) { return (size_t)hd * elt + 16; }
static size_t smem_bytes(int qpk, int hd, int elt) {
  const int n_out = qpk * hd, subsets = pv_subsets(n_out / 8);
  return STAGES * 2 * TS * row_bytes(hd, elt) +
         sizeof(float) * ((size_t)n_out + (size_t)qpk * TS + 3 * qpk +
                          (subsets > 1 ? (size_t)subsets * n_out : 0));
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int h, int hkv, int s,
                    int hd, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qpk = h / hkv;
  const int n_split = gridDim.x, split = blockIdx.x;
  const int b = blockIdx.y / hkv, g = blockIdx.y % hkv;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int len = min(max(lengths[b], 0), s);
  const int first = split * chunk;
  const int last = min(first + chunk, len);  // exclusive
  const int n_out = qpk * hd;
  // partial (b, g * qpk + hh, split) of (B, H, n_split)
  const size_t part0 = ((size_t)b * h + (size_t)g * qpk) * n_split + split;

  if (first >= last) {  // uniform across the block
    for (int hh = t; hh < qpk; hh += SPLIT_THREADS) {
      part_m[part0 + (size_t)hh * n_split] = NEG_INF_SCORE;
      part_l[part0 + (size_t)hh * n_split] = 0.f;
    }
    for (int idx = t; idx < n_out; idx += SPLIT_THREADS) {
      const int hh = idx / hd, d = idx % hd;
      part_acc[(part0 + (size_t)hh * n_split) * hd + d] = 0.f;
    }
    return;
  }

  const int elt = sizeof(T);
  const int ld = hd * elt + 16;                 // padded row, bytes
  const int cpr = hd * elt / 16;                // 16-byte chunks per row
  unsigned char* ring = smem;                   // [stage][K, V][TS][ld]
  float* qs = reinterpret_cast<float*>(smem + STAGES * 2 * TS * ld);
  float* ps = qs + n_out;                       // qpk x TS
  float* m_run = ps + qpk * TS;
  float* l_run = m_run + qpk;
  float* corr = l_run + qpk;
  float* red = corr + qpk;                      // subsets x n_out

  const size_t pos_stride = (size_t)hkv * hd;   // elements between positions
  const T* kb = k + (size_t)b * s * pos_stride + (size_t)g * hd;
  const T* vb = v + (size_t)b * s * pos_stride + (size_t)g * hd;
  const int n_tiles = (last - first + TS - 1) / TS;

  auto load = [&](int tile) {
    unsigned char* kst = ring + (size_t)(tile % STAGES) * 2 * TS * ld;
    const int p0 = first + tile * TS;
    for (int idx = t; idx < 2 * TS * cpr; idx += SPLIT_THREADS) {
      const int which = idx / (TS * cpr);       // 0: K, 1: V
      const int rem = idx - which * TS * cpr;
      const int r = rem / cpr, c = rem % cpr;
      const int pos = p0 + r;
      const bool ok = pos < last;
      const T* src = (which ? vb : kb) + (ok ? pos * pos_stride : 0) +
                     c * (16 / elt);
      cp_async16(smem_u32(kst + which * TS * ld + r * ld + c * 16), src,
                 ok ? 16 : 0);
    }
  };
  load(0);
  cp_async_commit();
  if (n_tiles > 1) load(1);
  cp_async_commit();

  const T* qb = q + ((size_t)b * h + (size_t)g * qpk) * hd;
  for (int idx = t; idx < n_out; idx += SPLIT_THREADS)
    qs[idx] = to_f(qb[idx]) * scale;
  for (int hh = t; hh < qpk; hh += SPLIT_THREADS) {
    m_run[hh] = NEG_INF_SCORE;
    l_run[hh] = 0.f;
  }

  float acc[SPLIT_GROUPS][8];
#pragma unroll
  for (int i = 0; i < SPLIT_GROUPS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int gpr = hd / 8;                       // output groups per head
  const int n_groups = qpk * gpr;
  const int subsets = pv_subsets(n_groups);
  const int sub = subsets > 1 ? t / n_groups : 0;
  const int og0 = subsets > 1 ? t % n_groups : t;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const unsigned char* kst = ring + (size_t)(tile % STAGES) * 2 * TS * ld;
    const unsigned char* vst = kst + TS * ld;
    const int p0 = first + tile * TS;
    cp_async_wait<1>();
    __syncthreads();

    // scores and the online softmax: warp w takes heads w, w + 4, ...
    const bool ok = p0 + lane < last;
    const unsigned char* krow = kst + lane * ld;
    for (int hh = warp; hh < qpk; hh += SPLIT_WARPS) {
      float sc = NEG_INF_SCORE;
      if (ok) {
        const float* qr = qs + hh * hd;
        float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int d = 0; d < hd; d += 8) {  // 8 independent sums
          float kf[8];
          load8(krow + d * elt, kf, (const T*)nullptr);
          const float4 q0 = *reinterpret_cast<const float4*>(qr + d);
          const float4 q1 = *reinterpret_cast<const float4*>(qr + d + 4);
          a[0] = fmaf(q0.x, kf[0], a[0]); a[1] = fmaf(q0.y, kf[1], a[1]);
          a[2] = fmaf(q0.z, kf[2], a[2]); a[3] = fmaf(q0.w, kf[3], a[3]);
          a[4] = fmaf(q1.x, kf[4], a[4]); a[5] = fmaf(q1.y, kf[5], a[5]);
          a[6] = fmaf(q1.z, kf[6], a[6]); a[7] = fmaf(q1.w, kf[7], a[7]);
        }
        sc = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
      }
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = m_run[hh];
      const float m_new = fmaxf(m_prev, mx);  // real: lane 0 is valid
      const float p = ok ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      ps[hh * TS + lane] = p;
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[hh] = c;
        l_run[hh] = l_run[hh] * c + sum;
        m_run[hh] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over the tile's valid positions
    const int nr = min(TS, last - p0);
#pragma unroll
    for (int i = 0; i < SPLIT_GROUPS; ++i) {
      const int og = og0 + i * SPLIT_THREADS;
      if (og < n_groups && sub < subsets) {
        const int hh = og / gpr, d0 = (og % gpr) * 8;
        const float c = corr[hh];
        const float* pr = ps + hh * TS;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= c;
#pragma unroll 4
        for (int r = sub; r < nr; r += subsets) {
          float vf[8];
          load8(vst + r * ld + d0 * elt, vf, (const T*)nullptr);
          const float p = pr[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p, vf[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // stage and probabilities free
    if (tile + 2 < n_tiles) load(tile + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (subsets > 1) {  // the subsets' sums meet in thread og < n_groups
    if (sub < subsets)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[sub * n_out + og0 * 8 + j] = acc[0][j];
    __syncthreads();
    if (sub == 0)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = 0.f;
        for (int q2 = 0; q2 < subsets; ++q2) a += red[q2 * n_out + og0 * 8 + j];
        acc[0][j] = a;
      }
  }

  for (int hh = t; hh < qpk; hh += SPLIT_THREADS) {
    part_m[part0 + (size_t)hh * n_split] = m_run[hh];
    part_l[part0 + (size_t)hh * n_split] = l_run[hh];
  }
#pragma unroll
  for (int i = 0; i < SPLIT_GROUPS; ++i) {
    const int og = t + i * SPLIT_THREADS;
    if (og < n_groups) {
      const int hh = og / gpr, d0 = (og % gpr) * 8;
      float* dst = part_acc + (part0 + (size_t)hh * n_split) * hd + d0;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int n_split, int hd) {
  // n_split weights, then (from a 16-byte boundary) WARPS x hd sums
  extern __shared__ __align__(16) float cs[];
  __shared__ float red[WARPS];
  float* w = cs;
  float* sums = cs + ((n_split + 3) & ~3);
  const size_t bh = blockIdx.x;
  const float* m = part_m + bh * n_split;
  const float* l = part_l + bh * n_split;
  const float* acc = part_acc + bh * n_split * hd;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  float mx = NEG_INF_SCORE;
  for (int i = t; i < n_split; i += THREADS) mx = fmaxf(mx, m[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) mx = fmaxf(mx, red[i]);
  __syncthreads();

  float den = 0.f;
  for (int i = t; i < n_split; i += THREADS) {
    const float wi = expf(m[i] - mx);
    w[i] = wi;
    den += wi * l[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(FULL, den, off);
  if (lane == 0) red[warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) den += red[i];
  const float inv = 1.f / fmaxf(den, 1e-30f);

  // warp w sums splits w, w + 4, ...; lane owns columns 4 lane + 128 c
  float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                 make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll 4
  for (int i = warp; i < n_split; i += WARPS) {
    const float wi = w[i];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d0 = 4 * lane + 128 * c;
      if (d0 < hd) {
        const float4 x =
            *reinterpret_cast<const float4*>(acc + (size_t)i * hd + d0);
        a[c].x = fmaf(wi, x.x, a[c].x);
        a[c].y = fmaf(wi, x.y, a[c].y);
        a[c].z = fmaf(wi, x.z, a[c].z);
        a[c].w = fmaf(wi, x.w, a[c].w);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d0 = 4 * lane + 128 * c;
    if (d0 < hd) *reinterpret_cast<float4*>(sums + warp * hd + d0) = a[c];
  }
  __syncthreads();
  for (int d = t; d < hd; d += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) v += sums[i * hd + d];
    out[bh * hd + d] = from_f<T>(v * inv);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* part_m, void* part_l,
                  void* part_acc, void* out, int b, int h, int hkv, int s,
                  int hd, int chunk, int n_split, float scale,
                  cudaStream_t st) {
  const size_t smem = smem_bytes(h / hkv, hd, sizeof(T));
  static size_t smem_set = 48 * 1024;  // the opt-in so far, per dtype
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(decode_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  decode_split_kernel<T><<<dim3(n_split, b * hkv), SPLIT_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths,
      (float*)part_m, (float*)part_l, (float*)part_acc, h, hkv, s, hd, chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t csmem =
      sizeof(float) * ((size_t)((n_split + 3) & ~3) + WARPS * hd);
  if (csmem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_combine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)csmem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_combine_kernel<T><<<b * h, THREADS, csmem, st>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, n_split, hd);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t.  part_m, part_l (B, H, n_split) and part_acc
// (B, H, n_split, hd) are float32 scratch; chunk is a multiple of 32 and
// n_split = max(1, ceil(S / chunk)).  The caller checks shapes (h % hkv ==
// 0, hd % 8 == 0, 8 <= hd <= 256, (h / hkv) * hd <= 8192, b * hkv <=
// 65535, 16-byte aligned caches).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* part_m, void* part_l,
                                       void* part_acc, void* out, int b,
                                       int h, int hkv, int s, int hd,
                                       int chunk, int n_split, double scale,
                                       int is_bf16, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      (h / hkv) * hd > SPLIT_GROUPS * 8 * SPLIT_THREADS || chunk <= 0 ||
      chunk % TS != 0 || n_split <= 0 || b * hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, part_m, part_l, part_acc,
                                 out, b, h, hkv, s, hd, chunk, n_split,
                                 (float)scale, st);
  return launch<float>(q, k, v, lengths, part_m, part_l, part_acc, out, b,
                       h, hkv, s, hd, chunk, n_split, (float)scale, st);
}
