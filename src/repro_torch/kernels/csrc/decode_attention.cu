// Decode attention for Hopper (sm_90a): one new query token per row
// against a KV cache, float32 or bfloat16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_kernel, wrapper decode_attention).  For q (B, H, hd), caches k, v
// (B, S, Hkv, hd) and lengths (B,) int32, all contiguous:
//   out[b, h] = sum_{s < len_b} p_s v[b, s, h / qpk],
//   p = softmax_s(scale * q[b, h] . k[b, s, h / qpk]),
// with len_b = lengths[b] clamped to [0, S].  Sums in float32, output in
// q's dtype.  A row with length 0 gives 0.
//
// Design.  One block of 256 threads per (batch row b, kv head g).  It
// handles the qpk = H / Hkv query heads of that group together and walks
// the cache in tiles of BS = 64 positions up to len_b, so each K and V
// tile is read from device memory once for its whole GQA group (the TPU
// kernel's property, :4-8) and no tile past the length is read (the TPU
// kernel's skip, :42).  lengths[b] is read inside the kernel: there is no
// scalar prefetch.  Per tile: (1) K and V rows are loaded into shared
// memory as float32 (each position's hd-long row is contiguous, so the
// loads coalesce); (2) one thread per (head, position) computes a score
// against the pre-scaled q held in shared memory; (3) one warp per head
// takes the tile's max and sum by shuffles and updates the running
// max / denominator (online softmax); (4) each thread rescales and adds
// P.V into its slice of the (qpk x hd) accumulator, kept in registers.
// Masked positions get NEG_INF = -1e30 and their p is zeroed (the
// masked-row trap of the flash kernel; the TPU kernel's where, :60);
// the final division is by max(l, 1e-30).
//
// Bound on the H100: bytes.  Decode reads the whole valid cache once,
// 2 * len * Hkv * hd elements per row, for about 4 hd FLOPs per element:
// at the main path's shape (B=4, Hkv=8, hd=128, len about 1,056, bf16)
// that is 17 MB, 5.2 us at 3.35 TB/s.  The known limit of this first
// kernel: B * Hkv = 32 blocks on 132 SMs, each streaming its tiles with
// plain synchronous loads, so most of the card's memory bandwidth is
// unused.  Splitting S across blocks with a combine pass (flash-decoding)
// and asynchronous copies are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BS 64
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_HD 256
#define MAX_OUT 32                    // accumulator slots per thread
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

static size_t smem_bytes(int qpk, int hd) {
  // q: qpk x hd, K: BS x (hd+1), V: BS x hd, scores: qpk x BS,
  // running max, denominator and correction: 3 x qpk
  return sizeof(float) * ((size_t)qpk * hd + (size_t)BS * (hd + 1) +
                          (size_t)BS * hd + (size_t)qpk * BS + 3 * (size_t)qpk);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ lengths,
              T* __restrict__ out, int h, int hkv, int s, int hd,
              float scale) {
  extern __shared__ float smem[];
  const int qpk = h / hkv;
  const int ld = hd + 1;
  float* qs = smem;                    // qpk x hd
  float* ks = qs + qpk * hd;           // BS x ld
  float* vs = ks + BS * ld;            // BS x hd
  float* ss = vs + BS * hd;            // qpk x BS
  float* m_run = ss + qpk * BS;        // qpk
  float* l_run = m_run + qpk;          // qpk
  float* corr = l_run + qpk;           // qpk

  const int b = blockIdx.x / hkv;
  const int g = blockIdx.x % hkv;
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int len = min(max(lengths[b], 0), s);
  const int n_out = qpk * hd;

  const T* qb = q + ((size_t)b * h + (size_t)g * qpk) * hd;
  for (int idx = t; idx < n_out; idx += THREADS) qs[idx] = to_f(qb[idx]) * scale;
  for (int i = t; i < qpk; i += THREADS) {
    m_run[i] = NEG_INF_SCORE;
    l_run[i] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = 0.f;

  const size_t row_stride = (size_t)hkv * hd;    // between positions
  const T* kb = k + (size_t)b * s * row_stride + (size_t)g * hd;
  const T* vb = v + (size_t)b * s * row_stride + (size_t)g * hd;

  for (int s_first = 0; s_first < len; s_first += BS) {
    __syncthreads();                 // previous tile fully consumed
    for (int idx = t; idx < BS * hd; idx += THREADS) {
      const int r = idx / hd, d = idx % hd;
      const int pos = s_first + r;
      float kv = 0.f, vv = 0.f;
      if (pos < len) {
        kv = to_f(kb[(size_t)pos * row_stride + d]);
        vv = to_f(vb[(size_t)pos * row_stride + d]);
      }
      ks[r * ld + d] = kv;
      vs[r * hd + d] = vv;
    }
    __syncthreads();

    // (2) scores, masked past the length
    for (int idx = t; idx < qpk * BS; idx += THREADS) {
      const int hh = idx / BS, r = idx % BS;
      float sc = NEG_INF_SCORE;
      if (s_first + r < len) {
        sc = 0.f;
        const float* qr = qs + hh * hd;
        const float* kr = ks + r * ld;
        for (int d = 0; d < hd; ++d) sc = fmaf(qr[d], kr[d], sc);
      }
      ss[idx] = sc;
    }
    __syncthreads();

    // (3) online softmax, one warp per head
    for (int hh = warp; hh < qpk; hh += WARPS) {
      float* sr = ss + hh * BS;
      float mx = NEG_INF_SCORE;
      for (int r = lane; r < BS; r += 32) mx = fmaxf(mx, sr[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = m_run[hh];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < BS; r += 32) {
        const float p = (s_first + r < len) ? expf(sr[r] - m_new) : 0.f;
        sr[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[hh] = c;
        l_run[hh] = l_run[hh] * c + sum;
        m_run[hh] = m_new;
      }
    }
    __syncthreads();

    // (4) acc[(hh, d)] = acc * corr[hh] + sum_r p[hh][r] * V[r][d]
    const int nr = min(BS, len - s_first);
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) {
      const int idx = t + o * THREADS;
      if (idx < n_out) {
        const int hh = idx / hd, d = idx % hd;
        const float* pr = ss + hh * BS;
        float a = acc[o] * corr[hh];
        for (int r = 0; r < nr; ++r) a = fmaf(pr[r], vs[r * hd + d], a);
        acc[o] = a;
      }
    }
  }
  __syncthreads();                   // l_run final before the division

  T* ob = out + ((size_t)b * h + (size_t)g * qpk) * hd;
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) {
    const int idx = t + o * THREADS;
    if (idx < n_out) {
      const float l = len > 0 ? l_run[idx / hd] : 0.f;
      ob[idx] = from_f<T>(acc[o] / fmaxf(l, 1e-30f));
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, int b, int h, int hkv,
                  int s, int hd, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(h / hkv, hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T><<<b * hkv, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths,
      (T*)out, h, hkv, s, hd, scale);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t.  The caller checks shapes (h % hkv == 0,
// hd % 8 == 0, 8 <= hd <= 256, (h / hkv) * hd <= 8192, b * hkv >= 1).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int b, int h, int hkv,
                                       int s, int hd, double scale,
                                       int is_bf16, void* stream) {
  if (hd <= 0 || hd > MAX_HD || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      (h / hkv) * hd > MAX_OUT * THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, b, h, hkv, s, hd,
                                 (float)scale, st);
  return launch<float>(q, k, v, lengths, out, b, h, hkv, s, hd,
                       (float)scale, st);
}
