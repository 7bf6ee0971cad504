// Chunkwise mLSTM for Hopper (sm_90a), q, k, v in float32 or bfloat16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_kernel.py
// (_kernel, wrapper mlstm_chunkwise).  For q, k, v (BH, S, hd), gates
// i_raw, f_raw (BH, S) float32 and the carry C (BH, hd, hd), n (BH, hd)
// float32, with S a multiple of the chunk L (the wrapper pads the tail
// with gates that leave the carry unchanged), per chunk of L tokens:
//   li = min(i_raw, 8), lf = log_sigmoid(f_raw), a = cumsum_chunk(lf),
//   qd_i = q_i / sqrt(hd) * exp(a_i),  kw_j = k_j * exp(a_L - a_j + li_j),
//   S_ij = (q_i . k_j) / sqrt(hd) * exp(a_i - a_j + li_j)   for j <= i,
//   out_i = qd_i C + sum_j S_ij v_j,  den_i = qd_i . n + sum_j S_ij,
//   h_i = out_i / max(|den_i|, 1),
//   C <- exp(a_L) C + kw^T v,  n <- exp(a_L) n + sum_j kw_j.
// S_ij is the TPU kernel's (q_i exp(a_i)) . (k_j exp(li_j - a_j)) with
// the exponents summed before exp (equal in exact arithmetic; no
// overflow of exp(-a_j) on long chunks).  Sums in float32, h in q's
// dtype; the final C and n are written out (the model's prefill hands
// them to decode).
//
// The trap is the width.  At xlstm_1_3b's width hd = 1,024, so C is
// 4 MB of float32 per (b, h): no block's shared memory holds it, and
// the TPU design (C resident in VMEM across the chunk axis) cannot be
// carried over.  Design: two passes.
//  1. scores_kernel, one block per (chunk, bh), all chunks in parallel:
//     the masked, gated L x L score matrix S and its row sums (the
//     intra-chunk part of den) into scratch.  Neither depends on the
//     carry, so nothing here is sequential.
//  2. carry_kernel, one block per (BE = 64 value columns, bh): q C[:, e],
//     S v[:, e] and the update of C[:, e] separate by columns of C, so
//     the block walks the chunks in order and owns its hd x 64 slab of
//     C, which stays in device memory (the output buffer of the final
//     C) and passes through shared memory in TD = 64-row tiles: each
//     tile is read once per chunk, used for out += qd C_tile with its old
//     value, updated and written back.  The inter-chunk part of den
//     needs only the hd-vector n, which every column block keeps and
//     updates in shared memory (an L x hd product, 1/64 of the block's
//     work); the first column block writes the final n.
// Thread t of 256 owns a 4 x 4 micro-tile: rows 4 (t / 16) .. + 3,
// columns (t % 16) + 16 c.  Tiles in shared memory that are read down a
// column are padded by one float, so the inner loops are free of bank
// conflicts.
//
// Bound on the H100: operations.  Per token and head the function does
// 4 hd^2 + 4 L hd FLOPs (q C and the C update, S and S v): at the
// serving shape (BH = 16, S = 1,024, hd = 1,024) 73 GFLOP of float32,
// 1.09 ms at 67 TFLOP/s, against about 200 MB of inputs, outputs and
// carry (0.06 ms at 3.35 TB/s).  The first kernel runs those FLOPs as
// float32 FMAs from shared memory with two loads per four FMAs, so
// shared-memory bandwidth caps it near half the float32 peak; the C slab
// makes a round trip to device memory (or L2) per chunk, 8 bytes per
// 4 L FLOPs.  This design now serves only the head dims the two
// tensor-core sources do not take (mlstm_kernel.fwd_source): hd not a
// multiple of 8, or above their limits (mlstm_sm90_max_hd() for bf16,
// mlstm_tf32x3_max_hd() for float32).  bf16 otherwise runs
// mlstm_kernel_sm90.cu, whose products are exact bf16 x bf16 in fp32 with
// C rounded to bf16 only for q C and the carry update split so that C
// keeps fp32 accuracy; float32 runs mlstm_kernel_tf32x3.cu, whose every
// product is three TF32 products of operands split into hi and lo parts,
// which keeps float32 accuracy where a single TF32 pass would not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define L 64            // chunk
#define TD 64           // rows of a C tile, and the hd tile of pass 1
#define BE 64           // value columns per carry block
#define THREADS 256
#define I_CAP 8.0f

static_assert(TD == L, "carry_kernel's update loop runs one index over "
                       "both C's tile rows and the chunk's tokens");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Gates of one chunk into shared memory: li (capped log input gate) and
// a (in-chunk cumsum of the log forget gate).  One thread adds the L
// terms in order, so both passes see the same a.
__device__ __forceinline__ void chunk_gates(const float* ig, const float* fg,
                                            float* li, float* a) {
  const int t = threadIdx.x;
  if (t < L) {
    li[t] = fminf(ig[t], I_CAP);
    a[t] = log_sigmoid(fg[t]);
  }
  __syncthreads();
  if (t == 0) {
    float run = 0.f;
    for (int j = 0; j < L; ++j) {
      run += a[j];
      a[j] = run;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const float* __restrict__ ig, const float* __restrict__ fg,
              float* __restrict__ sc, float* __restrict__ den_intra, int s,
              int hd, float scale) {
  __shared__ float qs[L][TD + 1];
  __shared__ float ks[L][TD + 1];
  __shared__ float li[L], a[L];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  chunk_gates(ig + row0, fg + row0, li, a);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int dt = 0; dt < hd; dt += TD) {
    __syncthreads();
    for (int idx = t; idx < L * TD; idx += THREADS) {
      const int j = idx / TD, d = idx % TD;
      const bool in = dt + d < hd;
      const int64_t off = (row0 + j) * hd + dt + d;
      qs[j][d] = in ? to_f(q[off]) * scale : 0.f;
      ks[j][d] = in ? to_f(k[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < TD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[ty * 4 + r][d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[tx + 16 * c][d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qv[r], kv[c], acc[r][c]);
    }
  }
  float* scb = sc + ((int64_t)bh * nc + ch) * L * L;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = tx + 16 * c;
      const float val = m <= i ? acc[r][c] * expf(a[i] - a[m] + li[m]) : 0.f;
      scb[i * L + m] = val;
      sum += val;
    }
    // the 16 threads of row group ty are one half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0) den_intra[((int64_t)bh * nc + ch) * L + i] = sum;
  }
}

static size_t carry_smem_floats(int hd) {
  const int hd_pad = (hd + TD - 1) / TD * TD;
  // qd, kw: L x (TD+1); C tile: TD x BE; v slab: L x BE; S: L x (L+1);
  // n: hd_pad; li, a, dec, wc, den: 5 L
  return 2 * (size_t)L * (TD + 1) + (size_t)TD * BE + (size_t)L * BE +
         (size_t)L * (L + 1) + hd_pad + 5 * L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
carry_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ ig,
             const float* __restrict__ fg, const float* __restrict__ sc,
             const float* __restrict__ den_intra,
             const float* __restrict__ n0, float* __restrict__ cbuf,
             float* __restrict__ n_out, T* __restrict__ h, int s, int hd,
             float scale) {
  extern __shared__ float smem[];
  const int hd_pad = (hd + TD - 1) / TD * TD;
  float* qd = smem;                      // L x (TD+1)
  float* kw = qd + L * (TD + 1);         // L x (TD+1)
  float* ct = kw + L * (TD + 1);         // TD x BE
  float* vs = ct + TD * BE;              // L x BE
  float* ss = vs + L * BE;               // L x (L+1)
  float* nv = ss + L * (L + 1);          // hd_pad
  float* li = nv + hd_pad;               // L
  float* a = li + L;
  float* dec = a + L;
  float* wc = dec + L;
  float* den = wc + L;

  const int e0 = blockIdx.x * BE, bh = blockIdx.y;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int nc = s / L;
  float* cb = cbuf + (int64_t)bh * hd * hd;
  for (int d = t; d < hd_pad; d += THREADS)
    nv[d] = d < hd ? n0[(int64_t)bh * hd + d] : 0.f;

  for (int ch = 0; ch < nc; ++ch) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    __syncthreads();                     // the previous chunk is done
    chunk_gates(ig + row0, fg + row0, li, a);
    const float a_l = a[L - 1];
    const float decay = expf(a_l);
    if (t < L) {
      dec[t] = expf(a[t]);
      wc[t] = expf(a_l - a[t] + li[t]);
      den[t] = den_intra[((int64_t)bh * nc + ch) * L + t];
    }
    const float* scb = sc + ((int64_t)bh * nc + ch) * L * L;
    for (int idx = t; idx < L * BE; idx += THREADS) {
      const int j = idx / BE, e = idx % BE;
      vs[j * BE + e] =
          e0 + e < hd ? to_f(v[(row0 + j) * hd + e0 + e]) : 0.f;
    }
    for (int idx = t; idx < L * L; idx += THREADS)
      ss[(idx / L) * (L + 1) + idx % L] = scb[idx];
    __syncthreads();

    // intra-chunk: out = S v[:, slab]
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
    for (int m = 0; m < L; ++m) {
      float sv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = ss[(ty * 4 + r) * (L + 1) + m];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = vs[m * BE + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(sv[r], vv[c], acc[r][c]);
    }

    // inter-chunk, tile by tile of C's rows
    for (int dt = 0; dt < hd; dt += TD) {
      __syncthreads();                   // the previous tile is consumed
      for (int idx = t; idx < L * TD; idx += THREADS) {
        const int j = idx / TD, d = idx % TD;
        const bool in = dt + d < hd;
        const int64_t off = (row0 + j) * hd + dt + d;
        qd[j * (TD + 1) + d] = in ? to_f(q[off]) * scale * dec[j] : 0.f;
        kw[j * (TD + 1) + d] = in ? to_f(k[off]) * wc[j] : 0.f;
      }
      for (int idx = t; idx < TD * BE; idx += THREADS) {
        const int d = idx / BE, e = idx % BE;
        ct[idx] = (dt + d < hd && e0 + e < hd)
                      ? cb[(int64_t)(dt + d) * hd + e0 + e] : 0.f;
      }
      __syncthreads();
      if (t < L) {                       // den += qd . n over the tile
        float part = 0.f;
        for (int d = 0; d < TD; ++d)
          part = fmaf(qd[t * (TD + 1) + d], nv[dt + d], part);
        den[t] += part;
      }
      float cn[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cn[r][c] = 0.f;
#pragma unroll 4
      for (int x = 0; x < TD; ++x) {
        // x runs over C's rows for out += qd C and over the chunk's
        // tokens for the update (TD == L)
        float qv[4], cv[4], kv[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = qd[(ty * 4 + r) * (TD + 1) + x];
          kv[r] = kw[x * (TD + 1) + ty * 4 + r];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cv[c] = ct[x * BE + tx + 16 * c];
          vv[c] = vs[x * BE + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(qv[r], cv[c], acc[r][c]);
            cn[r][c] = fmaf(kv[r], vv[c], cn[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = dt + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = e0 + tx + 16 * c;
          if (d < hd && e < hd)
            cb[(int64_t)d * hd + e] =
                fmaf(decay, ct[(ty * 4 + r) * BE + tx + 16 * c], cn[r][c]);
        }
      }
      __syncthreads();                   // den has read the old n
      if (t < TD && dt + t < hd) {
        float sum = 0.f;
        for (int j = 0; j < L; ++j) sum += kw[j * (TD + 1) + t];
        nv[dt + t] = fmaf(decay, nv[dt + t], sum);
      }
    }
    __syncthreads();                     // den is complete
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      const float inv = 1.f / fmaxf(fabsf(den[i]), 1.f);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = e0 + tx + 16 * c;
        if (e < hd) h[(row0 + i) * hd + e] = from_f<T>(acc[r][c] * inv);
      }
    }
  }
  if (blockIdx.x == 0) {
    __syncthreads();
    for (int d = t; d < hd; d += THREADS) n_out[(int64_t)bh * hd + d] = nv[d];
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* ig, const void* fg, void* sc, void* den_intra,
                  const void* n0, void* cbuf, void* n_out, void* h, int bh,
                  int s, int hd, float scale, cudaStream_t st) {
  const int nc = s / L;
  scores_kernel<T><<<dim3(nc, bh), THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const float*)ig, (const float*)fg,
      (float*)sc, (float*)den_intra, s, hd, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * carry_smem_floats(hd);
  err = cudaFuncSetAttribute(carry_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  carry_kernel<T><<<dim3((hd + BE - 1) / BE, bh), THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ig,
      (const float*)fg, (const float*)sc, (const float*)den_intra,
      (const float*)n0, (float*)cbuf, (float*)n_out, (T*)h, s, hd, scale);
  return (int)cudaGetLastError();
}

// The chunk the wrapper pads S to.
extern "C" int mlstm_chunk_len() { return L; }

// Returns 0 or a cudaError_t.  The caller checks dtypes and shapes, pads
// S to a multiple of L, fills cbuf with the initial C and passes n0
// (zeros where there is none); sc (BH, S/L, L, L) and den_intra
// (BH, S/L, L) are float32 scratch.

extern "C" int mlstm_chunkwise_launch(const void* q, const void* k,
                                      const void* v, const void* ig,
                                      const void* fg, void* sc,
                                      void* den_intra, const void* n0,
                                      void* cbuf, void* n_out, void* h,
                                      int bh, int s, int hd, double scale,
                                      int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % L != 0 ||
      hd <= 0 || hd > 8192)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, ig, fg, sc, den_intra, n0, cbuf,
                                 n_out, h, bh, s, hd, (float)scale, st);
  return launch<float>(q, k, v, ig, fg, sc, den_intra, n0, cbuf, n_out, h,
                       bh, s, hd, (float)scale, st);
}
