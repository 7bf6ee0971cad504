// The gradient of blockwise (flash) attention for Hopper (sm_90a), float32
// FMAs on the CUDA cores, bfloat16 or float32 tensors.
//
// Who calls it.  No route of the wrapper (repro_torch.kernels.
// flash_attention) reaches it: bf16 calls go to flash_attention_bwd_sm90.cu
// and float32 calls to flash_attention_bwd_tf32x3.cu (split TF32 on the
// tensor cores, float32 accuracy).  It stays as the first design:
// flash_attention._bwd_cuda_cores launches it, in either dtype, for
// tools/flash_bwd_check.py, which times it beside the tensor-core kernels.
//
// What it replaces.  The JAX package has no backward Pallas kernel: its
// models call the jnp attention (src/repro/models/attention.py:40) and
// jax.grad differentiates that.  This kernel computes that gradient for the
// function that the forward kernel of src/repro/kernels/flash_attention.py
// (_kernel, wrapper flash_attention_flat :91) computes, and that
// repro_torch.kernels.ref.attention_flat_plain spells out: for q (B, Sq, H,
// hd), k and v (B, Sk, Hkv, hd), query head h reading kv head h / (H / Hkv),
//   o_i  = sum_j p_ij v_j,   p_ij = softmax_j(scale * q_i . k_j)
// over the visible keys j: j < Sk; j <= i when causal (top-left aligned,
// also when Sq != Sk); j > i - window when window > 0.  Given o and dO:
//   D_i   = dO_i . o_i
//   dp_ij = dO_i . v_j,   ds_ij = p_ij (dp_ij - D_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_{i, heads of the group} ds_ij q_i
//   dv_j  = sum_{i, heads of the group} p_ij dO_i
// Sums in float32, outputs in the inputs' type.  A row with no visible key
// gets dq = 0; a key no query sees gets dk = dv = 0.
//
// Bound on the H100: operations.  About 10 hd FLOPs per visible (query,
// key) pair and query head (the five products above); at the trainer's
// shape (B=4, S=1,024, 32/8 heads, hd 128, causal) 8.6e10 FLOPs, 0.087 ms
// at the bf16 tensor-core peak and 1.28 ms at the float32 peak that these
// CUDA-core kernels are held to, against 50 MB of q, k, v, o, dO, dq, dk,
// dv (0.015 ms at 3.35 TB/s).
//
// Design: two kernels, deterministic, no atomics (every output element is
// written by one block).  Neither asks the forward for its log-sum-exp: the
// first recomputes it.
// - flash_bwd_dq: one block of 256 threads per (64 query rows, head, batch
//   row).  It stages its q tile (pre-scaled) and dO tile in shared memory,
//   computes D_i from dO and o, then walks the visible key tiles twice: a
//   first pass recomputes each row's running max and sum (the forward's
//   online softmax) and so lse_i = m_i + log l_i; a second pass forms
//   p = exp(s - lse), dp, ds and accumulates dq in registers.  It writes
//   lse and D (float32, (B, H, Sq)) to a scratch for the second kernel.
// - flash_bwd_dkdv: one block per (64 key rows, kv head, batch row).  It
//   keeps its k and v tiles in shared memory, walks the query heads of its
//   group and their visible query tiles (q pre-scaled, dO, lse, D staged),
//   recomputes p from lse and accumulates dv += p^T dO and dk += ds^T q in
//   registers.
// Both use the forward's thread layout (flash_attention.cu): thread t owns
// rows 4 (t / 16) .. + 3 of its 64-row tile, the columns t % 16 + 16 c of
// the other tile (scores) and of the head dim (accumulators); the 16
// threads of a row group sit in one half-warp, so a row's reductions and
// the broadcast of p and ds into the accumulating products are half-warp
// shuffles.  Rows in shared memory are padded by one float (no bank
// conflicts in the dot products).  The tile of the other side is 64 rows
// (32 at hd above 128, for want of shared memory), and the head-dim
// columns a thread accumulates are a template parameter (4, 8 or 16), so
// hd <= 128 keeps its accumulators in 32-64 registers.  Tiles wholly
// outside the causal / window band, or past Sk or Sq, are skipped (the
// forward's band skip); the mask is the forward's predicate, visible().
// Putting the products on wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define R 64            // rows of a block's own tile
#define THREADS 256
#define ROWS 4          // of those rows per thread
#define NEG_INF_SCORE (-1e30f)
#define NO_LSE (1e30f)  // lse of a row with no visible key: exp(s - NO_LSE) = 0
#define FULL 0xffffffffu

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of a (B, S, H, hd) tensor whose innermost stride is 1.
struct Strides {
  long long b, s, h;
};

struct Problem {
  Strides q, k, v, o, dout;
  int h, hkv, sq, sk, hd, causal, window;
  float scale;
};

// The forward's mask: key kpos visible to query qpos.
__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  bool ok = qpos < p.sq && kpos < p.sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Whether a tile of queries [q0, q1] and a tile of keys [k0, k1] hold a
// visible pair at all (uniform across the block).
__device__ __forceinline__ bool tiles_meet(const Problem& p, int q0, int q1,
                                           int k0, int k1) {
  bool run = q0 < p.sq && k0 < p.sk;
  if (p.causal) run = run && k0 <= q1;
  if (p.window > 0) run = run && k1 > q0 - p.window;
  return run;
}

// Rows [first, first + n) of a (B, S, H, hd) tensor at (b, h) into shared
// memory as float32 with leading dimension ld, times mul; rows past s zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, Strides st,
                                      int b, int h, int first, int n, int s,
                                      int hd, int ld, float mul) {
  for (int idx = threadIdx.x; idx < n * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd;
    const int row = first + r;
    float x = 0.f;
    if (row < s)
      x = to_f(base[b * st.b + (long long)row * st.s + h * st.h + d]) * mul;
    dst[r * ld + d] = x;
  }
}

// ---------------------------------------------------------------------------
// dq, lse and D: one block per (64 query rows, head, batch row)
// ---------------------------------------------------------------------------

template <typename T, int COLS, int TK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ lse_out, float* __restrict__ d_out,
             const Problem p) {
  constexpr int KJ = TK / 16;           // keys per thread and key tile
  extern __shared__ float smem[];
  const int ld = p.hd + 1;
  float* qs = smem;                     // R x ld, q * scale
  float* dos = qs + R * ld;             // R x ld, dO
  float* ks = dos + R * ld;             // TK x ld
  float* vs = ks + TK * ld;             // TK x ld

  const int q_first = blockIdx.x * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.hkv);
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;

  stage(qs, q, p.q, b, h, q_first, R, p.sq, p.hd, ld, p.scale);
  stage(dos, dout, p.dout, b, h, q_first, R, p.sq, p.hd, ld, 1.f);

  // D_i = dO_i . o_i (o read once from device memory)
  float dsum[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q_first + tr * ROWS + i;
    float acc = 0.f;
    if (row < p.sq) {
      const T* orow = o + b * p.o.b + (long long)row * p.o.s + h * p.o.h;
      const T* drow =
          dout + b * p.dout.b + (long long)row * p.dout.s + h * p.dout.h;
      for (int d = tc; d < p.hd; d += 16) acc += to_f(drow[d]) * to_f(orow[d]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off, 16);
    dsum[i] = acc;
  }
  __syncthreads();

  const int nk = (p.sk + TK - 1) / TK;
  const int q_last = q_first + R - 1;

  // pass 1: each row's log-sum-exp over its visible keys
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF_SCORE;
    l[i] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k_first = kt * TK;
    if (!tiles_meet(p, q_first, q_last, k_first, k_first + TK - 1)) continue;
    __syncthreads();
    stage(ks, k, p.k, b, hk, k_first, TK, p.sk, p.hd, ld, 1.f);
    __syncthreads();
    float s[ROWS][KJ];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.hd; ++d) {
      float qv[ROWS], kv[KJ];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(tr * ROWS + i) * ld + d];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = ks[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_first + tr * ROWS + i;
      bool vis[KJ];
      float mx = NEG_INF_SCORE;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        vis[j] = visible(p, qpos, k_first + tc + 16 * j);
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        sum += vis[j] ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off, 16);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  float lse[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : NO_LSE;
    const int row = q_first + tr * ROWS + i;
    if (tc == 0 && row < p.sq) {
      const long long at = ((long long)b * p.h + h) * p.sq + row;
      lse_out[at] = lse[i];
      d_out[at] = dsum[i];
    }
  }

  // pass 2: dq_i = scale * sum_j p_ij (dp_ij - D_i) k_j
  float acc[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_first = kt * TK;
    if (!tiles_meet(p, q_first, q_last, k_first, k_first + TK - 1)) continue;
    __syncthreads();
    stage(ks, k, p.k, b, hk, k_first, TK, p.sk, p.hd, ld, 1.f);
    stage(vs, v, p.v, b, hk, k_first, TK, p.sk, p.hd, ld, 1.f);
    __syncthreads();
    float s[ROWS][KJ], dp[ROWS][KJ];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.hd; ++d) {
      float qv[ROWS], dv[ROWS], kv[KJ], vv[KJ];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = qs[(tr * ROWS + i) * ld + d];
        dv[i] = dos[(tr * ROWS + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = ks[(tc + 16 * j) * ld + d];
        vv[j] = vs[(tc + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }
    float ds[ROWS][KJ];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_first + tr * ROWS + i;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const bool vis = visible(p, qpos, k_first + tc + 16 * j);
        const float pij = vis ? expf(s[i][j] - lse[i]) : 0.f;
        ds[i][j] = pij * (dp[i][j] - dsum[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
#pragma unroll 4
      for (int src = 0; src < 16; ++src) {
        const int key = src + 16 * j;
        float dk[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          dk[i] = __shfl_sync(FULL, ds[i][j], src, 16);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int col = tc + 16 * c;
          if (col < p.hd) {
            const float kv = ks[key * ld + col];
#pragma unroll
            for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(dk[i], kv, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q_first + tr * ROWS + i;
    if (row >= p.sq) continue;
    T* out = dq + (((long long)b * p.sq + row) * p.h + h) * p.hd;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = tc + 16 * c;
      if (col < p.hd) out[col] = from_f<T>(acc[i][c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk and dv: one block per (64 key rows, kv head, batch row)
// ---------------------------------------------------------------------------

template <typename T, int COLS, int TQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse_in,
               const float* __restrict__ d_in, T* __restrict__ dk,
               T* __restrict__ dv, const Problem p) {
  constexpr int QJ = TQ / 16;           // queries per thread and query tile
  extern __shared__ float smem[];
  const int ld = p.hd + 1;
  float* ks = smem;                     // R x ld
  float* vs = ks + R * ld;              // R x ld
  float* qs = vs + R * ld;              // TQ x ld, q * scale
  float* dos = qs + TQ * ld;            // TQ x ld
  float* lses = dos + TQ * ld;          // TQ
  float* dsums = lses + TQ;             // TQ

  const int k_first = blockIdx.x * R;
  const int k_last = k_first + R - 1;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int qpk = p.h / p.hkv;
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;

  stage(ks, k, p.k, b, hk, k_first, R, p.sk, p.hd, ld, 1.f);
  stage(vs, v, p.v, b, hk, k_first, R, p.sk, p.hd, ld, 1.f);

  float gk[ROWS][COLS], gv[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) gk[i][c] = gv[i][c] = 0.f;

  const int nq = (p.sq + TQ - 1) / TQ;
  for (int g = 0; g < qpk; ++g) {
    const int h = hk * qpk + g;
    for (int qt = 0; qt < nq; ++qt) {
      const int q_first = qt * TQ;
      if (!tiles_meet(p, q_first, q_first + TQ - 1, k_first, k_last))
        continue;
      __syncthreads();                  // previous tile fully consumed
      stage(qs, q, p.q, b, h, q_first, TQ, p.sq, p.hd, ld, p.scale);
      stage(dos, dout, p.dout, b, h, q_first, TQ, p.sq, p.hd, ld, 1.f);
      for (int r = t; r < TQ; r += THREADS) {
        const int row = q_first + r;
        const long long at = ((long long)b * p.h + h) * p.sq + row;
        lses[r] = row < p.sq ? lse_in[at] : NO_LSE;
        dsums[r] = row < p.sq ? d_in[at] : 0.f;
      }
      __syncthreads();
      float s[ROWS][QJ], dp[ROWS][QJ];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < p.hd; ++d) {
        float kv[ROWS], vv[ROWS], qv[QJ], dv2[QJ];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          kv[i] = ks[(tr * ROWS + i) * ld + d];
          vv[i] = vs[(tr * ROWS + i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          qv[j] = qs[(tc + 16 * j) * ld + d];
          dv2[j] = dos[(tc + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dv2[j], dp[i][j]);
          }
      }
      float pr[ROWS][QJ], ds[ROWS][QJ];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int kpos = k_first + tr * ROWS + i;
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const int qr = tc + 16 * j;
          const bool vis = visible(p, q_first + qr, kpos);
          pr[i][j] = vis ? expf(s[i][j] - lses[qr]) : 0.f;
          ds[i][j] = pr[i][j] * (dp[i][j] - dsums[qr]);
        }
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
#pragma unroll 2
        for (int src = 0; src < 16; ++src) {
          const int qr = src + 16 * j;
          float pk[ROWS], dk2[ROWS];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            pk[i] = __shfl_sync(FULL, pr[i][j], src, 16);
            dk2[i] = __shfl_sync(FULL, ds[i][j], src, 16);
          }
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int col = tc + 16 * c;
            if (col < p.hd) {
              const float dov = dos[qr * ld + col];
              const float qv = qs[qr * ld + col];
#pragma unroll
              for (int i = 0; i < ROWS; ++i) {
                gv[i][c] = fmaf(pk[i], dov, gv[i][c]);
                gk[i][c] = fmaf(dk2[i], qv, gk[i][c]);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = k_first + tr * ROWS + i;
    if (row >= p.sk) continue;
    const long long at = (((long long)b * p.sk + row) * p.hkv + hk) * p.hd;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = tc + 16 * c;
      if (col < p.hd) {
        dk[at + col] = from_f<T>(gk[i][c]);
        dv[at + col] = from_f<T>(gv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename T, int COLS, int TILE>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv, float* lse,
                  float* dsum, int bsz, const Problem& p, cudaStream_t st) {
  const int ld = p.hd + 1;
  const size_t smem_dq = sizeof(float) * (size_t)(2 * R + 2 * TILE) * ld;
  const size_t smem_kv =
      sizeof(float) * ((size_t)(2 * R + 2 * TILE) * ld + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, COLS, TILE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, COLS, TILE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  if (p.sq > 0) {
    dim3 grid((p.sq + R - 1) / R, p.h, bsz);
    flash_bwd_dq<T, COLS, TILE><<<grid, THREADS, smem_dq, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
        (T*)dq, lse, dsum, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (p.sk > 0) {
    dim3 grid((p.sk + R - 1) / R, p.hkv, bsz);
    flash_bwd_dkdv<T, COLS, TILE><<<grid, THREADS, smem_kv, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
        (T*)dk, (T*)dv, p);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, void* dq, void* dk,
                    void* dv, float* lse, float* dsum, int bsz,
                    const Problem& p, cudaStream_t st) {
  if (p.hd <= 64)
    return launch<T, 4, 64>(q, k, v, o, dout, dq, dk, dv, lse, dsum, bsz, p,
                            st);
  if (p.hd <= 128)
    return launch<T, 8, 64>(q, k, v, o, dout, dq, dk, dv, lse, dsum, bsz, p,
                            st);
  return launch<T, 16, 32>(q, k, v, o, dout, dq, dk, dv, lse, dsum, bsz, p,
                           st);
}

// q, o, dout (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) through their element
// strides (innermost stride 1); dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv,
// hd) contiguous, written whole; lse and dsum float32 (B, H, Sq) scratch.
// is_bf16 picks bfloat16 (else float32) for every tensor but the scratch.
// Returns 0 or a cudaError_t.  The caller handles B == 0; at Sk == 0 the
// first kernel writes dq = 0, at Sq == 0 the second writes dk = dv = 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss, long long dsh,
    int bsz, int h, int hkv, int sq, int sk, int hd, int causal, int window,
    double scale, int is_bf16, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      bsz <= 0 || bsz > 65535 || h > 65535 || sq < 0 || sk < 0)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.q = Strides{qsb, qss, qsh};
  p.k = Strides{ksb, kss, ksh};
  p.v = Strides{vsb, vss, vsh};
  p.o = Strides{osb, oss, osh};
  p.dout = Strides{dsb, dss, dsh};
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = (float)scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<bf16>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                          (float*)dsum, bsz, p, st);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                         (float*)dsum, bsz, p, st);
}
