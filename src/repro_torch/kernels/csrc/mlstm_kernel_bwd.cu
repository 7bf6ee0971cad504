// The gradient of the chunkwise mLSTM for Hopper (sm_90a), q, k, v in
// float32 or bfloat16, every sum in float32 on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp
// chunkwise form (src/repro/models/xlstm.py mlstm_chunkwise) and has no
// backward Pallas kernel.  This is the gradient of the forward kernels
// csrc/mlstm_kernel.cu and csrc/mlstm_kernel_sm90.cu, which replace
// src/repro/kernels/mlstm_kernel.py (wrapper mlstm_chunkwise): for each
// chunk of L tokens, with li = min(i_raw, 8), a = cumsum_chunk(log
// sigmoid(f_raw)), qd_i = q_i / sqrt(hd) exp(a_i),
// S_ij = (q_i . k_j) / sqrt(hd) exp(a_i - a_j + li_j) (j <= i),
// w_j = exp(a_L - a_j + li_j) and the chunk-start carry (C, n):
//   out_i = qd_i C + sum_j S_ij v_j,  den_i = qd_i . n + sum_j S_ij,
//   h_i = out_i / m_i with m_i = max(|den_i|, 1),
//   C <- exp(a_L) C + sum_j w_j k_j v_j^T,  n <- exp(a_L) n + sum_j w_j k_j.
// Given dh (and the gradients dC, dn of the final carry, or zeros):
//   u_i = C dh_i, dh.out_i = qd_i . u_i + sum_j S_ij (v_j . dh_i),
//   dden_i = -dh.out_i / m_i^2 sign(den_i) where |den_i| >= 1, else 0,
//   dS_ij = (v_j . dh_i) / m_i + dden_i,  dS~_ij = dS_ij S_ij / (q_i . k_j),
//   dq_i = qd_i / q_i (u_i / m_i + n dden_i) + sum_j dS~_ij k_j,
//   dk_j = sum_i dS~_ij q_i + w_j (dC' v_j + dn'),
//   dv_j = sum_i S_ij / m_i dh_i + w_j dC'^T k_j,
//   dC <- exp(a_L) dC' + sum_i qd_i (dh_i / m_i)^T,
//   dn <- exp(a_L) dn' + sum_i qd_i dden_i,
// where (dC', dn') is the gradient of the chunk's end carry; and through
// the exponents, with G_ij = dS_ij S_ij: a_i gets sum_j G_ij - sum_m
// G_mi + qd_i . u_i / m_i + (qd_i . n) dden_i - E_i, li_j gets
// sum_i G_ij + E_j, a_L gets sum_j E_j + exp(a_L) (<dC', C> + dn' . n),
// with E_j = w_j k_j . (dC' v_j + dn'); a reverse cumsum within the
// chunk gives the log forget gate's, then df_raw = that sigmoid(-f_raw)
// and di_raw = dli where i_raw <= 8 (0 above: the cap).
//
// Bound on the H100: operations.  About 10 hd^2 + 10 L hd FLOPs per token
// and head (the state recompute, C dh, the carry update, dC' v and
// dC'^T k; the L x L products): at xlstm's train shape (BH = 16, S =
// 1,024, hd = 1,024) 182.6 GFLOP, 2.73 ms at the float32 CUDA-core peak
// of 67 TFLOP/s.  The chunk-start states are stored for the call (1.07 GB
// there, written and read once more: 0.64 ms at 3.35 TB/s).
//
// The trap is the width, as in the forward: a head's C is hd x hd (4 MB
// at hd = 1,024), so no block holds a state or its gradient, and every
// sum across the blocks that split one goes through a workspace and is
// added in a fixed order (no atomics: two calls give the same bits).
// Six kernels, each on the forward's 64 x 64 tiles (thread t of 256 owns
// a 4 x 4 micro-tile: rows 4 (t / 16) .. + 3, columns (t % 16) + 16 c;
// tiles read down a column padded by one float):
//  1. mlstm_bwd_states, one block per (64 columns of C, bh), the chunks in
//     order: stores each chunk's start C (slab) and n into the workspace.
//  2. mlstm_bwd_u, one block per (64 rows of C, chunk, bh): u = C dh for its
//     rows into a workspace, and its part of qd . u per row.
//  3. mlstm_bwd_intra, one block per (chunk, bh): S, v . dh and q . n, then m,
//     dden and dS from the row parts of qd . u (summed in block order);
//     dq whole, the chunk-internal parts of dk and dv into workspaces, and
//     the gates' chunk-internal parts per row.
//  4. mlstm_bwd_walk, one block per (64 columns of dC, bh), the chunks in
//     reverse: dC' (from the final carry's gradient) and dn' (block 0)
//     over the stored C, whose slab it overwrites with dC'; dv whole
//     (w dC'^T k for its columns), the block's part of <dC', C> per
//     chunk, and the carry update; the last dC and dn are dc0, dn0.
//  5. mlstm_bwd_dk, one block per (64 rows, chunk, bh): dC' v from the stored
//     dC', dk whole, and its part of E per row.
//  6. mlstm_bwd_gates, one block per (chunk, bh): E and a_L's terms summed in
//     block order, the reverse cumsum, di_raw and df_raw.
// The padded tail (q = k = v = 0, i_raw = -1e30, f_raw = +1e30, dh = 0)
// has S = 0 and w = 0 and passes no gradient; the wrapper drops its rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define L 64            // chunk
#define T64 64          // every tile is 64 x 64: rows or columns of C, hd
#define P65 65          // the row stride of a tile read down its columns
#define THREADS 256
#define I_CAP 8.0f
#define ROW_FIELDS 4    // per row: 1 / m, dden, a's part, li's part

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

// li and a of one chunk into shared memory (one thread adds the L terms
// in order, as the forward does).  Needs blockDim.x >= L.
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

// acc[r][c] += sum_x A(4 ty + r, x) B(x, tx + 16 c) over x < 64, with
// A(i, x) = A[i * AI + x * AX] and B(x, j) = B[x * BX + j * BJ].
template <int AI, int AX, int BX, int BJ>
__device__ __forceinline__ void mm64(float (&acc)[4][4], const float* A,
                                     const float* B, int ty, int tx) {
#pragma unroll 4
  for (int x = 0; x < T64; ++x) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ty * 4 + r) * AI + x * AX];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = B[x * BX + (tx + 16 * c) * BJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// A 64 x 64 tile of a (rows, hd) tensor into shared memory at row stride
// P65: rows row0.. (zeros from row n_rows of the tile on), columns col0..
// (zeros past hd), times scale and mul[row] if given.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row0, int col0, int hd,
                                          const float* mul = nullptr,
                                          float scale = 1.f,
                                          int n_rows = T64) {
  for (int idx = threadIdx.x; idx < T64 * T64; idx += THREADS) {
    const int r = idx / T64, c = idx % T64;
    float x = 0.f;
    if (col0 + c < hd && r < n_rows) {
      x = to_f(src[(row0 + r) * hd + col0 + c]) * scale;
      if (mul != nullptr) x *= mul[r];
    }
    dst[r * P65 + c] = x;
  }
}

// The sum over the 16 threads of a half-warp (one row group ty).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------- 1

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_states(const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ ig, const float* __restrict__ fg,
           const float* __restrict__ c0, const float* __restrict__ n0,
           float* __restrict__ ws_c, float* __restrict__ ws_n, int s,
           int hd) {
  extern __shared__ float smem[];
  const int hd_pad = (hd + T64 - 1) / T64 * T64;
  float* kw = smem;                  // L x P65
  float* vs = kw + L * P65;          // L x P65
  float* nv = vs + L * P65;          // hd_pad
  float* li = nv + hd_pad;           // L
  float* a = li + L;
  float* wc = a + L;
  const int e0 = blockIdx.x * T64, bh = blockIdx.y;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int nc = s / L;
  const bool lead = blockIdx.x == 0;  // keeps n
  if (lead)
    for (int d = t; d < hd_pad; d += THREADS)
      nv[d] = (d < hd && n0 != nullptr) ? n0[(int64_t)bh * hd + d] : 0.f;
  for (int ch = 0; ch < nc; ++ch) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    float* cur = ws_c + ((int64_t)bh * nc + ch) * hd * hd;
    const float* src =
        ch == 0 ? (c0 == nullptr ? nullptr : c0 + (int64_t)bh * hd * hd)
                : cur;
    __syncthreads();
    chunk_gates(ig + row0, fg + row0, li, a);
    const float decay = expf(a[L - 1]);
    if (t < L) wc[t] = expf(a[L - 1] - a[t] + li[t]);
    if (lead)
      for (int d = t; d < hd; d += THREADS)
        ws_n[((int64_t)bh * nc + ch) * hd + d] = nv[d];
    __syncthreads();
    load_tile(vs, v, row0, e0, hd);
    for (int dt = 0; dt < hd; dt += T64) {
      __syncthreads();
      load_tile(kw, k, row0, dt, hd, wc);
      float old[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = dt + ty * 4 + r, e = e0 + tx + 16 * c;
          old[r][c] = 0.f;
          if (d < hd && e < hd) {
            const int64_t off = (int64_t)d * hd + e;
            if (src != nullptr) old[r][c] = src[off];
            if (ch == 0) cur[off] = old[r][c];
          }
        }
      __syncthreads();
      if (ch + 1 < nc) {
        float acc[4][4];
        zero(acc);
        mm64<1, P65, P65, 1>(acc, kw, vs, ty, tx);  // (kw^T v)[d, e]
        float* nxt = cur + (int64_t)hd * hd;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int d = dt + ty * 4 + r, e = e0 + tx + 16 * c;
            if (d < hd && e < hd)
              nxt[(int64_t)d * hd + e] = fmaf(decay, old[r][c], acc[r][c]);
          }
      }
      if (lead && t < T64 && dt + t < hd) {
        float sum = 0.f;
        for (int j = 0; j < L; ++j) sum += kw[j * P65 + t];
        nv[dt + t] = fmaf(decay, nv[dt + t], sum);
      }
    }
  }
}

// ---------------------------------------------------------------- 2

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_u(const T* __restrict__ q, const T* __restrict__ dh,
      const float* __restrict__ ig, const float* __restrict__ fg,
      const float* __restrict__ ws_c, float* __restrict__ ws_u,
      float* __restrict__ ws_x, int s, int hd, float scale) {
  extern __shared__ float smem[];
  float* dhs = smem;                 // L x P65: dh[i, e]
  float* cs = dhs + L * P65;         // 64 x P65: C[d, e], then qd[i, d]
  float* li = cs + T64 * P65;
  float* a = li + L;
  float* dec = a + L;
  const int d0 = blockIdx.x * T64, ch = blockIdx.y, bh = blockIdx.z;
  const int nc = gridDim.y, n_rb = gridDim.x;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const float* cc = ws_c + ((int64_t)bh * nc + ch) * hd * hd;
  chunk_gates(ig + row0, fg + row0, li, a);
  if (t < L) dec[t] = expf(a[t]);
  float acc[4][4];
  zero(acc);
  for (int et = 0; et < hd; et += T64) {
    __syncthreads();
    load_tile(dhs, dh, row0, et, hd);
    load_tile(cs, cc, (int64_t)d0, et, hd, nullptr, 1.f, hd - d0);
    __syncthreads();
    mm64<P65, 1, 1, P65>(acc, dhs, cs, ty, tx);  // sum_e dh[i, e] C[d, e]
  }
  __syncthreads();
  load_tile(cs, q, row0, d0, hd, dec, scale);  // qd[i, d]
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + tx + 16 * c;
      if (d < hd) {
        ws_u[(row0 + i) * hd + d] = acc[r][c];
        part = fmaf(cs[i * P65 + tx + 16 * c], acc[r][c], part);
      }
    }
    part = half_warp_sum(part);
    if (tx == 0)
      ws_x[(((int64_t)bh * nc + ch) * n_rb + blockIdx.x) * L + i] = part;
  }
}

// ---------------------------------------------------------------- 3

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_intra(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dh,
          const float* __restrict__ ig, const float* __restrict__ fg,
          const float* __restrict__ ws_n, const float* __restrict__ ws_u,
          const float* __restrict__ ws_x, float* __restrict__ ws_rows,
          float* __restrict__ dk32, float* __restrict__ dv32,
          T* __restrict__ dq, int s, int hd, int n_rb, float scale) {
  extern __shared__ float smem[];
  const int hd_pad = (hd + T64 - 1) / T64 * T64;
  float* qs = smem;                  // L x P65 each: q, k, v, dh tiles
  float* ks = qs + L * P65;
  float* vs = ks + L * P65;
  float* dhs = vs + L * P65;
  float* sp = dhs + L * P65;         // S, then S / m
  float* gp = sp + L * P65;          // v . dh, then G
  float* dp = gp + L * P65;          // dS~
  float* nv = dp + L * P65;          // hd_pad
  float* li = nv + hd_pad;
  float* a = li + L;
  float* dec = a + L;
  float* inv_m = dec + L;
  float* dden = inv_m + L;
  float* rr = dden + L;              // a's inter part, then a's part
  float* colg = rr + L;
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  chunk_gates(ig + row0, fg + row0, li, a);
  if (t < L) dec[t] = expf(a[t]);
  for (int d = t; d < hd_pad; d += THREADS)
    nv[d] = d < hd ? ws_n[((int64_t)bh * nc + ch) * hd + d] : 0.f;

  // S (before its gates), v . dh and q . n over the head dim
  float acc_s[4][4], acc_v[4][4];
  zero(acc_s);
  zero(acc_v);
  float qn = 0.f;
  for (int dt = 0; dt < hd; dt += T64) {
    __syncthreads();
    load_tile(qs, q, row0, dt, hd);
    load_tile(ks, k, row0, dt, hd);
    load_tile(vs, v, row0, dt, hd);
    load_tile(dhs, dh, row0, dt, hd);
    __syncthreads();
    mm64<P65, 1, 1, P65>(acc_s, qs, ks, ty, tx);
    mm64<P65, 1, 1, P65>(acc_v, dhs, vs, ty, tx);
    if (t < L)
      for (int d = 0; d < T64; ++d) qn = fmaf(qs[t * P65 + d], nv[dt + d], qn);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty * 4 + r, j = tx + 16 * c;
      sp[i * P65 + j] =
          j <= i ? acc_s[r][c] * scale * expf(a[i] - a[j] + li[j]) : 0.f;
      gp[i * P65 + j] = acc_v[r][c];
    }
  __syncthreads();
  if (t < L) {                       // the row's scalars
    const int i = t;
    const float den_inter = scale * dec[i] * qn;
    float den = den_inter, intra = 0.f, x = 0.f;
    for (int j = 0; j < L; ++j) {
      den += sp[i * P65 + j];
      intra = fmaf(sp[i * P65 + j], gp[i * P65 + j], intra);
    }
    const float* xs = ws_x + ((int64_t)bh * nc + ch) * n_rb * L + i;
    for (int b = 0; b < n_rb; ++b) x += xs[(int64_t)b * L];
    const float m = fmaxf(fabsf(den), 1.f);
    const float im = 1.f / m;
    const float dd = fabsf(den) >= 1.f
                         ? -(x + intra) * im * im * (den > 0.f ? 1.f : -1.f)
                         : 0.f;
    inv_m[i] = im;
    dden[i] = dd;
    rr[i] = fmaf(x, im, den_inter * dd);
  }
  __syncthreads();
  for (int idx = t; idx < L * L; idx += THREADS) {
    const int i = idx / L, j = idx % L;
    float g = 0.f, dst = 0.f, pm = 0.f;
    if (j <= i) {
      const float sij = sp[i * P65 + j];
      const float ds = fmaf(gp[i * P65 + j], inv_m[i], dden[i]);
      g = ds * sij;
      dst = ds * scale * expf(a[i] - a[j] + li[j]);
      pm = sij * inv_m[i];
    }
    gp[i * P65 + j] = g;
    dp[i * P65 + j] = dst;
    sp[i * P65 + j] = pm;
  }
  __syncthreads();
  if (t >= L && t < 2 * L) {         // column sums of G
    const int j = t - L;
    float sum = 0.f;
    for (int i = 0; i < L; ++i) sum += gp[i * P65 + j];
    colg[j] = sum;
  }
  __syncthreads();
  if (t < L) {                       // row sums of G, and the row's record
    float sum = 0.f;
    for (int j = 0; j < L; ++j) sum += gp[t * P65 + j];
    float* rec = ws_rows + (row0 + t) * ROW_FIELDS;
    rec[0] = inv_m[t];
    rec[1] = dden[t];
    rec[2] = sum - colg[t] + rr[t];
    rec[3] = colg[t];
  }

  // dq whole; dk and dv inside the chunk
  for (int dt = 0; dt < hd; dt += T64) {
    __syncthreads();
    load_tile(qs, q, row0, dt, hd);
    load_tile(ks, k, row0, dt, hd);
    load_tile(dhs, dh, row0, dt, hd);
    __syncthreads();
    float aq[4][4], ak[4][4], av[4][4];
    zero(aq);
    zero(ak);
    zero(av);
    mm64<P65, 1, P65, 1>(aq, dp, ks, ty, tx);   // sum_j dS~[i, j] k[j, d]
    mm64<1, P65, P65, 1>(ak, dp, qs, ty, tx);   // sum_i dS~[i, j] q[i, d]
    mm64<1, P65, P65, 1>(av, sp, dhs, ty, tx);  // sum_i S/m[i, j] dh[i, d]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = dt + tx + 16 * c;
        if (d >= hd) continue;
        const int64_t off = (row0 + i) * hd + d;
        const float inter =
            scale * dec[i] * fmaf(ws_u[off], inv_m[i], nv[d] * dden[i]);
        dq[off] = from_f<T>(inter + aq[r][c]);
        dk32[off] = ak[r][c];
        dv32[off] = av[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------- 4

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_walk(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ dh, const float* __restrict__ ig,
         const float* __restrict__ fg, const float* __restrict__ dc_final,
         const float* __restrict__ dn_final,
         const float* __restrict__ ws_rows, const float* __restrict__ ws_n,
         const float* __restrict__ dv32, float* __restrict__ ws_c,
         float* __restrict__ ws_dn, float* __restrict__ ws_dd,
         float* __restrict__ dc, float* __restrict__ dn_out,
         T* __restrict__ dv, int s, int hd, float scale) {
  extern __shared__ float smem[];
  const int hd_pad = (hd + T64 - 1) / T64 * T64;
  float* kt = smem;                  // L x P65: k[j, d]
  float* qd = kt + L * P65;          // L x P65: qd[i, d]
  float* dos = qd + L * P65;         // L x P65: dh[i, e] / m_i
  float* dcs = dos + L * P65;        // 64 x P65: dC'[d, e]
  float* dnv = dcs + T64 * P65;      // hd_pad
  float* red = dnv + hd_pad;         // THREADS
  float* li = red + THREADS;
  float* a = li + L;
  float* dec = a + L;
  float* wc = dec + L;
  float* inv_m = wc + L;
  float* dden = inv_m + L;
  const int e0 = blockIdx.x * T64, bh = blockIdx.y;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int nc = s / L, n_cb = gridDim.x;
  const bool lead = blockIdx.x == 0;  // keeps dn
  float* dcb = dc + (int64_t)bh * hd * hd;
  const float* dc_last =
      dc_final == nullptr ? nullptr : dc_final + (int64_t)bh * hd * hd;
  if (lead)
    for (int d = t; d < hd_pad; d += THREADS)
      dnv[d] = (d < hd && dn_final != nullptr) ? dn_final[(int64_t)bh * hd + d]
                                               : 0.f;
  for (int ch = nc - 1; ch >= 0; --ch) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const int64_t cidx = (int64_t)bh * nc + ch;
    float* cc = ws_c + cidx * hd * hd;
    const float* src = ch == nc - 1 ? dc_last : dcb;
    __syncthreads();
    chunk_gates(ig + row0, fg + row0, li, a);
    const float decay = expf(a[L - 1]);
    if (t < L) {
      dec[t] = expf(a[t]);
      wc[t] = expf(a[L - 1] - a[t] + li[t]);
      inv_m[t] = ws_rows[(row0 + t) * ROW_FIELDS];
      dden[t] = ws_rows[(row0 + t) * ROW_FIELDS + 1];
    }
    float part = 0.f;                // its share of <dC', C> (+ dn' . n)
    if (lead)
      for (int d = t; d < hd; d += THREADS) {
        ws_dn[cidx * hd + d] = dnv[d];
        part = fmaf(dnv[d], ws_n[cidx * hd + d], part);
      }
    __syncthreads();
    load_tile(dos, dh, row0, e0, hd, inv_m);
    float az[4][4];
    zero(az);
    for (int dt = 0; dt < hd; dt += T64) {
      __syncthreads();
      load_tile(kt, k, row0, dt, hd);
      load_tile(qd, q, row0, dt, hd, dec, scale);
      float old[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dr = ty * 4 + r, ec = tx + 16 * c;
          const int d = dt + dr, e = e0 + ec;
          old[r][c] = 0.f;
          if (d < hd && e < hd) {
            const int64_t off = (int64_t)d * hd + e;
            if (src != nullptr) old[r][c] = src[off];
            part = fmaf(old[r][c], cc[off], part);
            cc[off] = old[r][c];     // the stored C becomes dC'
          }
          dcs[dr * P65 + ec] = old[r][c];
        }
      __syncthreads();
      mm64<P65, 1, P65, 1>(az, kt, dcs, ty, tx);  // sum_d k[j, d] dC'[d, e]
      float au[4][4];
      zero(au);
      mm64<1, P65, P65, 1>(au, qd, dos, ty, tx);  // sum_i qd[i, d] do[i, e]
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = dt + ty * 4 + r, e = e0 + tx + 16 * c;
          if (d < hd && e < hd)
            dcb[(int64_t)d * hd + e] = fmaf(decay, old[r][c], au[r][c]);
        }
      if (lead && t < T64 && dt + t < hd) {
        float sum = 0.f;
        for (int i = 0; i < L; ++i) sum = fmaf(qd[i * P65 + t], dden[i], sum);
        dnv[dt + t] = fmaf(decay, dnv[dt + t], sum);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = e0 + tx + 16 * c;
        if (e < hd) {
          const int64_t off = (row0 + j) * hd + e;
          dv[off] = from_f<T>(fmaf(wc[j], az[r][c], dv32[off]));
        }
      }
    }
    red[t] = part;
    __syncthreads();
    if (t == 0) {
      float sum = 0.f;
      for (int i = 0; i < THREADS; ++i) sum += red[i];
      ws_dd[cidx * n_cb + blockIdx.x] = sum;
    }
  }
  if (lead) {
    __syncthreads();
    for (int d = t; d < hd; d += THREADS) dn_out[(int64_t)bh * hd + d] = dnv[d];
  }
}

// ---------------------------------------------------------------- 5

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_dk(const T* __restrict__ k, const T* __restrict__ v,
       const float* __restrict__ ig, const float* __restrict__ fg,
       const float* __restrict__ ws_c, const float* __restrict__ ws_dn,
       const float* __restrict__ dk32, float* __restrict__ ws_e,
       T* __restrict__ dk, int s, int hd) {
  extern __shared__ float smem[];
  float* vs = smem;                  // L x P65: v[j, e], then k[j, d]
  float* dcs = vs + L * P65;         // 64 x P65: dC'[d, e]
  float* dnp = dcs + T64 * P65;      // 64: dn'[d]
  float* li = dnp + T64;
  float* a = li + L;
  float* wc = a + L;
  const int d0 = blockIdx.x * T64, ch = blockIdx.y, bh = blockIdx.z;
  const int nc = gridDim.y, n_rb = gridDim.x;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* dcc = ws_c + cidx * hd * hd;
  chunk_gates(ig + row0, fg + row0, li, a);
  if (t < L) wc[t] = expf(a[L - 1] - a[t] + li[t]);
  if (t < T64) dnp[t] = d0 + t < hd ? ws_dn[cidx * hd + d0 + t] : 0.f;
  float acc[4][4];
  zero(acc);
  for (int et = 0; et < hd; et += T64) {
    __syncthreads();
    load_tile(vs, v, row0, et, hd);
    load_tile(dcs, dcc, (int64_t)d0, et, hd, nullptr, 1.f, hd - d0);
    __syncthreads();
    mm64<P65, 1, 1, P65>(acc, vs, dcs, ty, tx);  // sum_e v[j, e] dC'[d, e]
  }
  __syncthreads();
  load_tile(vs, k, row0, d0, hd);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty * 4 + r;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dc_ = tx + 16 * c, d = d0 + dc_;
      if (d < hd) {
        const float y = acc[r][c] + dnp[dc_];
        const int64_t off = (row0 + j) * hd + d;
        dk[off] = from_f<T>(fmaf(wc[j], y, dk32[off]));
        part = fmaf(vs[j * P65 + dc_], y, part);
      }
    }
    part = half_warp_sum(part);
    if (tx == 0) ws_e[(cidx * n_rb + blockIdx.x) * L + j] = part;
  }
}

// ---------------------------------------------------------------- 6

__global__ void __launch_bounds__(L)
mlstm_bwd_gates(const float* __restrict__ ig, const float* __restrict__ fg,
          const float* __restrict__ ws_rows, const float* __restrict__ ws_e,
          const float* __restrict__ ws_dd, float* __restrict__ di,
          float* __restrict__ df, int s, int n_rb, int n_cb) {
  __shared__ float li[L], a[L], da[L], es[L];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  chunk_gates(ig + row0, fg + row0, li, a);
  float e = 0.f;
  for (int b = 0; b < n_rb; ++b) e += ws_e[(cidx * n_rb + b) * L + t];
  e *= expf(a[L - 1] - a[t] + li[t]);
  const float* rec = ws_rows + (row0 + t) * ROW_FIELDS;
  const float dli = rec[3] + e;
  da[t] = rec[2] - e;
  es[t] = e;
  __syncthreads();
  if (t == 0) {
    float sum = 0.f, dd = 0.f;
    for (int j = 0; j < L; ++j) sum += es[j];
    for (int b = 0; b < n_cb; ++b) dd += ws_dd[cidx * n_cb + b];
    da[L - 1] += sum + expf(a[L - 1]) * dd;
    float run = 0.f;                 // the reverse cumsum: d log f
    for (int j = L - 1; j >= 0; --j) {
      run += da[j];
      da[j] = run;
    }
  }
  __syncthreads();
  df[row0 + t] = da[t] / (1.f + expf(fg[row0 + t]));  // sigmoid(-f_raw)
  di[row0 + t] = ig[row0 + t] <= I_CAP ? dli : 0.f;
}

// ---------------------------------------------------------------- launch

struct Ws {
  float *c, *n, *dn, *u, *dk32, *dv32, *x, *rows, *e, *dd;
};

static int64_t ws_layout(int bh, int s, int hd, Ws* w, float* base) {
  const int64_t nc = s / L, n_b = (hd + T64 - 1) / T64;
  const int64_t sizes[10] = {(int64_t)bh * nc * hd * hd,  // c, then dC'
                             (int64_t)bh * nc * hd,       // n
                             (int64_t)bh * nc * hd,       // dn'
                             (int64_t)bh * s * hd,        // u
                             (int64_t)bh * s * hd,        // dk inside
                             (int64_t)bh * s * hd,        // dv inside
                             (int64_t)bh * nc * n_b * L,  // qd . u parts
                             (int64_t)bh * s * ROW_FIELDS,
                             (int64_t)bh * nc * n_b * L,  // E parts
                             (int64_t)bh * nc * n_b};     // <dC', C> parts
  float** ptrs[10] = {&w->c, &w->n, &w->dn, &w->u, &w->dk32, &w->dv32,
                      &w->x, &w->rows, &w->e, &w->dd};
  int64_t off = 0;
  for (int i = 0; i < 10; ++i) {
    if (w != nullptr) *ptrs[i] = base + off;
    off += (sizes[i] + 3) & ~(int64_t)3;  // 16-byte aligned parts
  }
  return off;
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* dh, const float* ig, const float* fg,
                  const float* c0, const float* n0, const float* dc_final,
                  const float* dn_final, void* dq, void* dk, void* dv,
                  float* di, float* df, float* dc0, float* dn0, float* base,
                  int bh, int s, int hd, float scale, cudaStream_t st) {
  Ws w;
  ws_layout(bh, s, hd, &w, base);
  const int nc = s / L, n_b = (hd + T64 - 1) / T64;
  const int hd_pad = n_b * T64;
  const size_t tile = sizeof(float) * L * P65;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const T* dht = (const T*)dh;

  size_t smem = 2 * tile + sizeof(float) * (hd_pad + 3 * L);
  cudaError_t err = allow_smem(mlstm_bwd_states<T>, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_states<T><<<dim3(n_b, bh), THREADS, smem, st>>>(
      kt, vt, ig, fg, c0, n0, w.c, w.n, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = 2 * tile + sizeof(float) * 3 * L;
  if ((err = allow_smem(mlstm_bwd_u<T>, smem)) != cudaSuccess) return (int)err;
  mlstm_bwd_u<T><<<dim3(n_b, nc, bh), THREADS, smem, st>>>(
      qt, dht, ig, fg, w.c, w.u, w.x, s, hd, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = 7 * tile + sizeof(float) * (hd_pad + 8 * L);
  err = allow_smem(mlstm_bwd_intra<T>, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_intra<T><<<dim3(nc, bh), THREADS, smem, st>>>(
      qt, kt, vt, dht, ig, fg, w.n, w.u, w.x, w.rows, w.dk32, w.dv32, (T*)dq,
      s, hd, n_b, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = 4 * tile + sizeof(float) * (hd_pad + THREADS + 6 * L);
  err = allow_smem(mlstm_bwd_walk<T>, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_walk<T><<<dim3(n_b, bh), THREADS, smem, st>>>(
      qt, kt, dht, ig, fg, dc_final, dn_final, w.rows, w.n, w.dv32, w.c, w.dn,
      w.dd, dc0, dn0, (T*)dv, s, hd, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = 2 * tile + sizeof(float) * (T64 + 3 * L);
  if ((err = allow_smem(mlstm_bwd_dk<T>, smem)) != cudaSuccess) return (int)err;
  mlstm_bwd_dk<T><<<dim3(n_b, nc, bh), THREADS, smem, st>>>(
      kt, vt, ig, fg, w.c, w.dn, w.dk32, w.e, (T*)dk, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  mlstm_bwd_gates<<<dim3(nc, bh), L, 0, st>>>(ig, fg, w.rows, w.e, w.dd, di,
                                             df, s, n_b, n_b);
  return (int)cudaGetLastError();
}

// The chunk the wrapper pads S to.
extern "C" int mlstm_bwd_chunk_len() { return L; }

// Floats of workspace a call needs (the wrapper allocates them).
extern "C" long long mlstm_bwd_workspace_floats(int bh, int s, int hd) {
  if (bh <= 0 || s <= 0 || hd <= 0 || s % L != 0) return 0;
  return ws_layout(bh, s, hd, nullptr, nullptr);
}

// Returns 0 or a cudaError_t.  The caller checks dtypes and shapes and
// pads S to a multiple of L (dh with zeros); c0, n0, dc_final, dn_final
// may be null (zeros); dc0 (bh, hd, hd) and dn0 (bh, hd) are always
// written; ws holds mlstm_bwd_workspace_floats(...) floats, 16-byte
// aligned.
extern "C" int mlstm_chunkwise_bwd_launch(
    const void* q, const void* k, const void* v, const void* dh,
    const void* ig, const void* fg, const void* c0, const void* n0,
    const void* dc_final, const void* dn_final, void* dq, void* dk, void* dv,
    void* di, void* df, void* dc0, void* dn0, void* ws, int bh, int s,
    int hd, double scale, int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % L != 0 || s / L > 65535 ||
      hd <= 0 || hd > 8192 || ((uintptr_t)ws & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* f[6] = {(const float*)ig, (const float*)fg, (const float*)c0,
                       (const float*)n0, (const float*)dc_final,
                       (const float*)dn_final};
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, dh, f[0], f[1], f[2], f[3], f[4],
                                 f[5], dq, dk, dv, (float*)di, (float*)df,
                                 (float*)dc0, (float*)dn0, (float*)ws, bh, s,
                                 hd, (float)scale, st);
  return launch<float>(q, k, v, dh, f[0], f[1], f[2], f[3], f[4], f[5], dq,
                       dk, dv, (float*)di, (float*)df, (float*)dc0,
                       (float*)dn0, (float*)ws, bh, s, hd, (float)scale, st);
}
