// The gradient of the chunkwise mLSTM in float32 on Hopper's tensor cores
// (sm_90a): every product as three TF32 mma.sync, so that the sums keep
// float32 accuracy.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp chunkwise
// form (src/repro/models/xlstm.py mlstm_chunkwise) and has no backward Pallas
// kernel.  It computes what csrc/mlstm_kernel_bwd.cu's header states (and
// ref.mlstm_chunkwise_bwd_plain), for float32 q, k, v, dh (BH, S, hd) with hd
// a multiple of 8 up to mlstm_bwd_tf32x3_max_hd() and S a multiple of the
// chunk L = 64: per chunk, with li = min(i_raw, 8), a = cumsum_chunk(log
// sigmoid(f_raw)), r_i = exp(a_i) / sqrt(hd), wc_j = exp(a_L - a_j + li_j),
// S_ij = (q_i . k_j) / sqrt(hd) exp(a_i - a_j + li_j) (j <= i), the
// chunk-start carry (C, n) and the gradient (dC', dn') of the chunk's end
// carry:
//   den_i = r_i (q_i . n) + sum_j S_ij,  m_i = max(|den_i|, 1),
//   u_i = C dh_i,  x_i = r_i q_i . u_i,  VD_ij = dh_i . v_j,
//   dden_i = -(x_i + sum_j S_ij VD_ij) / m_i^2 sign(den_i) (0 where
//   |den_i| < 1),  dS_ij = VD_ij / m_i + dden_i,  G = dS S,
//   dS~_ij = dS_ij / sqrt(hd) exp(a_i - a_j + li_j) (j <= i),
//   dq_i = r_i (u_i / m_i + n dden_i) + sum_j dS~_ij k_j,
//   dk_j = sum_i dS~_ij q_i + wc_j (y_j + dn'),  y_j = dC' v_j,
//   dv_j = sum_i (S_ij / m_i) dh_i + wc_j z_j,  z_j = dC'^T k_j,
//   dC <- exp(a_L) dC' + q^T (dh r / m),  dn <- exp(a_L) dn' + q^T (r dden),
// and the gates through their exponents (E_j = wc_j k_j . (y_j + dn'); a_i
// gets the row sums of G less its column sums, + x_i / m_i + r_i (q_i . n)
// dden_i - E_i; li_j the column sums + E_j; a_L sum_j E_j + exp(a_L)
// (<dC', C> + dn' . n); a reverse cumsum gives d log f, df_raw = that
// sigmoid(-f_raw), di_raw = dli where i_raw <= 8, 0 above).  Every output is
// float32; an absent initial carry or final-state gradient reads as zeros.
//
// The arithmetic.  A single TF32 product keeps 11 bits of each operand, so
// each float32 operand x is split, once, as it goes from shared memory or
// device memory into a fragment, into hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi) (sm90.cuh: split_tf32), and every product A B is three
// mma.sync.m16n8k8 tf32 into float32 accumulators, per k-step of 8: lo(A)
// hi(B), hi(A) lo(B), then hi(A) hi(B) (sm90.cuh: mma_tf32x3).  That covers S = q k^T, VD = dh v^T,
// u^T = C dh^T, y^T = dC' v^T, z^T = dC'^T k^T, both carries' updates, dq =
// dS~ k, the chunk-internal dk = dS~^T q and dv = (S / m)^T dh.  No operand
// is rounded below float32 otherwise: C stays float32 for u and for <dC', C>,
// each chunk's dC' is stored in float32, the gated factors k wc and dh r / m
// are formed in float32 and split like any operand.  The tensor cores'
// float32 sums do not round to nearest, and their error grows with the
// products that feed one accumulator, so the carries never accumulate
// through them: each chunk's update is summed from zero (its even and odd
// k-steps in two sums, then added) and joins the carry by one rounded fmaf
// with exp(a_L); S and VD sum each 64-column tile from zero and add the
// tiles' sums in order.  tests/test_torch_mlstm_bwd_tf32x3.py rebuilds this
// arithmetic, and these orders of sums, in plain torch.
//
// Bound on the H100: operations.  The function is about 10 hd^2 + 10 L hd
// FLOPs a token and head (182.6 GFLOP at xlstm's train shape, BH = 16, S =
// 1,024, hd = 1,024), three TF32 products each: 1.107 ms at the 494.7
// TFLOP/s dense TF32 peak (2.724 at the 67 TFLOP/s float32 CUDA-core peak of
// the first design).  It stores each chunk's dC' in float32 (BH S / L hd^2 x
// 4 bytes, 1.07 GB there, written and read once: 0.64 ms at 3.35 TB/s), and
// u, y and the chunk-internal dk (64 MB each there).  sm_90a has no tf32
// conversion instruction: ptxas expands each cvt.rna.tf32.f32 to a compare,
// an add, a select and a mask, so the split costs more instructions than its
// three products, and the tiles are shaped to split each operand element
// once a product.
//
// The structure is csrc/mlstm_kernel_bwd_sm90.cu's (six kernels, every sum
// across blocks through the workspace in a fixed order, no atomics: two calls
// give the same bits), with float32 tiles staged by 16-byte cp.async into
// rows of LDT = 72 floats (LDT % 32 == 8), zero-filled past hd and past the
// last row, so that no branch surrounds an mma.sync (ptxas wraps one under a
// run-time branch in a WARPSYNC):
//  1. mlstm_bwd_tf32x3_scores, one block of 8 warps per (chunk, bh): q k^T
//     on warps 0-3 and dh v^T on warps 4-7 (16 rows, all 64 columns a warp),
//     over hd in double-buffered tiles of 64; S gated and masked, VD, S's row
//     sums, the gates and the chunk's sum_j wc_j k_j.
//  2. mlstm_bwd_tf32x3_den, one block per (chunk, bh): the chunk-start n (a
//     scan of at most S / L steps), den, m and r / m.
//  3. mlstm_bwd_tf32x3_dwalk, one block of 8 warps per (BE = 32 columns e of
//     dC, bh), the chunks in reverse.  Its slab of dC^T (32 rows of hd float32,
//     128 KB at hd 1,024) stays in shared memory for the whole walk; a step
//     takes one 64-column tile of it, with k and q staged in a two-slot ring.
//     Warp w takes rows e 16 (w / 4) and columns d 16 (w % 4) of the step:
//     it stores its dC' in float32 for the chunk, adds z^T = dC'^T k^T, and
//     sets dC^T = exp(a_L) dC'^T + fresh, fresh = (dh r / m)^T q summed from
//     zero, with (dh r / m)^T split once a chunk into registers.  At a chunk's
//     end the four column warps' parts of z are added in order and dv = wc z
//     is written; the last slab is dc0.
//  4. mlstm_bwd_tf32x3_cwalk, one block of 8 warps per (32 rows d of C, bh),
//     the chunks in order: its slab of C, a 64-column tile a step, dh, v and
//     the stored dC' tile staged in a two-slot ring; warp w takes rows d 16 (w
//     / 4) and columns e 16 (w % 4).  u^T = C dh^T, y^T = dC' v^T, the part of
//     <dC', C> (both float32), and C = exp(a_L) C + fresh, fresh = (k wc)^T v
//     from zero.  At a chunk's end u and y are summed over the column warps
//     in order and stored, with the block's parts of x_i and k_j . y_j.
//  5. mlstm_bwd_tf32x3_intra, one block of 8 warps per (chunk, bh): x from
//     the parts, dden, dS, G's row and column sums, dS~ and S / m in shared
//     memory; per 64-column tile of hd, dq = r (u / m + n dden) + dS~ k,
//     dS~^T q (the chunk-internal dk), dv += (S / m)^T dh, and q^T (r dden)
//     for dn.
//  6. mlstm_bwd_tf32x3_gates, one block per (chunk, bh): dn' by a scan from
//     the last chunk, dk = dS~^T q + wc (y + dn') whole, E, <dC', C> + dn' .
//     n, the reverse cumsum, di_raw and df_raw; chunk 0's block writes dn0.
// m16n8k8's accumulator holds columns (2t, 2t + 1) where its A fragment wants
// (t, t + 4): where a product contracts over a slab's columns (z, u, y), each
// k-step takes its 8 columns in the order 0, 2, 4, 6, 1, 3, 5, 7 on both
// operands, so that a thread's A fragment of the slab is the accumulator
// fragment of the carry update at the same place: one 8-byte load serves
// both, with no transposed copy.  Shared memory at hd 1,024: dwalk 201 KB,
// cwalk 221 KB (mlstm_bwd_tf32x3_max_hd() is the largest hd both fit), one
// block an SM; hd / 32 x BH blocks each.
// What holds the walks (inferred from their times; no per-stall counters
// on the card): each of a head's hd / 32 blocks reads all of its k and q
// (dh and v) from L2 for every chunk, about 1.8 TB/s at the train shape;
// splitting those four operands once a call into hi and lo planes, which
// spared the blocks most of their splits, doubled those bytes and made the
// walks slower.  Not yet here: one load of a tile for the blocks of a
// cluster (TMA multicast), wgmma.
// The padded tail (q = k = v = 0, i_raw = -1e30, f_raw = +1e30, dh = 0) has
// S = 0 and wc = 0 and passes no gradient; the wrapper drops its rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define L 64              // chunk
#define DT 64             // columns of a staged tile, and of a walk's step
#define LDT 72            // floats a staged row of 64 columns (LDT % 32 == 8)
#define LDX 68            // floats a row of intra's L x L tiles (% 32 == 4)
#define LDC 36            // floats a row of cwalk's dC' tile (% 32 == 4)
#define BE 32             // slab rows of a walk block
#define THREADS 256       // every kernel: 8 warps
#define REC 8             // float rows of L a chunk's record holds
#define I_CAP 8.0f
#define SMEM_MAX 232448   // dynamic shared memory a block may opt into
#define FULL 0xffffffffu

// A chunk's record, REC rows of L floats.
enum { R_WC = 0, R_WQ, R_R, R_DECAY, R_LI, R_A, R_DEN_INTER, R_DEN };

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// 64 rows x 64 columns of a (rows, hd) float32 matrix from column d0 (src at
// its first row) into a tile of LDT floats a row; columns past hd read as
// zeros.  The caller commits.
__device__ __forceinline__ void stage64(float* dst, const float* src, int hd,
                                        int d0) {
  for (int idx = threadIdx.x; idx < L * 16; idx += THREADS) {
    const int r = idx >> 4, c = (idx & 15) * 4, d = d0 + c;
    const bool in = d < hd;
    cp_async16(smem_u32(dst + r * LDT + c), src + (int64_t)r * hd + (in ? d : 0),
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------- 1

__global__ void __launch_bounds__(THREADS)
mlstm_bwd_tf32x3_scores(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dh,
                        const float* __restrict__ ig,
                        const float* __restrict__ fg, float* __restrict__ rec,
                        float* __restrict__ sv, float* __restrict__ vd,
                        float* __restrict__ ksum, int s, int hd, float scale) {
  extern __shared__ __align__(16) float tiles[];  // [2 stages][q, k, dh, v]
  __shared__ float li[L], a[L], wc[L];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* src[4] = {q + row0 * hd, k + row0 * hd, dh + row0 * hd,
                         v + row0 * hd};
  auto tile = [&](int which, int stage) {
    return tiles + (stage * 4 + which) * L * LDT;
  };
  const int nd = (hd + DT - 1) / DT;
  for (int x = 0; x < 4; ++x) stage64(tile(x, 0), src[x], hd, 0);
  cp_async_commit();
  if (t < L) {
    li[t] = fminf(ig[row0 + t], I_CAP);
    a[t] = log_sigmoid(fg[row0 + t]);
  }
  __syncthreads();
  if (t == 0) {  // one thread adds the L log forget gates in order
    float run = 0.f;
    for (int j = 0; j < L; ++j) {
      run += a[j];
      a[j] = run;
    }
  }
  __syncthreads();
  if (t < L) wc[t] = expf(a[L - 1] - a[t] + li[t]);

  // warp w: rows 16 (w % 4) of q k^T (w < 4) or of dh v^T (w >= 4), all 64
  // columns; each k-step of 8 columns in the order 0, 2, .., 7 on both sides
  const int rb = 16 * (w & 3), pa = (w >> 2) * 2;  // A: q or dh; B: k or v
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
  float* kso = ksum + cidx * hd;
  for (int dt = 0; dt < nd; ++dt) {
    cp_async_wait<0>();
    __syncthreads();  // tile dt landed; the other stage is free
    if (dt + 1 < nd) {
      for (int x = 0; x < 4; ++x)
        stage64(tile(x, (dt + 1) & 1), src[x], hd, (dt + 1) * DT);
      cp_async_commit();
    }
    const float* at = tile(pa, dt & 1) + (rb + g) * LDT + 2 * tq;
    const float* bt = tile(pa + 1, dt & 1) + g * LDT + 2 * tq;
    float part[8][4];  // the tile's products from zero
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) part[n][x] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DT; kk += 8) {
      const float2 x0 = *reinterpret_cast<const float2*>(at + kk);
      const float2 x1 = *reinterpret_cast<const float2*>(at + 8 * LDT + kk);
      uint32_t ah[4], al[4];
      split4_tf32(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(bt + 8 * n * LDT + kk);
        mma_tf32x3f(part[n], ah, al, y.x, y.y);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] += part[n][x];
    // sum_j wc_j k_j over the tile's columns, for n
    const int d = dt * DT + t;
    if (t < DT && d < hd) {
      const float* kt = tile(1, dt & 1);
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < L; ++j) sum = fmaf(wc[j], kt[j * LDT + t], sum);
      kso[d] = sum;
    }
  }

  float* rbk = rec + cidx * REC * L;
  if (w < 4) {
    float* svb = sv + cidx * L * L;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = rb + g + 8 * half;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = 8 * nt + 2 * tq;
        const float v0 = j <= i ? acc[nt][2 * half] * scale *
                                      expf(a[i] - a[j] + li[j])
                                : 0.f;
        const float v1 = j + 1 <= i ? acc[nt][2 * half + 1] * scale *
                                          expf(a[i] - a[j + 1] + li[j + 1])
                                    : 0.f;
        sum += v0 + v1;
        *reinterpret_cast<float2*>(svb + i * L + j) = make_float2(v0, v1);
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      if (tq == 0) rbk[R_DEN * L + i] = sum;  // den adds r (q . n) later
    }
  } else {
    float* vdb = vd + cidx * L * L;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = rb + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(vdb + i * L + 8 * nt + 2 * tq) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
  if (t < L) {
    rbk[R_WC * L + t] = wc[t];
    rbk[R_R * L + t] = scale * expf(a[t]);
    rbk[R_DECAY * L + t] = t == 0 ? expf(a[L - 1]) : 0.f;
    rbk[R_LI * L + t] = li[t];
    rbk[R_A * L + t] = a[t];
  }
}

// ---------------------------------------------------------------- 2

// The n entering chunk ch (n0 decayed and summed through the earlier
// chunks), den = row sum + r (q . n), and r / m.
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_tf32x3_den(const float* __restrict__ q, float* __restrict__ rec,
                     const float* __restrict__ ksum,
                     const float* __restrict__ n0, float* __restrict__ nst,
                     int s, int hd) {
  extern __shared__ __align__(16) float nprev[];  // [hd]
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* rbh = rec + (int64_t)bh * nc * REC * L;
  const float* kbh = ksum + (int64_t)bh * nc * hd;
  for (int d = t; d < hd; d += THREADS) {
    float n = n0 ? n0[(int64_t)bh * hd + d] : 0.f;
    for (int c = 0; c < ch; ++c)
      n = fmaf(rbh[(c * REC + R_DECAY) * L], n, kbh[(int64_t)c * hd + d]);
    nprev[d] = n;
    nst[cidx * hd + d] = n;
  }
  __syncthreads();
  // 4 threads a row, each 4 columns at a time
  const int i = t >> 2, part = t & 3;
  const float* qr = q + ((int64_t)bh * s + (int64_t)ch * L + i) * hd;
  float dot = 0.f;
  for (int d = 4 * part; d < hd; d += 16) {
    const float4 x = *reinterpret_cast<const float4*>(qr + d);
    dot = fmaf(x.x, nprev[d], dot);
    dot = fmaf(x.y, nprev[d + 1], dot);
    dot = fmaf(x.z, nprev[d + 2], dot);
    dot = fmaf(x.w, nprev[d + 3], dot);
  }
  dot += __shfl_xor_sync(FULL, dot, 1);
  dot += __shfl_xor_sync(FULL, dot, 2);
  float* rb = rec + cidx * REC * L;
  if (part == 0) {
    const float r = rb[R_R * L + i];
    const float den_inter = r * dot;
    const float den = rb[R_DEN * L + i] + den_inter;
    const float im = 1.f / fmaxf(fabsf(den), 1.f);
    rb[R_DEN_INTER * L + i] = den_inter;
    rb[R_DEN * L + i] = den;
    rb[R_WQ * L + i] = r * im;
  }
}

// ---------------------------------------------------------------- 3

// Shared memory of a walk block's slab (BE rows of the padded head dim +
// 8 floats: the row stride is 8 mod 32), in floats.
static size_t slab_floats(int hd) {
  const size_t hdp = (size_t)(hd + DT - 1) / DT * DT;
  return (size_t)BE * (hdp + 8);
}

// Shared memory of a dwalk block, in bytes: the dC^T slab and two slots of
// (k, q) tiles.
static size_t dwalk_smem_bytes(int hd) {
  return sizeof(float) * (slab_floats(hd) + 2 * 2 * L * LDT);
}

__global__ void __launch_bounds__(THREADS, 1)
mlstm_bwd_tf32x3_dwalk(const float* __restrict__ k, const float* __restrict__ q,
                       const float* __restrict__ dh,
                       const float* __restrict__ rec,
                       const float* __restrict__ dc_final,
                       float* __restrict__ dct, float* __restrict__ dc0,
                       float* __restrict__ dv, int s, int hd) {
  extern __shared__ __align__(16) float smem[];
  const int nd = (hd + DT - 1) / DT, hdp = nd * DT, cst = hdp + 8;
  float* ct = smem;               // [BE][cst]: dC^T, rows e
  float* stg = ct + BE * cst;     // [2 slots][k, q][L][LDT]
  const int e0 = blockIdx.x * BE, bh = blockIdx.y, nc = s / L;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int eh = w >> 2, dq = w & 3;  // rows e 16 eh; columns d 16 dq of a step

  const float* cb = dc_final ? dc_final + (int64_t)bh * hd * hd : nullptr;
  for (int idx = t; idx < BE * hdp; idx += THREADS) {
    const int e = idx % BE, d = idx / BE;
    ct[e * cst + d] =
        (cb && d < hd && e0 + e < hd) ? cb[(int64_t)d * hd + e0 + e] : 0.f;
  }
  auto slot = [&](int sl, int which) {
    return stg + (sl * 2 + which) * L * LDT;
  };
  // step sig: chunk nc - 1 - sig / nd, columns (sig % nd) DT of k and q
  auto load_step = [&](int sig) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)(nc - 1 - sig / nd) * L;
    stage64(slot(sig & 1, 0), k + row0 * hd, hd, (sig % nd) * DT);
    stage64(slot(sig & 1, 1), q + row0 * hd, hd, (sig % nd) * DT);
    cp_async_commit();
  };

  float z[8][4];               // z^T: rows e 16 eh + g (+ 8), columns j
  uint32_t vah[8][4], val[8][4];  // (dh r / m)^T, rows e, k-steps over i
  float decay = 0.f;
  const int nsig = nc * nd;
  load_step(0);
  for (int sig = 0; sig < nsig; ++sig) {
    const int ch = nc - 1 - sig / nd, dt = sig % nd;
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const int64_t cidx = (int64_t)bh * nc + ch;
    const float* rb = rec + cidx * REC * L;
    cp_async_wait<0>();
    __syncthreads();  // step sig landed; the other slot is free
    if (sig + 1 < nsig) load_step(sig + 1);
    if (dt == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) z[n][x] = 0.f;
      const int e = e0 + 16 * eh + g;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int i0 = 8 * ks + tq, i1 = i0 + 4;
        const float w0 = rb[R_WQ * L + i0], w1 = rb[R_WQ * L + i1];
        const float* d0p = dh + (row0 + i0) * hd;
        const float* d1p = dh + (row0 + i1) * hd;
        split4_tf32(e < hd ? d0p[e] * w0 : 0.f,
                    e + 8 < hd ? d0p[e + 8] * w0 : 0.f,
                    e < hd ? d1p[e] * w1 : 0.f,
                    e + 8 < hd ? d1p[e + 8] * w1 : 0.f, vah[ks], val[ks]);
      }
      decay = rb[R_DECAY * L];
    }

    const float* kt = slot(sig & 1, 0);
    const float* qt = slot(sig & 1, 1);
    const int dl = 16 * dq;             // the warp's first column in the tile
    float* crow = ct + (16 * eh + g) * cst + dt * DT + dl + 2 * tq;
    // this step's dC' (rows e g, g + 8; columns d 2 tq, + 1 of 8 kk)
    float2 lo[2], hi[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      lo[kk] = *reinterpret_cast<const float2*>(crow + 8 * kk);
      hi[kk] = *reinterpret_cast<const float2*>(crow + 8 * cst + 8 * kk);
    }
    {  // stored, as dC'^T [e][d], for the C walk
      float* dco = dct + cidx * hd * hd;
      const int e = e0 + 16 * eh + g;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int d = dt * DT + dl + 8 * kk + 2 * tq;
        if (d < hd && e < hd)
          *reinterpret_cast<float2*>(dco + (int64_t)e * hd + d) = lo[kk];
        if (d < hd && e + 8 < hd)
          *reinterpret_cast<float2*>(dco + (int64_t)(e + 8) * hd + d) = hi[kk];
      }
    }
    uint32_t ah[2][4], al[2][4];  // dC'^T: A of z, k over d (0, 2, .., 7)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      split4_tf32(lo[kk].x, hi[kk].x, lo[kk].y, hi[kk].y, ah[kk], al[kk]);
    // x = 0 .. 7: z^T += dC'^T k^T for rows j 8 x .. + 7 over the warp's 16
    // columns d; and k-step x (rows i 8 x .. + 7) of the carry update dC^T =
    // exp(a_L) dC'^T + (dh r / m)^T q, the chunk's part summed from zero in
    // two chains by the parity of x, so that the products in flight do not
    // wait on one another
    float fr[2][2][4];  // [8-column group kk][parity of x]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int c = 0; c < 4; ++c) fr[kk][pp][c] = 0.f;
    const float* kb = kt + g * LDT + dl + 2 * tq;
    const float* qb = qt + tq * LDT + dl + g;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float2 y =
            *reinterpret_cast<const float2*>(kb + 8 * x * LDT + 8 * kk);
        mma_tf32x3f(z[x], ah[kk], al[kk], y.x, y.y);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_tf32x3f(fr[kk][x & 1], vah[x], val[x], qb[8 * x * LDT + 8 * kk],
              qb[(8 * x + 4) * LDT + 8 * kk]);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) f[c] = fr[kk][0][c] + fr[kk][1][c];
      *reinterpret_cast<float2*>(crow + 8 * kk) =
          make_float2(fmaf(decay, lo[kk].x, f[0]), fmaf(decay, lo[kk].y, f[1]));
      *reinterpret_cast<float2*>(crow + 8 * cst + 8 * kk) =
          make_float2(fmaf(decay, hi[kk].x, f[2]), fmaf(decay, hi[kk].y, f[3]));
    }

    if (dt == nd - 1) {
      // the chunk's z: the four column warps' parts added in order through
      // this step's slot, then dv = wc z (the intra kernel adds (S / m)^T dh)
      float4* red = reinterpret_cast<float4*>(slot(sig & 1, 0));
      __syncthreads();  // the slot's tiles are read
      if (dq > 0)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          red[((eh * 3 + dq - 1) * 8 + n) * 32 + lane] =
              make_float4(z[n][0], z[n][1], z[n][2], z[n][3]);
      __syncthreads();
      if (dq == 0) {
        const int e = e0 + 16 * eh + g;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const float4 r = red[((eh * 3 + p) * 8 + n) * 32 + lane];
            z[n][0] += r.x;
            z[n][1] += r.y;
            z[n][2] += r.z;
            z[n][3] += r.w;
          }
          const int j = 8 * n + 2 * tq;
          const float w0 = rb[R_WC * L + j], w1 = rb[R_WC * L + j + 1];
          float* o0 = dv + (row0 + j) * hd;
          float* o1 = o0 + hd;
          if (e < hd) {
            o0[e] = w0 * z[n][0];
            o1[e] = w1 * z[n][1];
          }
          if (e + 8 < hd) {
            o0[e + 8] = w0 * z[n][2];
            o1[e + 8] = w1 * z[n][3];
          }
        }
      }
    }
  }
  __syncthreads();
  float* co = dc0 + (int64_t)bh * hd * hd;
  for (int idx = t; idx < BE * hdp; idx += THREADS) {
    const int e = idx % BE, d = idx / BE;
    if (d < hd && e0 + e < hd) co[(int64_t)d * hd + e0 + e] = ct[e * cst + d];
  }
}

// ---------------------------------------------------------------- 4

#define CSLOT (2 * L * LDT + L * LDC)  // floats of a cwalk slot: dh, v, dC'

// Shared memory of a cwalk block, in bytes: the C slab, two slots of (dh,
// v, dC') tiles, the half blocks' parts of x and k . y, the threads' parts of
// <dC', C>.
static size_t cwalk_smem_bytes(int hd) {
  return sizeof(float) * (slab_floats(hd) + 2 * CSLOT + 2 * 2 * L + THREADS);
}

__global__ void __launch_bounds__(THREADS, 1)
mlstm_bwd_tf32x3_cwalk(const float* __restrict__ dh, const float* __restrict__ v,
                       const float* __restrict__ dct,
                       const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ rec,
                       const float* __restrict__ c0, float* __restrict__ uo,
                       float* __restrict__ yo, float* __restrict__ xp,
                       float* __restrict__ kyp, float* __restrict__ ddp, int s,
                       int hd) {
  extern __shared__ __align__(16) float smem[];
  const int nd = (hd + DT - 1) / DT, hdp = nd * DT, cst = hdp + 8;
  float* ct = smem;               // [BE][cst]: C, rows d
  float* stg = ct + BE * cst;     // [2 slots][dh, v: L x LDT; dC'^T: L x LDC]
  float* xs = stg + 2 * CSLOT;    // [2 halves][x, k . y][L]
  float* red = xs + 2 * 2 * L;    // [THREADS]
  const int d0 = blockIdx.x * BE, bh = blockIdx.y, nc = s / L;
  const int n_db = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int dr = w >> 2, eq = w & 3;  // rows d 16 dr; columns e 16 eq of a step

  const float* cb = c0 ? c0 + (int64_t)bh * hd * hd : nullptr;
  for (int idx = t; idx < BE * hdp; idx += THREADS) {
    const int e = idx % hdp, d = idx / hdp;
    ct[d * cst + e] =
        (cb && e < hd && d0 + d < hd) ? cb[(int64_t)(d0 + d) * hd + e] : 0.f;
  }
  // step sig: chunk sig / nd, columns e (sig % nd) DT of dh and v, and the
  // stored dC'^T's rows e there, columns d0 .. d0 + BE - 1
  auto load_step = [&](int sig) {
    const int ch = sig / nd, e1 = (sig % nd) * DT;
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    float* dst = stg + (sig & 1) * CSLOT;
    stage64(dst, dh + row0 * hd, hd, e1);
    stage64(dst + L * LDT, v + row0 * hd, hd, e1);
    const float* dcb = dct + ((int64_t)bh * nc + ch) * hd * hd;
    float* dcs = dst + 2 * L * LDT;
    for (int idx = t; idx < L * (BE / 4); idx += THREADS) {
      const int r = idx / (BE / 4), c = (idx % (BE / 4)) * 4;
      const bool in = e1 + r < hd && d0 + c < hd;
      cp_async16(smem_u32(dcs + r * LDC + c),
                 in ? dcb + (int64_t)(e1 + r) * hd + d0 + c : dcb, in ? 16 : 0);
    }
    cp_async_commit();
  };

  float u[8][4], y[8][4];      // u^T, y^T: rows d 16 dr + g (+ 8), columns i, j
  uint32_t kwh[8][4], kwl[8][4];  // (k wc)^T, rows d, k-steps over j
  float dot = 0.f, decay = 0.f;
  const int nsig = nc * nd;
  load_step(0);
  for (int sig = 0; sig < nsig; ++sig) {
    const int ch = sig / nd, et = sig % nd;
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const int64_t cidx = (int64_t)bh * nc + ch;
    const float* rb = rec + cidx * REC * L;
    cp_async_wait<0>();
    __syncthreads();  // step sig landed; the other slot is free
    if (sig + 1 < nsig) load_step(sig + 1);
    if (et == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) u[n][x] = y[n][x] = 0.f;
      dot = 0.f;
      const int d = d0 + 16 * dr + g;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int j0 = 8 * ks + tq, j1 = j0 + 4;
        const float w0 = rb[R_WC * L + j0], w1 = rb[R_WC * L + j1];
        const float* k0p = k + (row0 + j0) * hd;
        const float* k1p = k + (row0 + j1) * hd;
        split4_tf32(d < hd ? k0p[d] * w0 : 0.f,
                    d + 8 < hd ? k0p[d + 8] * w0 : 0.f,
                    d < hd ? k1p[d] * w1 : 0.f,
                    d + 8 < hd ? k1p[d + 8] * w1 : 0.f, kwh[ks], kwl[ks]);
      }
      decay = rb[R_DECAY * L];
    }

    const float* dht = stg + (sig & 1) * CSLOT;
    const float* vt = dht + L * LDT;
    const float* dcs = vt + L * LDT;
    const int el = 16 * eq;             // the warp's first column in the tile
    float* crow = ct + (16 * dr + g) * cst + et * DT + el + 2 * tq;
    // C at rows d g, g + 8, columns e 2 tq, + 1 of the 8-column group kk
    // (taken 0, 2, .., 7 in u and y)
    float2 lo[2], hi[2];
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      lo[kk] = *reinterpret_cast<const float2*>(crow + 8 * kk);
      hi[kk] = *reinterpret_cast<const float2*>(crow + 8 * cst + 8 * kk);
      split4_tf32(lo[kk].x, hi[kk].x, lo[kk].y, hi[kk].y, ah[kk], al[kk]);
    }
    // x = 0 .. 7: u^T += C dh^T for rows i 8 x .. + 7 over the warp's 16
    // columns e; and k-step x (rows j 8 x .. + 7) of the carry update C =
    // exp(a_L) C + (k wc)^T v, the chunk's part summed from zero in two
    // chains by the parity of x
    float fr[2][2][4];  // [8-column group kk][parity of x]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int c = 0; c < 4; ++c) fr[kk][pp][c] = 0.f;
    const float* db = dht + g * LDT + el + 2 * tq;
    const float* vc = vt + tq * LDT + el + g;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float2 b =
            *reinterpret_cast<const float2*>(db + 8 * x * LDT + 8 * kk);
        mma_tf32x3f(u[x], ah[kk], al[kk], b.x, b.y);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_tf32x3f(fr[kk][x & 1], kwh[x], kwl[x], vc[8 * x * LDT + 8 * kk],
              vc[(8 * x + 4) * LDT + 8 * kk]);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) f[c] = fr[kk][0][c] + fr[kk][1][c];
      *reinterpret_cast<float2*>(crow + 8 * kk) =
          make_float2(fmaf(decay, lo[kk].x, f[0]), fmaf(decay, lo[kk].y, f[1]));
      *reinterpret_cast<float2*>(crow + 8 * cst + 8 * kk) =
          make_float2(fmaf(decay, hi[kk].x, f[2]), fmaf(decay, hi[kk].y, f[3]));
    }
    // dC' at the same places from the [e][d] tile; <dC', C> with C in
    // float32; y^T += dC' v^T for all rows j over the warp's 16 columns e
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* dcp = dcs + (el + 8 * kk + 2 * tq) * LDC + 16 * dr + g;
      const float c00 = dcp[0], c10 = dcp[8], c01 = dcp[LDC], c11 = dcp[LDC + 8];
      dot = fmaf(lo[kk].x, c00, dot);
      dot = fmaf(lo[kk].y, c01, dot);
      dot = fmaf(hi[kk].x, c10, dot);
      dot = fmaf(hi[kk].y, c11, dot);
      split4_tf32(c00, c10, c01, c11, ah[kk], al[kk]);
    }
    const float* vb = vt + g * LDT + el + 2 * tq;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float2 b =
            *reinterpret_cast<const float2*>(vb + 8 * x * LDT + 8 * kk);
        mma_tf32x3f(y[x], ah[kk], al[kk], b.x, b.y);
      }

    if (et == nd - 1) {
      // the chunk's u and y: the four column warps of a row half add their
      // parts in order through this step's slot, each keeping n-tiles 2 eq
      // and 2 eq + 1; then the block's parts of x, k . y and <dC', C>
      float4* slotp = reinterpret_cast<float4*>(stg + (sig & 1) * CSLOT);
      auto reduce = [&](float (&acc)[8][4], float (&f)[2][4]) {
        __syncthreads();  // the slot is free
#pragma unroll
        for (int n = 0; n < 8; ++n)
          slotp[(w * 8 + n) * 32 + lane] =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
        __syncthreads();
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          const int n = 2 * eq + xx;
          float4 sum = slotp[((dr * 4) * 8 + n) * 32 + lane];
#pragma unroll
          for (int p = 1; p < 4; ++p) {
            const float4 r = slotp[((dr * 4 + p) * 8 + n) * 32 + lane];
            sum.x += r.x;
            sum.y += r.y;
            sum.z += r.z;
            sum.w += r.w;
          }
          f[xx][0] = sum.x;
          f[xx][1] = sum.y;
          f[xx][2] = sum.z;
          f[xx][3] = sum.w;
        }
      };
      float fin[2][2][4];  // [u, y][n-tile 2 eq + xx]
      reduce(u, fin[0]);
      reduce(y, fin[1]);
      // store u^T ([d][i] a chunk) and y ([j][d]); the parts over this
      // warp's 16 rows d of q_i . u_i and k_j . y_j
      float* ub = uo + cidx * hd * L;
#pragma unroll
      for (int xx = 0; xx < 2; ++xx) {
        const int i = 16 * eq + 8 * xx + 2 * tq;
        float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          const int d = d0 + 16 * dr + g + 8 * h8;
          const float* fu = fin[0][xx] + 2 * h8;
          const float* fy = fin[1][xx] + 2 * h8;
          if (d < hd) {
            *reinterpret_cast<float2*>(ub + (int64_t)d * L + i) =
                make_float2(fu[0], fu[1]);
            yo[(row0 + i) * hd + d] = fy[0];
            yo[(row0 + i + 1) * hd + d] = fy[1];
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              px[ii] = fmaf(q[(row0 + i + ii) * hd + d], fu[ii], px[ii]);
              py[ii] = fmaf(k[(row0 + i + ii) * hd + d], fy[ii], py[ii]);
            }
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)  // over g
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            px[ii] += __shfl_xor_sync(FULL, px[ii], off);
            py[ii] += __shfl_xor_sync(FULL, py[ii], off);
          }
        if (g == 0)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            xs[(dr * 2 + 0) * L + i + ii] = px[ii];
            xs[(dr * 2 + 1) * L + i + ii] = py[ii];
          }
      }
      red[t] = dot;
      __syncthreads();
      if (t < L) {
        const int64_t o = (cidx * n_db + blockIdx.x) * L + t;
        xp[o] = rb[R_R * L + t] * (xs[t] + xs[2 * L + t]);
        kyp[o] = xs[L + t] + xs[3 * L + t];
      }
      if (t == 0) {
        float sum = 0.f;
        for (int i = 0; i < THREADS; ++i) sum += red[i];
        ddp[cidx * n_db + blockIdx.x] = sum;
      }
    }
  }
}

// ---------------------------------------------------------------- 5

// Shared memory of an intra block, in floats: dS~, dS~^T and (S / m)^T (L
// rows of LDX), G (L rows of L + 1), 8 rows of L scalars, two stages of (k,
// q, dh) tiles.
#define INTRA_FLOATS (3 * L * LDX + L * (L + 1) + 8 * L + 2 * 3 * L * LDT)

__global__ void __launch_bounds__(THREADS)
mlstm_bwd_tf32x3_intra(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ dh,
                       const float* __restrict__ rec,
                       const float* __restrict__ sv,
                       const float* __restrict__ vd,
                       const float* __restrict__ nst,
                       const float* __restrict__ uo,
                       const float* __restrict__ xp, float* __restrict__ rows,
                       float* __restrict__ dki, float* __restrict__ dns,
                       float* __restrict__ dq, float* __restrict__ dv, int s,
                       int hd, int n_db, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ds = sm;                   // [L][LDX]: dS~
  float* dst = ds + L * LDX;        // [L][LDX]: dS~^T
  float* pt = dst + L * LDX;        // [L][LDX]: (S / m)^T
  float* gm = pt + L * LDX;         // [L][L + 1]: G
  float* rw = gm + L * (L + 1);     // per row: 8 x L
  float* stg = rw + 8 * L;          // [2 stages][k, q, dh][L][LDT]
  float* r_ = rw, *im = rw + L, *dd = rw + 2 * L, *rr = rw + 3 * L;
  float* li = rw + 4 * L, *a = rw + 5 * L, *rd = rw + 6 * L;
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const int nd = (hd + DT - 1) / DT;
  const float* src[3] = {k + row0 * hd, q + row0 * hd, dh + row0 * hd};
  auto tile = [&](int which, int stage) {
    return stg + (stage * 3 + which) * L * LDT;
  };
  for (int x = 0; x < 3; ++x) stage64(tile(x, 0), src[x], hd, 0);
  cp_async_commit();
  const float* rb = rec + cidx * REC * L;
  const float* svb = sv + cidx * L * L;
  const float* vdb = vd + cidx * L * L;
  if (t < L) {  // the row's scalars
    const int i = t;
    float x = 0.f, intra = 0.f;
    for (int b = 0; b < n_db; ++b) x += xp[(cidx * n_db + b) * L + i];
    for (int j = 0; j <= i; ++j) intra = fmaf(svb[i * L + j], vdb[i * L + j], intra);
    const float den = rb[R_DEN * L + i];
    const float m_inv = 1.f / fmaxf(fabsf(den), 1.f);
    const float dden = fabsf(den) >= 1.f
                           ? -(x + intra) * m_inv * m_inv *
                                 (den > 0.f ? 1.f : -1.f)
                           : 0.f;
    r_[i] = rb[R_R * L + i];
    im[i] = m_inv;
    dd[i] = dden;
    rr[i] = fmaf(x, m_inv, rb[R_DEN_INTER * L + i] * dden);
    li[i] = rb[R_LI * L + i];
    a[i] = rb[R_A * L + i];
    rd[i] = r_[i] * dden;
  }
  __syncthreads();
  for (int idx = t; idx < L * L; idx += THREADS) {
    const int i = idx / L, j = idx % L;
    float gv = 0.f, dsv = 0.f, pm = 0.f;
    if (j <= i) {
      const float dsi = fmaf(vdb[idx], im[i], dd[i]);
      gv = dsi * svb[idx];
      dsv = dsi * scale * expf(a[i] - a[j] + li[j]);
      pm = svb[idx] * im[i];
    }
    gm[i * (L + 1) + j] = gv;
    ds[i * LDX + j] = dsv;
    dst[j * LDX + i] = dsv;
    pt[j * LDX + i] = pm;
  }
  __syncthreads();
  if (t < L) {  // G's row sums less its column sums, and the row's record
    float rs = 0.f, cs = 0.f;
    for (int j = 0; j < L; ++j) rs += gm[t * (L + 1) + j];
    for (int i = 0; i < L; ++i) cs += gm[i * (L + 1) + t];
    rows[(cidx * 2) * L + t] = rs - cs + rr[t];
    rows[(cidx * 2 + 1) * L + t] = cs;
  }

  // per 64-column tile of hd, warp w: rows 16 (w % 4), columns 32 (w / 4) of
  // dq = dS~ k, of the chunk-internal dk = dS~^T q and of (S / m)^T dh
  const int mi = 16 * (w & 3), nh = 32 * (w >> 2);
  const float* ub = uo + cidx * hd * L;
  const float* nb = nst + cidx * hd;
  for (int dt = 0; dt < nd; ++dt) {
    cp_async_wait<0>();
    __syncthreads();  // tile dt landed; the other stage is free
    if (dt + 1 < nd) {
      for (int x = 0; x < 3; ++x)
        stage64(tile(x, (dt + 1) & 1), src[x], hd, (dt + 1) * DT);
      cp_async_commit();
    }
    const float* kt = tile(0, dt & 1);
    const float* qt = tile(1, dt & 1);
    const float* ht = tile(2, dt & 1);
    float aq[4][4], ak[4][4], av[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) aq[n][x] = ak[n][x] = av[n][x] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      const int c = 8 * ks + tq;
      uint32_t h1[4], l1[4], h2[4], l2[4], h3[4], l3[4];
      const float* p1 = ds + (mi + g) * LDX + c;
      const float* p2 = dst + (mi + g) * LDX + c;
      const float* p3 = pt + (mi + g) * LDX + c;
      split4_tf32(p1[0], p1[8 * LDX], p1[4], p1[8 * LDX + 4], h1, l1);
      split4_tf32(p2[0], p2[8 * LDX], p2[4], p2[8 * LDX + 4], h2, l2);
      split4_tf32(p3[0], p3[8 * LDX], p3[4], p3[8 * LDX + 4], h3, l3);
      const int o = c * LDT + nh + g;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma_tf32x3f(aq[n], h1, l1, kt[o + 8 * n], kt[o + 4 * LDT + 8 * n]);
        mma_tf32x3f(ak[n], h2, l2, qt[o + 8 * n], qt[o + 4 * LDT + 8 * n]);
        mma_tf32x3f(av[n], h3, l3, ht[o + 8 * n], ht[o + 4 * LDT + 8 * n]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mi + g + 8 * half;  // row i of dq; row j of dk and dv
      float* dqr = dq + (row0 + i) * hd;
      float* dkr = dki + (row0 + i) * hd;
      float* dvr = dv + (row0 + i) * hd;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int d = dt * DT + nh + 8 * n + 2 * tq;
        if (d >= hd) continue;
        const float q0 = r_[i] * fmaf(ub[(int64_t)d * L + i], im[i],
                                      nb[d] * dd[i]);
        const float q1 = r_[i] * fmaf(ub[(int64_t)(d + 1) * L + i], im[i],
                                      nb[d + 1] * dd[i]);
        *reinterpret_cast<float2*>(dqr + d) =
            make_float2(q0 + aq[n][2 * half], q1 + aq[n][2 * half + 1]);
        *reinterpret_cast<float2*>(dkr + d) =
            make_float2(ak[n][2 * half], ak[n][2 * half + 1]);
        const float2 old = *reinterpret_cast<const float2*>(dvr + d);
        *reinterpret_cast<float2*>(dvr + d) =
            make_float2(old.x + av[n][2 * half], old.y + av[n][2 * half + 1]);
      }
    }
    // q^T (r dden) over the tile's columns, for dn
    const int d = dt * DT + t;
    if (t < DT && d < hd) {
      float sum = 0.f;
#pragma unroll 8
      for (int i = 0; i < L; ++i) sum = fmaf(rd[i], qt[i * LDT + t], sum);
      dns[cidx * hd + d] = sum;
    }
  }
}

// ---------------------------------------------------------------- 6

__global__ void __launch_bounds__(THREADS)
mlstm_bwd_tf32x3_gates(const float* __restrict__ k, const float* __restrict__ ig,
                       const float* __restrict__ fg,
                       const float* __restrict__ rec,
                       const float* __restrict__ rows,
                       const float* __restrict__ nst,
                       const float* __restrict__ dns,
                       const float* __restrict__ yo,
                       const float* __restrict__ dki,
                       const float* __restrict__ kyp,
                       const float* __restrict__ ddp,
                       const float* __restrict__ dn_final,
                       float* __restrict__ dk, float* __restrict__ dn0,
                       float* __restrict__ di, float* __restrict__ df, int s,
                       int hd, int n_db) {
  extern __shared__ __align__(16) float dnp[];  // [hd]: dn'
  __shared__ float es[L], da[L], red[THREADS];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* rbh = rec + (int64_t)bh * nc * REC * L;
  const float* rb = rec + cidx * REC * L;
  const float* nsb = dns + (int64_t)bh * nc * hd;
  float part = 0.f;  // its share of dn' . n
  for (int d = t; d < hd; d += THREADS) {
    float dn = dn_final ? dn_final[(int64_t)bh * hd + d] : 0.f;
    for (int c = nc - 1; c > ch; --c)
      dn = fmaf(rbh[(c * REC + R_DECAY) * L], dn, nsb[(int64_t)c * hd + d]);
    dnp[d] = dn;
    part = fmaf(dn, nst[cidx * hd + d], part);
    if (ch == 0)
      dn0[(int64_t)bh * hd + d] = fmaf(rb[R_DECAY * L], dn, nsb[d]);
  }
  red[t] = part;
  __syncthreads();
  // dk whole, and k_j . dn' by rows (warp w: rows w, w + 8, ...)
  for (int j = w; j < L; j += THREADS / 32) {
    const float wc = rb[R_WC * L + j];
    const int64_t off = (row0 + j) * hd;
    float kd = 0.f;
    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 kk = *reinterpret_cast<const float2*>(k + off + d);
      const float2 yy = *reinterpret_cast<const float2*>(yo + off + d);
      const float2 ii = *reinterpret_cast<const float2*>(dki + off + d);
      kd = fmaf(kk.x, dnp[d], kd);
      kd = fmaf(kk.y, dnp[d + 1], kd);
      *reinterpret_cast<float2*>(dk + off + d) =
          make_float2(fmaf(wc, yy.x + dnp[d], ii.x),
                      fmaf(wc, yy.y + dnp[d + 1], ii.y));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) kd += __shfl_xor_sync(FULL, kd, o);
    if (lane == 0) {
      float ky = 0.f;
      for (int b = 0; b < n_db; ++b) ky += kyp[(cidx * n_db + b) * L + j];
      es[j] = wc * (ky + kd);
    }
  }
  __syncthreads();
  if (t == 0) {
    float nd_ = 0.f, cd = 0.f, esum = 0.f;
    for (int i = 0; i < THREADS; ++i) nd_ += red[i];
    for (int b = 0; b < n_db; ++b) cd += ddp[cidx * n_db + b];
    for (int j = 0; j < L; ++j) esum += es[j];
    for (int j = 0; j < L; ++j) da[j] = rows[(cidx * 2) * L + j] - es[j];
    da[L - 1] += esum + rb[R_DECAY * L] * (cd + nd_);
    float run = 0.f;  // the reverse cumsum: d log f
    for (int j = L - 1; j >= 0; --j) {
      run += da[j];
      da[j] = run;
    }
  }
  __syncthreads();
  if (t < L) {
    df[row0 + t] = da[t] / (1.f + expf(fg[row0 + t]));  // sigmoid(-f_raw)
    di[row0 + t] = ig[row0 + t] <= I_CAP
                       ? rows[(cidx * 2 + 1) * L + t] + es[t]
                       : 0.f;
  }
}

// ---------------------------------------------------------------- launch

struct Ws {
  float *rec, *sv, *vd, *ksum, *nst, *u, *y, *dki, *dns, *xp, *kyp, *ddp,
      *rows, *dct;
};

// Byte offsets of the workspace's parts, each 256-byte aligned; returns the
// total.  Fills w where given.
static int64_t ws_layout(int bh, int s, int hd, Ws* w, unsigned char* base) {
  const int64_t nc = s / L, n_db = (hd + BE - 1) / BE, ncb = (int64_t)bh * nc;
  const int64_t sizes[14] = {4 * ncb * REC * L,         // rec
                             4 * ncb * L * L,           // S
                             4 * ncb * L * L,           // VD
                             4 * ncb * hd,              // sum_j wc_j k_j
                             4 * ncb * hd,              // chunk-start n
                             4 * ncb * hd * L,          // u^T
                             4 * (int64_t)bh * s * hd,  // y
                             4 * (int64_t)bh * s * hd,  // dk inside
                             4 * ncb * hd,              // q^T (r dden)
                             4 * ncb * n_db * L,        // x parts
                             4 * ncb * n_db * L,        // k . y parts
                             4 * ncb * n_db,            // <dC', C> parts
                             4 * ncb * 2 * L,           // intra's row parts
                             4 * ncb * hd * hd};        // dC'^T
  float** ptrs[14] = {&w->rec, &w->sv,  &w->vd,  &w->ksum, &w->nst,
                      &w->u,   &w->y,   &w->dki, &w->dns,  &w->xp,
                      &w->kyp, &w->ddp, &w->rows, &w->dct};
  int64_t off = 0;
  for (int i = 0; i < 14; ++i) {
    if (w != nullptr) *ptrs[i] = reinterpret_cast<float*>(base + off);
    off += (sizes[i] + 255) & ~(int64_t)255;
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

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The chunk the wrapper pads S to.
extern "C" int mlstm_bwd_tf32x3_chunk_len() { return L; }

// The largest head dim (a multiple of DT) whose slabs fit both walks.
extern "C" int mlstm_bwd_tf32x3_max_hd() {
  int hd = DT;
  while (dwalk_smem_bytes(hd + DT) <= SMEM_MAX &&
         cwalk_smem_bytes(hd + DT) <= SMEM_MAX)
    hd += DT;
  return hd;
}

// Bytes of workspace a call needs (the wrapper allocates them).
extern "C" long long mlstm_bwd_tf32x3_workspace_bytes(int bh, int s, int hd) {
  if (bh <= 0 || s <= 0 || hd <= 0 || s % L != 0) return 0;
  return ws_layout(bh, s, hd, nullptr, nullptr);
}

// Returns 0 or a cudaError_t.  The caller checks dtypes (float32 throughout)
// and shapes and pads S to a multiple of L (dh with zeros); q, k, v, dh are
// 16-byte aligned; c0, n0, dc_final, dn_final may be null (zeros); every
// output is written whole, dc0 (bh, hd, hd) and dn0 (bh, hd) included; ws
// holds mlstm_bwd_tf32x3_workspace_bytes(...) bytes, 256-byte aligned.
extern "C" int mlstm_bwd_tf32x3_launch(
    const void* q, const void* k, const void* v, const void* dh,
    const void* ig, const void* fg, const void* c0, const void* n0,
    const void* dc_final, const void* dn_final, void* dq, void* dk, void* dv,
    void* di, void* df, void* dc0, void* dn0, void* ws, int bh, int s,
    int hd, double scale, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % L != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > mlstm_bwd_tf32x3_max_hd() ||
      (long long)bh * s > 0x7fffffff || ((uintptr_t)ws & 255) != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Ws w;
  ws_layout(bh, s, hd, &w, (unsigned char*)ws);
  const int nc = s / L, n_db = (hd + BE - 1) / BE;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *dhf = (const float*)dh;
  const float *igf = (const float*)ig, *fgf = (const float*)fg;
  const dim3 chunks(nc, bh), cols(n_db, bh);
  const float sc = (float)scale;
  cudaError_t err;

  size_t smem = sizeof(float) * 2 * 4 * L * LDT;
  if ((err = allow_smem(mlstm_bwd_tf32x3_scores, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_tf32x3_scores<<<chunks, THREADS, smem, st>>>(
      qf, kf, vf, dhf, igf, fgf, w.rec, w.sv, w.vd, w.ksum, s, hd, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = sizeof(float) * hd;
  if ((err = allow_smem(mlstm_bwd_tf32x3_den, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_tf32x3_den<<<chunks, THREADS, smem, st>>>(
      qf, w.rec, w.ksum, (const float*)n0, w.nst, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = dwalk_smem_bytes(hd);
  if ((err = allow_smem(mlstm_bwd_tf32x3_dwalk, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_tf32x3_dwalk<<<cols, THREADS, smem, st>>>(
      kf, qf, dhf, w.rec, (const float*)dc_final, w.dct, (float*)dc0,
      (float*)dv, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = cwalk_smem_bytes(hd);
  if ((err = allow_smem(mlstm_bwd_tf32x3_cwalk, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_tf32x3_cwalk<<<cols, THREADS, smem, st>>>(
      dhf, vf, w.dct, qf, kf, w.rec, (const float*)c0, w.u, w.y, w.xp, w.kyp,
      w.ddp, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = sizeof(float) * INTRA_FLOATS;
  if ((err = allow_smem(mlstm_bwd_tf32x3_intra, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_tf32x3_intra<<<chunks, THREADS, smem, st>>>(
      qf, kf, dhf, w.rec, w.sv, w.vd, w.nst, w.u, w.xp, w.rows, w.dki, w.dns,
      (float*)dq, (float*)dv, s, hd, n_db, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = sizeof(float) * hd;
  if ((err = allow_smem(mlstm_bwd_tf32x3_gates, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_tf32x3_gates<<<chunks, THREADS, smem, st>>>(
      kf, igf, fgf, w.rec, w.rows, w.nst, w.dns, w.y, w.dki, w.kyp, w.ddp,
      (const float*)dn_final, (float*)dk, (float*)dn0, (float*)di, (float*)df,
      s, hd, n_db);
  return (int)cudaGetLastError();
}
