// Chunkwise mLSTM in float32 on Hopper's tensor cores (sm_90a): every
// product as three TF32 mma.sync, so that the sums keep float32 accuracy.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_kernel.py (_kernel,
// wrapper mlstm_chunkwise) for float32 q, k, v with hd a multiple of 8 up to
// mlstm_tf32x3_max_hd(); bf16 runs mlstm_kernel_sm90.cu, and every other
// head dim the CUDA-core mlstm_kernel.cu.  It computes what that file's
// header states: for q, k, v (BH, S, hd), gates i_raw, f_raw (BH, S) and
// the carry C (BH, hd, hd), n (BH, hd), all float32, S a multiple of the
// chunk L = 64, per chunk
//   li = min(i_raw, 8), a = cumsum_chunk(log_sigmoid(f_raw)),
//   S_ij = (q_i . k_j) / sqrt(hd) * exp(a_i - a_j + li_j)   for j <= i,
//   r_i = exp(a_i) / sqrt(hd),  wc_j = exp(a_L - a_j + li_j),
//   out_i = r_i (q_i C) + sum_j S_ij v_j,  den_i = r_i (q_i . n) + sum_j S_ij,
//   h_i = out_i / max(|den_i|, 1),
//   C <- exp(a_L) C + sum_j wc_j k_j^T v_j,  n <- exp(a_L) n + sum_j wc_j k_j,
// with the exponents summed before exp (so a chunk whose log forget gates
// sum below -88 stays finite, where ref.mlstm_chunkwise_plain's exp(-a_j)
// overflows: ROADMAP C2), and writes h and the final C and n.
//
// The arithmetic.  A single TF32 product keeps 11 bits of each operand, so
// each float32 operand x is split, once, as it goes from shared memory or
// device memory into a fragment, into hi = x rounded to tf32 as cvt.rna
// rounds it (to nearest, ties away from zero), in two integer instructions,
// and lo = x - hi, which mma.sync reads as tf32 by dropping its low 13 bits
// (sm90.cuh: split_tf32_fast), and every product A B is three
// mma.sync.m16n8k8 tf32 into float32 accumulators, per k-step of 8: lo(A)
// hi(B), hi(A) lo(B), then hi(A) hi(B) (sm90.cuh: mma_tf32x3).  That
// covers S = q k^T, q C, S v and the carry update (v wc)^T k.  No operand is
// rounded below float32 otherwise: S, C, v wc, n and den stay float32.  The
// tensor cores' float32 sums do not round to nearest, and their error grows
// with the products that feed one accumulator, so C never accumulates
// through them: each chunk's update is summed from zero (its even and odd
// k-steps in two sums, then added) and joins C by one rounded fmaf with
// exp(a_L); S sums each 64-column tile of hd from zero and adds the tiles'
// sums in order; q C is summed from zero each chunk.
// tests/test_torch_mlstm_tf32x3.py rebuilds this arithmetic, and these
// orders of sums, in plain torch.
//
// Bound on the H100: operations.  The function is 4 hd^2 + 4 L hd FLOPs a
// token and head (73 GFLOP at xlstm's train shape, BH = 16, S = 1,024, hd =
// 1,024), three TF32 products each: 0.443 ms at the 494.7 TFLOP/s dense
// TF32 peak (1.090 at the 67 TFLOP/s float32 CUDA-core peak of the first
// design), against about 200 MB of inputs, outputs and carry (0.06 ms at
// 3.35 TB/s).  sm_90a has no tf32 conversion instruction: ptxas expands
// each cvt.rna.tf32.f32 to a compare, an add, a select and a mask, so
// split_tf32's nine instructions made the splits most of the walk's
// instructions; split_tf32_fast takes three.
//
// Design: the three passes of mlstm_kernel_sm90.cu, with float32 tiles
// staged by 16-byte cp.async into rows of LDT = 72 floats (LDT % 32 == 8),
// zero-filled past hd, so that no branch surrounds the walk's mma.sync
// (ptxas wraps one under a run-time branch in a WARPSYNC).
//  1. mlstm_tf32x3_scores, one block of 4 warps per (chunk, bh), all chunks
//     in parallel: q k^T over hd in double-buffered tiles of 64 (warp w:
//     rows 16 w, all 64 columns); in the epilogue the gate, the causal mask
//     and 1 / sqrt(hd).  Writes S in float32, per chunk four rows of 64
//     floats (r_i, wc_j, S's row sums, exp(a_L)) and sum_j wc_j k_j.
//  2. mlstm_tf32x3_den, one block per (chunk, bh): the n that enters the
//     chunk (a scan of at most S / L steps), then den_i = row sum + r_i (q_i
//     . n) in place of the row sums; the last chunk's block writes the final
//     n.  On the CUDA cores in float32, as the bf16 route does.
//  3. mlstm_tf32x3_carry, one block of 8 warps per (BE = 32 value columns
//     e, bh), walks the chunks in order.  Its slab of C^T (32 rows e of hd
//     float32, each padded by 8 floats; 129 KB at hd 1,024) stays in shared
//     memory for the whole walk; a step takes one 64-row tile d of it, with
//     that tile's 64 columns of q and k staged in a two-slot ring.  Warp w
//     takes rows e 16 (w / 4) and columns d 16 (w % 4) of the step:
//       - out^T += C^T q^T (its 16 columns d, all 64 rows i), with C_old;
//       - C^T = exp(a_L) C^T + (v wc)^T k, (v wc)^T split once a chunk into
//         registers, the chunk's part from zero in two chains by k-step
//         parity, so that the products in flight do not wait on one
//         another.
//     A chunk's first step also gives (S v)^T for its rows e and 16 rows i
//     (v read from device memory and split, S from the scores' output); at
//     its last, the four column warps' parts of out^T are added in order
//     through the step's slot, and each warp writes h = (r_i out_i + (S
//     v)_i) / max(|den_i|, 1) for its 16 rows i.  m16n8k8's accumulator
//     holds columns (2t, 2t + 1) where its A fragment wants (t, t + 4), so
//     both products that contract over d take a k-step's 8 columns in the
//     order 0, 2, 4, 6, 1, 3, 5, 7 on both operands: a thread's A fragment
//     of C^T is the carry update's accumulator fragment at the same place,
//     one 8-byte load for both.  Shared memory at hd 1,024: 201 KB, one
//     block an SM; hd / 32 x BH blocks (512 at the train shape, 256 at the
//     parity shape (8, 200, 1,024): two waves on 132 SMs).
// It is csrc/mlstm_kernel_bwd_tf32x3.cu's dwalk with q and k in the roles
// of k and q, and S v and h added.  Every sum across warps is in a fixed
// order and there are no atomics: two calls give the same bits.
// The padded tail (q = k = v = 0, i_raw = -1e30, f_raw = +1e30) has S = 0
// and wc = 0 and leaves the carry unchanged; the wrapper drops its rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define L 64              // chunk
#define DT 64             // columns of a staged tile, and rows d of a step
#define LDT 72            // floats a staged row of 64 columns (LDT % 32 == 8)
#define BE 32             // slab rows (value columns e) of a carry block
#define THREADS 256       // carry: 8 warps
#define SC_THREADS 128    // scores: 4 warps
#define DEN_THREADS 256   // den
#define I_CAP 8.0f
#define SMEM_MAX 232448   // dynamic shared memory a block may opt into
#define FULL 0xffffffffu

// A chunk's gate record, 4 rows of L floats.
enum { G_R = 0, G_WC, G_DEN, G_DECAY };

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// 64 rows x 64 columns of a (rows, hd) float32 matrix from column d0 (src at
// its first row) into a tile of LDT floats a row; columns past hd read as
// zeros.  The caller commits.
template <int NT>
__device__ __forceinline__ void stage64(float* dst, const float* src, int hd,
                                        int d0) {
  for (int idx = threadIdx.x; idx < L * 16; idx += NT) {
    const int r = idx >> 4, c = (idx & 15) * 4, d = d0 + c;
    const bool in = d < hd;
    cp_async16(smem_u32(dst + r * LDT + c),
               src + (int64_t)r * hd + (in ? d : 0), in ? 16 : 0);
  }
}

// ---------------------------------------------------------------- 1

__global__ void __launch_bounds__(SC_THREADS)
mlstm_tf32x3_scores(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ ig, const float* __restrict__ fg,
                    float* __restrict__ sc, float* __restrict__ gates,
                    float* __restrict__ ksum, int s, int hd, float scale) {
  extern __shared__ __align__(16) float tiles[];  // [2 stages][q, k]
  __shared__ float li[L], a[L], wc[L];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* qb = q + row0 * hd;
  const float* kb = k + row0 * hd;
  auto tile = [&](int which, int stage) {
    return tiles + (stage * 2 + which) * L * LDT;
  };
  const int nd = (hd + DT - 1) / DT;
  stage64<SC_THREADS>(tile(0, 0), qb, hd, 0);
  stage64<SC_THREADS>(tile(1, 0), kb, hd, 0);
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

  // warp w: rows 16 w of q k^T, all 64 columns; each k-step of 8 columns in
  // the order 0, 2, .., 7 on both sides
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
      stage64<SC_THREADS>(tile(0, (dt + 1) & 1), qb, hd, (dt + 1) * DT);
      stage64<SC_THREADS>(tile(1, (dt + 1) & 1), kb, hd, (dt + 1) * DT);
      cp_async_commit();
    }
    const float* at = tile(0, dt & 1) + (16 * w + g) * LDT + 2 * tq;
    const float* bt = tile(1, dt & 1) + g * LDT + 2 * tq;
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
      split4_tf32<SplitFast>(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 y =
            *reinterpret_cast<const float2*>(bt + 8 * n * LDT + kk);
        mma_tf32x3f<SplitFast>(part[n], ah, al, y.x, y.y);
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

  float* scb = sc + cidx * L * L;
  float* gb = gates + cidx * 4 * L;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = 16 * w + g + 8 * half;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = 8 * nt + 2 * tq;
      const float v0 =
          j <= i ? acc[nt][2 * half] * scale * expf(a[i] - a[j] + li[j]) : 0.f;
      const float v1 = j + 1 <= i ? acc[nt][2 * half + 1] * scale *
                                        expf(a[i] - a[j + 1] + li[j + 1])
                                  : 0.f;
      sum += v0 + v1;
      *reinterpret_cast<float2*>(scb + i * L + j) = make_float2(v0, v1);
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    if (tq == 0) gb[G_DEN * L + i] = sum;  // den adds r (q . n) later
  }
  if (t < L) {
    gb[G_R * L + t] = scale * expf(a[t]);
    gb[G_WC * L + t] = wc[t];
    gb[G_DECAY * L + t] = t == 0 ? expf(a[L - 1]) : 0.f;
  }
}

// ---------------------------------------------------------------- 2

// The n entering chunk ch (n0 decayed and summed through the earlier
// chunks), then den_i = rowsum_i + r_i (q_i . n) over the row sums in
// gates; the last chunk's block also writes the final n.
__global__ void __launch_bounds__(DEN_THREADS)
mlstm_tf32x3_den(const float* __restrict__ q, float* __restrict__ gates,
                 const float* __restrict__ ksum, const float* __restrict__ n0,
                 float* __restrict__ n_out, int s, int hd) {
  extern __shared__ __align__(16) float nprev[];  // [hd]
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x;
  const float* gbh = gates + (int64_t)bh * nc * 4 * L;
  const float* kbh = ksum + (int64_t)bh * nc * hd;
  for (int d = t; d < hd; d += DEN_THREADS) {
    float n = n0 ? n0[(int64_t)bh * hd + d] : 0.f;
    for (int c = 0; c < ch; ++c)
      n = fmaf(gbh[(c * 4 + G_DECAY) * L], n, kbh[(int64_t)c * hd + d]);
    nprev[d] = n;
    if (ch == nc - 1)
      n_out[(int64_t)bh * hd + d] =
          fmaf(gbh[(ch * 4 + G_DECAY) * L], n, kbh[(int64_t)ch * hd + d]);
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
  float* gb = gates + ((int64_t)bh * nc + ch) * 4 * L;
  if (part == 0)
    gb[G_DEN * L + i] = fmaf(gb[G_R * L + i], dot, gb[G_DEN * L + i]);
}

// ---------------------------------------------------------------- 3

// Shared memory of a carry block, in bytes: the C^T slab (BE rows of the
// padded head dim + 8 floats: the row stride is 8 mod 32) and two slots of
// (q, k) tiles.
static size_t carry_smem_bytes(int hd) {
  const size_t hdp = (size_t)(hd + DT - 1) / DT * DT;
  return sizeof(float) * ((size_t)BE * (hdp + 8) + 2 * 2 * L * LDT);
}

__global__ void __launch_bounds__(THREADS, 1)
mlstm_tf32x3_carry(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ sc,
                   const float* __restrict__ gates,
                   const float* __restrict__ c0, float* __restrict__ c_out,
                   float* __restrict__ h, int s, int hd) {
  extern __shared__ __align__(16) float smem[];
  const int nd = (hd + DT - 1) / DT, hdp = nd * DT, cst = hdp + 8;
  float* ct = smem;            // [BE][cst]: C^T, rows e
  float* stg = ct + BE * cst;  // [2 slots][q, k][L][LDT]
  const int e0 = blockIdx.x * BE, bh = blockIdx.y, nc = s / L;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int eh = w >> 2, dq = w & 3;  // rows e 16 eh; columns d 16 dq of a step
  const int e = e0 + 16 * eh + g;     // this thread's rows e and e + 8

  const float* cb = c0 ? c0 + (int64_t)bh * hd * hd : nullptr;
  for (int idx = t; idx < BE * hdp; idx += THREADS) {
    const int el = idx % BE, d = idx / BE;
    ct[el * cst + d] =
        (cb && d < hd && e0 + el < hd) ? cb[(int64_t)d * hd + e0 + el] : 0.f;
  }
  auto slot = [&](int sl, int which) {
    return stg + (sl * 2 + which) * L * LDT;
  };
  // step sig: chunk sig / nd, columns (sig % nd) DT of q and k
  auto load_step = [&](int sig) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)(sig / nd) * L;
    stage64<THREADS>(slot(sig & 1, 0), q + row0 * hd, hd, (sig % nd) * DT);
    stage64<THREADS>(slot(sig & 1, 1), k + row0 * hd, hd, (sig % nd) * DT);
    cp_async_commit();
  };

  float o[8][4];                  // out^T: rows e, columns i 8 x + 2 tq, + 1
  float sv[2][4];                 // (S v)^T: rows e, columns i 16 dq + 8 y ..
  uint32_t vah[8][4], val[8][4];  // (v wc)^T, rows e, k-steps over j
  float decay = 0.f;
  const int nsig = nc * nd;
  load_step(0);
  for (int sig = 0; sig < nsig; ++sig) {
    const int ch = sig / nd, dt = sig % nd;
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const int64_t cidx = (int64_t)bh * nc + ch;
    const float* gb = gates + cidx * 4 * L;
    cp_async_wait<0>();
    __syncthreads();  // step sig landed; the other slot is free
    if (sig + 1 < nsig) load_step(sig + 1);
    if (dt == 0) {
      // v^T (rows e, k-steps over j) split: A of (S v)^T = v^T S^T for the
      // rows i 16 dq .. + 15, S^T's B fragment read from the scores' output;
      // then v wc split, kept for the chunk's updates
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int x = 0; x < 4; ++x) sv[y][x] = 0.f;
      const float* scb = sc + cidx * L * L + (16 * dq + g) * L;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int j0 = 8 * ks + tq, j1 = j0 + 4;
        const float* v0p = v + (row0 + j0) * hd;
        const float* v1p = v + (row0 + j1) * hd;
        const float x0 = e < hd ? v0p[e] : 0.f;
        const float x1 = e + 8 < hd ? v0p[e + 8] : 0.f;
        const float x2 = e < hd ? v1p[e] : 0.f;
        const float x3 = e + 8 < hd ? v1p[e + 8] : 0.f;
        uint32_t ah[4], al[4];
        split4_tf32<SplitFast>(x0, x1, x2, x3, ah, al);
#pragma unroll
        for (int y = 0; y < 2; ++y)
          mma_tf32x3f<SplitFast>(sv[y], ah, al, scb[8 * y * L + j0],
                                 scb[8 * y * L + j1]);
        const float w0 = gb[G_WC * L + j0], w1 = gb[G_WC * L + j1];
        split4_tf32<SplitFast>(x0 * w0, x1 * w0, x2 * w1, x3 * w1, vah[ks],
                               val[ks]);
      }
      decay = gb[G_DECAY * L];
    }

    const float* qt = slot(sig & 1, 0);
    const float* kt = slot(sig & 1, 1);
    const int dl = 16 * dq;  // the warp's first row d in the step
    float* crow = ct + (16 * eh + g) * cst + dt * DT + dl + 2 * tq;
    // C_old^T at rows e g, g + 8, columns d 2 tq, + 1 of the 8-column group
    // kk (taken 0, 2, .., 7 in out^T)
    float2 lo[2], hi[2];
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      lo[kk] = *reinterpret_cast<const float2*>(crow + 8 * kk);
      hi[kk] = *reinterpret_cast<const float2*>(crow + 8 * cst + 8 * kk);
      split4_tf32<SplitFast>(lo[kk].x, hi[kk].x, lo[kk].y, hi[kk].y, ah[kk],
                             al[kk]);
    }
    // x = 0 .. 7: out^T += C^T q^T for rows i 8 x .. + 7 over the warp's 16
    // columns d; and k-step x (rows j 8 x .. + 7) of the carry update C^T =
    // exp(a_L) C^T + (v wc)^T k, the chunk's part summed from zero in two
    // chains by the parity of x
    float fr[2][2][4];  // [8-column group kk][parity of x]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int c = 0; c < 4; ++c) fr[kk][pp][c] = 0.f;
    const float* qb = qt + g * LDT + dl + 2 * tq;
    const float* kb = kt + tq * LDT + dl + g;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float2 y =
            *reinterpret_cast<const float2*>(qb + 8 * x * LDT + 8 * kk);
        mma_tf32x3f<SplitFast>(o[x], ah[kk], al[kk], y.x, y.y);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_tf32x3f<SplitFast>(fr[kk][x & 1], vah[x], val[x],
                               kb[8 * x * LDT + 8 * kk],
                               kb[(8 * x + 4) * LDT + 8 * kk]);
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
      // the chunk's h: the four column warps' parts of out^T added in order
      // through this step's slot, each warp keeping its rows i 16 dq + 8 y
      float4* red = reinterpret_cast<float4*>(slot(sig & 1, 0));
      __syncthreads();  // the slot's tiles are read
#pragma unroll
      for (int n = 0; n < 8; ++n)
        red[((eh * 4 + dq) * 8 + n) * 32 + lane] =
            make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      __syncthreads();
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int n = 2 * dq + y;
        float4 sum = red[((eh * 4) * 8 + n) * 32 + lane];
#pragma unroll
        for (int p = 1; p < 4; ++p) {
          const float4 r = red[((eh * 4 + p) * 8 + n) * 32 + lane];
          sum.x += r.x;
          sum.y += r.y;
          sum.z += r.z;
          sum.w += r.w;
        }
        const int i = 8 * n + 2 * tq;
        const float r0 = gb[G_R * L + i], r1 = gb[G_R * L + i + 1];
        const float inv0 = 1.f / fmaxf(fabsf(gb[G_DEN * L + i]), 1.f);
        const float inv1 = 1.f / fmaxf(fabsf(gb[G_DEN * L + i + 1]), 1.f);
        float* h0 = h + (row0 + i) * hd;
        float* h1 = h0 + hd;
        if (e < hd) {
          h0[e] = fmaf(r0, sum.x, sv[y][0]) * inv0;
          h1[e] = fmaf(r1, sum.y, sv[y][1]) * inv1;
        }
        if (e + 8 < hd) {
          h0[e + 8] = fmaf(r0, sum.z, sv[y][2]) * inv0;
          h1[e + 8] = fmaf(r1, sum.w, sv[y][3]) * inv1;
        }
      }
    }
  }
  __syncthreads();
  float* co = c_out + (int64_t)bh * hd * hd;
  for (int idx = t; idx < BE * hdp; idx += THREADS) {
    const int el = idx % BE, d = idx / BE;
    if (d < hd && e0 + el < hd)
      co[(int64_t)d * hd + e0 + el] = ct[el * cst + d];
  }
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
extern "C" int mlstm_tf32x3_chunk_len() { return L; }

// The largest head dim (a multiple of DT) whose slab fits a carry block.
extern "C" int mlstm_tf32x3_max_hd() {
  int hd = DT;
  while (carry_smem_bytes(hd + DT) <= SMEM_MAX) hd += DT;
  return hd;
}

// Returns 0 or a cudaError_t.  The caller checks dtypes (float32
// throughout) and shapes, pads S to a multiple of L and passes c0 and n0 as
// null where there are none (zeros); q, k, v are 16-byte aligned.  Scratch:
// sc (BH, S / L, L, L), gates (BH, S / L, 4, L) and ksum (BH, S / L, hd).
// c_out and n_out receive the final C and n, h (BH, S, hd) the outputs.
extern "C" int mlstm_tf32x3_launch(const void* q, const void* k,
                                   const void* v, const void* ig,
                                   const void* fg, void* sc, void* gates,
                                   void* ksum, const void* c0, const void* n0,
                                   void* c_out, void* n_out, void* h, int bh,
                                   int s, int hd, double scale, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % L != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > mlstm_tf32x3_max_hd() ||
      (long long)bh * s > 0x7fffffff || !aligned16(q) || !aligned16(k) ||
      !aligned16(v))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 chunks(s / L, bh);
  const float *qf = (const float*)q, *kf = (const float*)k;
  cudaError_t err;

  size_t smem = sizeof(float) * 2 * 2 * L * LDT;
  if ((err = allow_smem(mlstm_tf32x3_scores, smem)) != cudaSuccess)
    return (int)err;
  mlstm_tf32x3_scores<<<chunks, SC_THREADS, smem, st>>>(
      qf, kf, (const float*)ig, (const float*)fg, (float*)sc, (float*)gates,
      (float*)ksum, s, hd, (float)scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = sizeof(float) * hd;
  if ((err = allow_smem(mlstm_tf32x3_den, smem)) != cudaSuccess)
    return (int)err;
  mlstm_tf32x3_den<<<chunks, DEN_THREADS, smem, st>>>(
      qf, (float*)gates, (const float*)ksum, (const float*)n0, (float*)n_out,
      s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = carry_smem_bytes(hd);
  if ((err = allow_smem(mlstm_tf32x3_carry, smem)) != cudaSuccess)
    return (int)err;
  mlstm_tf32x3_carry<<<dim3((hd + BE - 1) / BE, bh), THREADS, smem, st>>>(
      qf, kf, (const float*)v, (const float*)sc, (const float*)gates,
      (const float*)c0, (float*)c_out, (float*)h, s, hd);
  return (int)cudaGetLastError();
}
