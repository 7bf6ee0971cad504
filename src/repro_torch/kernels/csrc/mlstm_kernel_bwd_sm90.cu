// The gradient of the chunkwise mLSTM in bfloat16 on Hopper's tensor cores
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its jnp chunkwise
// form (src/repro/models/xlstm.py mlstm_chunkwise) and has no backward Pallas
// kernel.  It computes what csrc/mlstm_kernel_bwd.cu's header states (and
// ref.mlstm_chunkwise_bwd_plain), for bf16 q, k, v, dh (BH, S, hd) with hd a
// multiple of 8 up to mlstm_bwd_sm90_max_hd() and S a multiple of the chunk
// L = 64: per chunk, with li = min(i_raw, 8), a = cumsum_chunk(log
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
// sigmoid(-f_raw), di_raw = dli where i_raw <= 8, 0 above).  Outputs dq, dk,
// dv in bf16, di_raw, df_raw, dc0, dn0 in float32; an absent initial carry
// or final-state gradient reads as zeros.
//
// Bound on the H100: operations.  The function is about 10 hd^2 + 10 L hd
// FLOPs a token and head (182.6 GFLOP at xlstm's train shape, BH = 16,
// S = 1,024, hd = 1,024: 0.185 ms at the 989 TFLOP/s bf16 peak).  The two
// carries' split updates add 4 hd^2 (this design does about 14 hd^2 + 8 L hd,
// 0.25 ms there).  What it stores for the call: each chunk's dC' in bf16
// (BH S / L hd^2 x 2 bytes, 537 MB there, written once and read once, 0.32
// ms at 3.35 TB/s), and u, y and the chunk-internal dk in float32 (64 MB
// each there).
//
// The trap is the width, as in the forward: a head's state is hd x hd (4 MB
// in float32 at hd = 1,024), so no block holds one, and every sum across the
// blocks that split one goes through the workspace and is added in a fixed
// order (no atomics: two calls give the same bits).  Six kernels, every
// product on mma.sync.m16n8k16 (bf16 in, float32 out) through ldmatrix:
//  1. mlstm_bwd_sm90_scores, one block per (chunk, bh), all chunks in
//     parallel: q k^T and dh v^T over hd in tiles of 64 (cp.async,
//     double-buffered); S gated and masked, VD, S's row sums, the gates and
//     the chunk's sum_j wc_j k_j, in float32.
//  2. mlstm_bwd_sm90_den, one block per (chunk, bh): the chunk-start n (a
//     scan of at most S / L steps), den, m, r / m, and (S / m)^T in bf16.
//  3. mlstm_bwd_sm90_dwalk, one block of 8 warps per (32 columns e of dC,
//     bh), the chunks in reverse: the forward's carry kernel with q and k
//     swapped, dh for v and r / m for wc.  Its slab of dC^T (32 rows of hd
//     float32) stays in shared memory for the whole walk; each step takes a
//     64-row tile of it per warp group, with k and q brought by TMA into a
//     two-slot ring; it stores the slab's dC' in bf16 for the chunk (the
//     operand of the products that follow), adds z^T = dC'^T k^T, and
//     updates dC^T = exp(a_L) dC^T + (dh r / m)_lo^T q + (dh r / m)_hi^T q
//     with the split factor's fragments made once a chunk.  At a chunk's
//     start it forms (dv_intra)^T = dh^T (S / m); at its end dv = that +
//     wc z, whole.  The last slab is dc0.
//  4. mlstm_bwd_sm90_cwalk, one block of 8 warps per (32 rows d of C, bh),
//     the chunks in order: its slab of C (32 rows of hd float32), a 64-column
//     tile a step, dh, v and the stored dC' tile brought by TMA; warp w takes
//     16 columns (w % 4) and 16 rows (w / 4) of the tile.  u^T = C dh^T (C
//     rounded to bf16), y^T = dC' v^T, the part of <dC', C> (C in float32),
//     and C = exp(a_L) C + (k wc)_lo^T v + (k wc)_hi^T v.  At a chunk's end
//     u and y are summed over the warps (in a fixed order) and stored, with
//     the block's parts of x_i and k_j . y_j.
//  5. mlstm_bwd_sm90_intra, one block per (chunk, bh): x from the parts,
//     dden, dS, G's row and column sums, dS~ in bf16; dq = r (u / m + n dden)
//     + dS~ k whole, dS~^T q (the chunk-internal dk) and q^T (r dden) for dn.
//  6. mlstm_bwd_sm90_gates, one block per (chunk, bh): dn' by a scan from the
//     last chunk, dk = dS~^T q + wc (y + dn') whole, E, <dC', C> + dn' . n,
//     the reverse cumsum, di_raw and df_raw; chunk 0's block writes dn0.
// Roundings (tests/test_torch_mlstm_bwd_split.py repeats them on the CPU):
// S / m and dS~ to bf16 for their products; C to bf16 for u and each dC' to
// bf16 (as stored) for z, y and <dC', C>; the carries' gated factors k wc
// and dh r / m, formed in float32, split into hi and lo bf16 parts, so that
// C and dC keep float32 accuracy.  q, k, v and dh are used as given; n, dn,
// den, m, dden, the gates and every row sum stay float32.
// The padded tail (q = k = v = 0, i_raw = -1e30, f_raw = +1e30, dh = 0) has
// S = 0 and wc = 0 and passes no gradient; the wrapper drops its rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define L 64              // chunk
#define DT 64             // columns of a tile of q, k, v or dh
#define LDT 72            // bf16 row stride of a 64-column tile in shared memory
#define BE 32             // columns e of dC (rows d of C) per walk block
#define VST (BE + 8)      // bf16 row stride of a BE-column tile
#define WALK_THREADS 256  // 8 warps
#define SC_THREADS 128    // scores and intra kernels: 4 warps
#define ROW_THREADS 256   // den and gates kernels
#define REC 8             // float rows of L a chunk's record holds
#define I_CAP 8.0f
#define SMEM_MAX 232448   // dynamic shared memory a block may opt into
#define SPIN_LIMIT (1u << 28)  // polls of an mbarrier before a wait traps
#define FULL 0xffffffffu

typedef __nv_bfloat16 bf16;

// A chunk's record, REC rows of L floats: the walks read the first four.
enum { R_WC = 0, R_WQ, R_R, R_DECAY, R_LI, R_A, R_DEN_INTER, R_DEN };

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Waits until the barrier's phase with the given parity has completed;
// traps (a CUDA error, not a hang) after SPIN_LIMIT polls.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done, more;\n.reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE_%=;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 more, n, %2;\n"
      "@more bra WAIT_%=;\n"
      "trap;\n"
      "DONE_%=:\n}\n" ::"r"(bar),
      "r"(parity), "n"(SPIN_LIMIT)
      : "memory");
}

// 64 rows x 64 columns of a (rows, hd) bf16 matrix, from column d0, into a
// tile of row stride LDT; columns past hd read as zeros.
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* src,
                                            int hd, int d0, int t,
                                            int nthreads) {
  for (int idx = t; idx < L * 8; idx += nthreads) {
    const int r = idx >> 3, c = (idx & 7) * 8, d = d0 + c;
    const int ok = d < hd ? 16 : 0;
    cp_async16(smem_u32(dst + r * LDT + c),
               src + (int64_t)r * hd + (ok ? d : 0), ok);
  }
}

// 64 rows x BE columns of a (rows, hd) bf16 matrix, from column c0, into a
// tile of row stride VST; columns past hd read as zeros.
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* src, int hd,
                                          int c0, int t, int nthreads) {
  constexpr int VP = BE / 8;  // 16-byte pieces per row
  for (int idx = t; idx < L * VP; idx += nthreads) {
    const int r = idx / VP, c = (idx % VP) * 8;
    const int ok = c0 + c < hd ? 16 : 0;
    cp_async16(smem_u32(dst + r * VST + c),
               src + (int64_t)r * hd + (ok ? c0 + c : 0), ok);
  }
}

// A 64 x 64 bf16 tile as TMA writes it under the 128-byte swizzle: 128-byte
// rows, the 16-byte chunk c of row r at chunk c ^ (r % 8).
#define TILE_BYTES (L * 128)
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int c) {
  return tile + r * 128 + (((c ^ r) & 7) << 4);
}

// ---------------------------------------------------------------- 1

__global__ void __launch_bounds__(SC_THREADS)
mlstm_bwd_sm90_scores(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dh,
                      const float* __restrict__ ig,
                      const float* __restrict__ fg, float* __restrict__ rec,
                      float* __restrict__ sv, float* __restrict__ vd,
                      float* __restrict__ ksum, int s, int hd, float scale) {
  extern __shared__ __align__(16) bf16 tiles[];  // [q, k, dh, v][2 stages]
  __shared__ float li[L], a[L], wc[L];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const bf16* src[4] = {q + row0 * hd, k + row0 * hd, dh + row0 * hd,
                        v + row0 * hd};
  auto tile = [&](int which, int stage) {
    return tiles + (which * 2 + stage) * L * LDT;
  };
  const int nd = (hd + DT - 1) / DT;
  for (int x = 0; x < 4; ++x) load_tile64(tile(x, 0), src[x], hd, 0, t, SC_THREADS);
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

  // warp w: rows i 16 w .. + 15 of q k^T and dh v^T, all 64 columns
  float acc_s[8][4], acc_v[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc_s[nt][x] = acc_v[nt][x] = 0.f;
  // acc += the warp's rows of A B^T over one tile's 64 columns
  auto product = [&](float (&acc)[8][4], const bf16* at, const bf16* bt) {
#pragma unroll
    for (int kk = 0; kk < DT; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, smem_u32(at + (16 * w + (lane & 15)) * LDT + kk +
                           (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, smem_u32(bt + (16 * np + (lane & 7) + (lane >> 4) * 8) *
                                       LDT +
                              kk + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(acc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16_16816(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
  };
  float* kso = ksum + cidx * hd;
  for (int dt = 0; dt < nd; ++dt) {
    cp_async_wait<0>();
    __syncthreads();  // tile dt landed; the other stage is free
    if (dt + 1 < nd) {
      for (int x = 0; x < 4; ++x)
        load_tile64(tile(x, (dt + 1) & 1), src[x], hd, (dt + 1) * DT, t,
                    SC_THREADS);
      cp_async_commit();
    }
    product(acc_s, tile(0, dt & 1), tile(1, dt & 1));  // q k^T
    product(acc_v, tile(2, dt & 1), tile(3, dt & 1));  // dh v^T
    // sum_j wc_j k_j over the tile's columns, for n
    const int d = dt * DT + (t & 63);
    if (t < 64 && d < hd) {
      const bf16* kt = tile(1, dt & 1);
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < L; ++j)
        sum = fmaf(wc[j], __bfloat162float(kt[j * LDT + t]), sum);
      kso[d] = sum;
    }
  }

  float* svb = sv + cidx * L * L;
  float* vdb = vd + cidx * L * L;
  float* rb = rec + cidx * REC * L;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = 16 * w + g + 8 * half;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = 8 * nt + 2 * tq;
      const float v0 =
          j <= i ? acc_s[nt][2 * half] * scale * expf(a[i] - a[j] + li[j]) : 0.f;
      const float v1 = j + 1 <= i ? acc_s[nt][2 * half + 1] * scale *
                                        expf(a[i] - a[j + 1] + li[j + 1])
                                  : 0.f;
      sum += v0 + v1;
      *reinterpret_cast<float2*>(svb + i * L + j) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(vdb + i * L + j) =
          make_float2(acc_v[nt][2 * half], acc_v[nt][2 * half + 1]);
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    if (tq == 0) rb[R_DEN * L + i] = sum;  // den adds r (q . n) later
  }
  if (t < L) {
    rb[R_WC * L + t] = wc[t];
    rb[R_R * L + t] = scale * expf(a[t]);
    rb[R_DECAY * L + t] = t == 0 ? expf(a[L - 1]) : 0.f;
    rb[R_LI * L + t] = li[t];
    rb[R_A * L + t] = a[t];
  }
}

// ---------------------------------------------------------------- 2

// The n entering chunk ch (n0 decayed and summed through the earlier
// chunks), den = row sum + r (q . n), r / m, and (S / m)^T in bf16.
__global__ void __launch_bounds__(ROW_THREADS)
mlstm_bwd_sm90_den(const bf16* __restrict__ q, float* __restrict__ rec,
                   const float* __restrict__ sv,
                   const float* __restrict__ ksum,
                   const float* __restrict__ n0, float* __restrict__ nst,
                   bf16* __restrict__ pt, int s, int hd) {
  extern __shared__ __align__(16) float nprev[];  // [hd], then inv_m [L]
  float* inv_m = nprev + hd;
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* rbh = rec + (int64_t)bh * nc * REC * L;
  const float* kbh = ksum + (int64_t)bh * nc * hd;
  for (int d = t; d < hd; d += ROW_THREADS) {
    float n = n0 ? n0[(int64_t)bh * hd + d] : 0.f;
    for (int c = 0; c < ch; ++c)
      n = fmaf(rbh[(c * REC + R_DECAY) * L], n, kbh[(int64_t)c * hd + d]);
    nprev[d] = n;
    nst[cidx * hd + d] = n;
  }
  __syncthreads();
  // 4 threads a row, each 8 columns at a time
  const int i = t >> 2, part = t & 3;
  const bf16* qr = q + ((int64_t)bh * s + (int64_t)ch * L + i) * hd;
  float dot = 0.f;
  for (int d = 8 * part; d < hd; d += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(qr + d);
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = unpack_bf16(x[u]);
      dot = fmaf(f.x, nprev[d + 2 * u], dot);
      dot = fmaf(f.y, nprev[d + 2 * u + 1], dot);
    }
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
    inv_m[i] = im;
  }
  __syncthreads();
  const float* svb = sv + cidx * L * L;
  bf16* ptb = pt + cidx * L * L;
  for (int idx = t; idx < L * L; idx += ROW_THREADS) {
    const int j = idx / L, ii = idx % L;  // (S / m)^T[j][i]
    ptb[idx] = __float2bfloat16(svb[ii * L + j] * inv_m[ii]);
  }
}

// ---------------------------------------------------------------- 3

// Shared memory of a dwalk block, in bytes: alignment for the swizzled
// stages, the stages (two slots of two tile pairs (k, q)), the dC^T slab,
// one chunk of (S / m)^T and of dh's BE columns, two chunks of the record's
// first four rows, the stages' mbarriers.
static size_t dwalk_smem_bytes(int hd) {
  const size_t hdp = (size_t)(hd + DT - 1) / DT * DT;
  return 1024 + 4 * 2 * TILE_BYTES + 4 * (size_t)BE * (hdp + 8) +
         2 * L * LDT + 2 * L * VST + 4 * 2 * 4 * L + 8 * 4;
}

__global__ void __launch_bounds__(WALK_THREADS, 1)
mlstm_bwd_sm90_dwalk(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap qmap,
                     const bf16* __restrict__ dh, const bf16* __restrict__ pt,
                     const float* __restrict__ rec,
                     const float* __restrict__ dc_final,
                     bf16* __restrict__ dct, float* __restrict__ dc0,
                     bf16* __restrict__ dv, int s, int hd) {
  constexpr int MT = BE / 16;       // m-tiles of slab rows e: 2
  constexpr int NW = WALK_THREADS / 32;
  constexpr int TP = NW / 4;        // warp groups = tiles per step: 2
  constexpr int NSV = 8 / NW;       // n-tiles of rows j per warp in dv: 1
  extern __shared__ unsigned char smem_raw[];
  const int nd = (hd + DT - 1) / DT, hdp = nd * DT, cst = hdp + 8;
  const int nst = (nd + TP - 1) / TP;  // steps a chunk
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t stg = smem_u32(base);  // [2 TP][k, q]: slot sig % 2
  float* ct = reinterpret_cast<float*>(base + 2 * TP * 2 * TILE_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(ct + BE * cst);  // [L][LDT]: (S/m)^T
  bf16* ds = ps + L * LDT;                            // [L][VST]: dh cols
  float* gs = reinterpret_cast<float*>(ds + L * VST);  // [2][4 L]
  const uint32_t bars = smem_u32(gs + 2 * 4 * L);     // [2 TP] mbarriers

  const int e0 = blockIdx.x * BE, bh = blockIdx.y, nc = s / L;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int grp = w / 4, p = w % 4;  // tile of the step, rows 16 p of it

  if (t == 0) {
    for (int i = 0; i < 2 * TP; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  const float* cb = dc_final ? dc_final + (int64_t)bh * hd * hd : nullptr;
  for (int idx = t; idx < BE * hdp; idx += WALK_THREADS) {
    const int e = idx % BE, d = idx / BE;
    ct[e * cst + d] =
        (cb && d < hd && e0 + e < hd) ? cb[(int64_t)d * hd + e0 + e] : 0.f;
  }
  __syncthreads();

  // thread 0: k and q of step sig's tiles (chunk nc - 1 - sig / nst, rows
  // (sig % nst) TP + u of dC) into the stages of slot sig % 2; past nd a
  // step loads tile 0 again, unused, so every stage fills once a slot turn
  auto load_step = [&](int sig) {
    const int ch = nc - 1 - sig / nst, pos0 = (sig % nst) * TP;
    const int row = bh * s + ch * L;
#pragma unroll
    for (int u = 0; u < TP; ++u) {
      const int st = (sig & 1) * TP + u, dt = (pos0 + u) % nd;
      const uint32_t dst = stg + st * 2 * TILE_BYTES, bar = bars + 8 * st;
      mbar_expect_tx(bar, 2 * TILE_BYTES);
      tma_load2(dst, &kmap, bar, dt * DT, row);
      tma_load2(dst + TILE_BYTES, &qmap, bar, dt * DT, row);
    }
  };
  // a chunk's (S / m)^T, dh columns and record
  auto load_chunk = [&](int ch) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const int64_t cidx = (int64_t)bh * nc + ch;
    const bf16* pb = pt + cidx * L * L;
    for (int idx = t; idx < L * 8; idx += WALK_THREADS) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      cp_async16(smem_u32(ps + r * LDT + c), pb + r * L + c, 16);
    }
    load_cols(ds, dh + row0 * hd, hd, e0, t, WALK_THREADS);
    for (int idx = t; idx < L; idx += WALK_THREADS)
      cp_async16(smem_u32(gs + (ch & 1) * 4 * L + 4 * idx),
                 rec + cidx * REC * L + 4 * idx, 16);
    cp_async_commit();
  };

  float acc[MT][8][4];        // part of z^T (BE slab rows e x 64 rows j)
  float acc_sv[MT][NSV][4];   // dv_intra^T, rows j 8 (NSV w + y) .. + 7
  uint32_t va_hi[MT][4][4], va_lo[MT][4][4];  // (dh r / m)^T, split
  float decay = 0.f;
  const int nsig = nc * nst;
  load_chunk(nc - 1);
  if (t == 0) load_step(0);
  for (int sig = 0; sig < nsig; ++sig) {
    const int ch = nc - 1 - sig / nst, si = sig % nst;
    const int64_t cidx = (int64_t)bh * nc + ch;
    const float* g4 = gs + (ch & 1) * 4 * L;
    if (si == 0) cp_async_wait<0>();  // the chunk's (S/m)^T, dh, record
#pragma unroll
    for (int u = 0; u < TP; ++u)
      bar_wait(bars + 8 * ((sig & 1) * TP + u), (sig >> 1) & 1);
    __syncthreads();  // step sig landed; step sig - 1 is done with
    if (si == 0) {
      // dv_intra^T = dh^T (S / m) for this warp's rows j, with dh^T exact;
      // then dh^T scaled by r / m and split into the update's A fragments
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[m][x][y] = 0.f;
#pragma unroll
        for (int x = 0; x < NSV; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc_sv[m][x][y] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < L; kk += 16) {
        const int ks = kk / 16, i = kk + 2 * tq;
        uint32_t sb[NSV][2];
#pragma unroll
        for (int y = 0; y < NSV; ++y)
          ldsm_x2(sb[y], smem_u32(ps + (8 * (NSV * w + y) + (lane & 7)) * LDT +
                                  kk + ((lane >> 3) & 1) * 8));
        // a0, a1 hold rows i, i + 1 of dh; a2, a3 rows i + 8, i + 9
        const float wa0 = g4[R_WQ * L + i], wa1 = g4[R_WQ * L + i + 1];
        const float wb0 = g4[R_WQ * L + i + 8], wb1 = g4[R_WQ * L + i + 9];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t va[4];
          ldsm_x4_t(va, smem_u32(ds + (kk + (lane & 7) + (lane >> 4) * 8) *
                                          VST +
                                 16 * m + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int y = 0; y < NSV; ++y)
            mma_bf16_16816(acc_sv[m][y], va, sb[y][0], sb[y][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 x = unpack_bf16(va[r]);
            const float w0 = (r < 2 ? wa0 : wb0) * x.x;
            const float w1 = (r < 2 ? wa1 : wb1) * x.y;
            const uint32_t hb = pack_bf16(w0, w1);
            const float2 hf = unpack_bf16(hb);
            va_hi[m][ks][r] = hb;
            va_lo[m][ks][r] = pack_bf16(w0 - hf.x, w1 - hf.y);
          }
        }
      }
      decay = g4[R_DECAY * L];
      __syncthreads();  // (S/m)^T and dh read: the next chunk's may come
      if (ch > 0) load_chunk(ch - 1);
    }
    if (t == 0 && sig + 1 < nsig) load_step(sig + 1);

    if (si * TP + grp < nd) {
      const int dt = si * TP + grp;
      const uint32_t kt = stg + ((sig & 1) * TP + grp) * 2 * TILE_BYTES;
      const uint32_t qt = kt + TILE_BYTES;
      float* crow = ct + g * cst + dt * DT + 16 * p + 2 * tq;
      float uacc[MT][2][4];
      uint32_t ca[MT][4];  // bf16(dC')^T: the A fragment of z^T, and stored
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float* cp = crow + 16 * m * cst + 8 * x;
          const float2 lo = *reinterpret_cast<const float2*>(cp);
          const float2 hi = *reinterpret_cast<const float2*>(cp + 8 * cst);
          ca[m][2 * x] = pack_bf16(lo.x, lo.y);
          ca[m][2 * x + 1] = pack_bf16(hi.x, hi.y);
          uacc[m][x][0] = decay * lo.x;
          uacc[m][x][1] = decay * lo.y;
          uacc[m][x][2] = decay * hi.x;
          uacc[m][x][3] = decay * hi.y;
        }
      // dC'^T in bf16 into the chunk's [e][d] matrix
      bf16* dcb = dct + cidx * hd * hd;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = e0 + 16 * m + g, d = dt * DT + 16 * p + 8 * x + 2 * tq;
          if (d < hd) {
            if (e < hd)
              *reinterpret_cast<uint32_t*>(dcb + (int64_t)e * hd + d) =
                  ca[m][2 * x];
            if (e + 8 < hd)
              *reinterpret_cast<uint32_t*>(dcb + (int64_t)(e + 8) * hd + d) =
                  ca[m][2 * x + 1];
          }
        }
      // z^T += bf16(dC')^T k^T over these 16 rows d, all 64 rows j
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // rows j 16 np .. + 15
        uint32_t kb[4];
        ldsm_x4(kb, swz(kt, 16 * np + (lane & 7) + (lane >> 4) * 8,
                        2 * p + ((lane >> 3) & 1)));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16_16816(acc[m][2 * np], ca[m], kb[0], kb[1]);
          mma_bf16_16816(acc[m][2 * np + 1], ca[m], kb[2], kb[3]);
        }
      }
      // dC^T = exp(a_L) dC'^T + (dh r / m)_lo^T q + (dh r / m)_hi^T q
#pragma unroll
      for (int kk = 0; kk < L; kk += 16) {
        const int ks = kk / 16;
        uint32_t qb[4];
        ldsm_x4_t(qb, swz(qt, kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * p + (lane >> 4)));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16_16816(uacc[m][0], va_lo[m][ks], qb[0], qb[1]);
          mma_bf16_16816(uacc[m][1], va_lo[m][ks], qb[2], qb[3]);
          mma_bf16_16816(uacc[m][0], va_hi[m][ks], qb[0], qb[1]);
          mma_bf16_16816(uacc[m][1], va_hi[m][ks], qb[2], qb[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float* cp = crow + 16 * m * cst + 8 * x;
          *reinterpret_cast<float2*>(cp) =
              make_float2(uacc[m][x][0], uacc[m][x][1]);
          *reinterpret_cast<float2*>(cp + 8 * cst) =
              make_float2(uacc[m][x][2], uacc[m][x][3]);
        }
    }

    if (si == nst - 1) {
      // the chunk's dv: each warp's part of z^T takes wc_j; the parts are
      // summed through the slot of this step (the upper half of the warps
      // into the lower, then every warp its rows j from the lower half's
      // sums, with its dv_intra), and dv leaves through shared memory in
      // 16-byte rows
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int j = 8 * x + 2 * tq;
        const float r0 = g4[R_WC * L + j], r1 = g4[R_WC * L + j + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][x][0] *= r0;
          acc[m][x][1] *= r1;
          acc[m][x][2] *= r0;
          acc[m][x][3] *= r1;
        }
      }
      float* red = reinterpret_cast<float*>(base + (sig & 1) * TP * 2 *
                                                       TILE_BYTES);
      auto at = [&](int sl, int m, int x) {
        return reinterpret_cast<float4*>(
            red + (((sl * MT + m) * 8 + x) * 32 + lane) * 4);
      };
      __syncthreads();  // the slot's k and q are read
      if (w >= NW / 2)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            *at(w - NW / 2, m, x) = make_float4(acc[m][x][0], acc[m][x][1],
                                                acc[m][x][2], acc[m][x][3]);
      __syncthreads();
      if (w < NW / 2)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float4 r = *at(w, m, x);
            *at(w, m, x) = make_float4(acc[m][x][0] + r.x, acc[m][x][1] + r.y,
                                       acc[m][x][2] + r.z, acc[m][x][3] + r.w);
          }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int y = 0; y < NSV; ++y)
#pragma unroll
          for (int sl = 0; sl < NW / 2; ++sl) {
            const float4 r = *at(sl, m, NSV * w + y);
            acc_sv[m][y][0] += r.x;
            acc_sv[m][y][1] += r.y;
            acc_sv[m][y][2] += r.z;
            acc_sv[m][y][3] += r.w;
          }
      __syncthreads();
      bf16* hst = reinterpret_cast<bf16*>(red);  // [L][VST]
#pragma unroll
      for (int y = 0; y < NSV; ++y) {  // rows j = 8 (NSV w + y) + 2 tq, + 1
        const int j = 8 * (NSV * w + y) + 2 * tq;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int e = 16 * m + g;
          hst[j * VST + e] = __float2bfloat16(acc_sv[m][y][0]);
          hst[(j + 1) * VST + e] = __float2bfloat16(acc_sv[m][y][1]);
          hst[j * VST + e + 8] = __float2bfloat16(acc_sv[m][y][2]);
          hst[(j + 1) * VST + e + 8] = __float2bfloat16(acc_sv[m][y][3]);
        }
      }
      __syncthreads();
      const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
      constexpr int VP = BE / 8;
      for (int idx = t; idx < L * VP; idx += WALK_THREADS) {
        const int r = idx / VP, c = (idx % VP) * 8;
        if (e0 + c < hd)
          *reinterpret_cast<uint4*>(dv + (row0 + r) * hd + e0 + c) =
              *reinterpret_cast<const uint4*>(hst + r * VST + c);
      }
    }
    // this step's reads and writes of its slot come before the TMA loads
    // that refill it
    fence_proxy_async();
  }
  __syncthreads();
  float* co = dc0 + (int64_t)bh * hd * hd;
  for (int idx = t; idx < BE * hdp; idx += WALK_THREADS) {
    const int e = idx % BE, d = idx / BE;
    if (d < hd && e0 + e < hd) co[(int64_t)d * hd + e0 + e] = ct[e * cst + d];
  }
}

// ---------------------------------------------------------------- 4

#define DC_TILE_BYTES (L * BE * 2)                    // dC'^T: 64 e x BE d
#define CSLOT_BYTES (2 * TILE_BYTES + DC_TILE_BYTES)  // dh, v, dC' a step

// Shared memory of a cwalk block, in bytes: alignment for the swizzled
// stages, two slots of (dh, v, dC') tiles, the C slab, one chunk of k's BE
// columns, two chunks of the record's first four rows, the warps' parts of
// x and k . y, the block's parts of <dC', C>, the mbarriers.
static size_t cwalk_smem_bytes(int hd) {
  const size_t hdp = (size_t)(hd + DT - 1) / DT * DT;
  return 1024 + 2 * CSLOT_BYTES + 4 * (size_t)BE * (hdp + 8) + 2 * L * VST +
         4 * 2 * 4 * L + 4 * 2 * 2 * L + 4 * WALK_THREADS + 8 * 2;
}

__global__ void __launch_bounds__(WALK_THREADS, 1)
mlstm_bwd_sm90_cwalk(const __grid_constant__ CUtensorMap dhmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dcmap,
                     const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const float* __restrict__ rec,
                     const float* __restrict__ c0, float* __restrict__ uo,
                     float* __restrict__ yo, float* __restrict__ xp,
                     float* __restrict__ kyp, float* __restrict__ ddp, int s,
                     int hd) {
  extern __shared__ unsigned char smem_raw[];
  const int nd = (hd + DT - 1) / DT, hdp = nd * DT, cst = hdp + 8;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t stg = smem_u32(base);  // [2 slots][dh, v, dC']
  float* ct = reinterpret_cast<float*>(base + 2 * CSLOT_BYTES);  // C slab
  bf16* ks = reinterpret_cast<bf16*>(ct + BE * cst);  // [L][VST]: k cols
  float* gs = reinterpret_cast<float*>(ks + L * VST);  // [2][4 L]
  float* xs = gs + 2 * 4 * L;                         // [2 h][2][L]
  float* red = xs + 2 * 2 * L;                        // [WALK_THREADS]
  const uint32_t bars = smem_u32(red + WALK_THREADS);  // [2] mbarriers

  const int d0 = blockIdx.x * BE, bh = blockIdx.y, nc = s / L;
  const int n_db = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p = w & 3, h = w >> 2;  // columns 16 p of the tile, rows 16 h

  if (t == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  const float* cb = c0 ? c0 + (int64_t)bh * hd * hd : nullptr;
  for (int idx = t; idx < BE * hdp; idx += WALK_THREADS) {
    const int e = idx % hdp, d = idx / hdp;
    ct[d * cst + e] =
        (cb && e < hd && d0 + d < hd) ? cb[(int64_t)(d0 + d) * hd + e] : 0.f;
  }
  __syncthreads();

  // thread 0: step sig's dh, v and dC' tiles (chunk sig / nd, columns
  // (sig % nd) DT) into slot sig % 2
  auto load_step = [&](int sig) {
    const int ch = sig / nd, et = sig % nd;
    const uint32_t dst = stg + (sig & 1) * CSLOT_BYTES, bar = bars + 8 * (sig & 1);
    mbar_expect_tx(bar, CSLOT_BYTES);
    tma_load2(dst, &dhmap, bar, et * DT, bh * s + ch * L);
    tma_load2(dst + TILE_BYTES, &vmap, bar, et * DT, bh * s + ch * L);
    tma_load4(dst + 2 * TILE_BYTES, &dcmap, bar, d0, et * DT, bh * nc + ch, 0);
  };
  // a chunk's k columns and record
  auto load_chunk = [&](int ch) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    load_cols(ks, k + row0 * hd, hd, d0, t, WALK_THREADS);
    for (int idx = t; idx < L; idx += WALK_THREADS)
      cp_async16(smem_u32(gs + (ch & 1) * 4 * L + 4 * idx),
                 rec + ((int64_t)bh * nc + ch) * REC * L + 4 * idx, 16);
    cp_async_commit();
  };

  float acc_u[8][4], acc_y[8][4];  // parts of u^T, y^T: 16 rows d x 64 i/j
  uint32_t kw_hi[4][4], kw_lo[4][4];  // (k wc)^T for rows 16 h, split
  float qv[2][2][2], kv[2][2][2];  // q, k at (x, d g / g + 8, i / i + 1)
  float dot = 0.f, decay = 0.f;
  const int nsig = nc * nd;
  load_chunk(0);
  if (t == 0) load_step(0);
  for (int sig = 0; sig < nsig; ++sig) {
    const int ch = sig / nd, et = sig % nd;
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const int64_t cidx = (int64_t)bh * nc + ch;
    const float* g4 = gs + (ch & 1) * 4 * L;
    if (et == 0) cp_async_wait<0>();  // the chunk's k columns and record
    bar_wait(bars + 8 * (sig & 1), (sig >> 1) & 1);
    __syncthreads();  // step sig landed; step sig - 1 is done with
    if (et == 0) {
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc_u[x][y] = acc_y[x][y] = 0.f;
      dot = 0.f;
      // (k wc)^T for rows d 16 h .. + 15, k exact, split
#pragma unroll
      for (int kk = 0; kk < L; kk += 16) {
        const int kq = kk / 16, j = kk + 2 * tq;
        const float wa0 = g4[R_WC * L + j], wa1 = g4[R_WC * L + j + 1];
        const float wb0 = g4[R_WC * L + j + 8], wb1 = g4[R_WC * L + j + 9];
        uint32_t ka[4];
        ldsm_x4_t(ka, smem_u32(ks + (kk + (lane & 7) + (lane >> 4) * 8) * VST +
                               16 * h + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 x = unpack_bf16(ka[r]);
          const float w0 = (r < 2 ? wa0 : wb0) * x.x;
          const float w1 = (r < 2 ? wa1 : wb1) * x.y;
          const uint32_t hb = pack_bf16(w0, w1);
          const float2 hf = unpack_bf16(hb);
          kw_hi[kq][r] = hb;
          kw_lo[kq][r] = pack_bf16(w0 - hf.x, w1 - hf.y);
        }
      }
      // q and k where this warp's sums of u^T and y^T land at the chunk's end
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int dh8 = 0; dh8 < 2; ++dh8)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int d = d0 + 16 * h + g + 8 * dh8;
            const int i = 16 * p + 8 * x + 2 * tq + ii;
            const bool ok = d < hd;
            const int64_t off = (row0 + i) * hd + (ok ? d : 0);
            qv[x][dh8][ii] = ok ? __bfloat162float(q[off]) : 0.f;
            kv[x][dh8][ii] = ok ? __bfloat162float(k[off]) : 0.f;
          }
      decay = g4[R_DECAY * L];
      __syncthreads();  // k's columns read: the next chunk's may come
      if (ch + 1 < nc) load_chunk(ch + 1);
    }
    if (t == 0 && sig + 1 < nsig) load_step(sig + 1);

    {
      const uint32_t dht = stg + (sig & 1) * CSLOT_BYTES;
      const uint32_t vt = dht + TILE_BYTES, dcs = dht + 2 * TILE_BYTES;
      float* crow = ct + (16 * h + g) * cst + et * DT + 16 * p + 2 * tq;
      float cold[2][4], uacc[2][4];
      uint32_t ca[4], dca[4];  // bf16(C), bf16(dC'): A fragments (d, e)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float2 lo = *reinterpret_cast<const float2*>(crow + 8 * x);
        const float2 hi =
            *reinterpret_cast<const float2*>(crow + 8 * cst + 8 * x);
        cold[x][0] = lo.x;
        cold[x][1] = lo.y;
        cold[x][2] = hi.x;
        cold[x][3] = hi.y;
        ca[2 * x] = pack_bf16(lo.x, lo.y);
        ca[2 * x + 1] = pack_bf16(hi.x, hi.y);
#pragma unroll
        for (int y = 0; y < 4; ++y) uacc[x][y] = decay * cold[x][y];
      }
      // dC' (d, e) from the [e][d] tile: rows e 16 p .., columns d 16 h ..
      ldsm_x4_t(dca, dcs + ((16 * p + (lane & 7) + (lane >> 4) * 8) * BE +
                            16 * h + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // <dC', C>: a0 (x 0, lo), a1 (hi), ...
        const float2 flo = unpack_bf16(dca[2 * x]);
        const float2 fhi = unpack_bf16(dca[2 * x + 1]);
        dot = fmaf(cold[x][0], flo.x, dot);
        dot = fmaf(cold[x][1], flo.y, dot);
        dot = fmaf(cold[x][2], fhi.x, dot);
        dot = fmaf(cold[x][3], fhi.y, dot);
      }
      // u^T += bf16(C) dh^T and y^T += bf16(dC') v^T over these 16
      // columns e, all 64 rows i / j
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t db[4], vb[4];
        ldsm_x4(db, swz(dht, 16 * np + (lane & 7) + (lane >> 4) * 8,
                        2 * p + ((lane >> 3) & 1)));
        ldsm_x4(vb, swz(vt, 16 * np + (lane & 7) + (lane >> 4) * 8,
                        2 * p + ((lane >> 3) & 1)));
        mma_bf16_16816(acc_u[2 * np], ca, db[0], db[1]);
        mma_bf16_16816(acc_u[2 * np + 1], ca, db[2], db[3]);
        mma_bf16_16816(acc_y[2 * np], dca, vb[0], vb[1]);
        mma_bf16_16816(acc_y[2 * np + 1], dca, vb[2], vb[3]);
      }
      // C = exp(a_L) C + (k wc)_lo^T v + (k wc)_hi^T v
#pragma unroll
      for (int kk = 0; kk < L; kk += 16) {
        const int kq = kk / 16;
        uint32_t vb[4];
        ldsm_x4_t(vb, swz(vt, kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * p + (lane >> 4)));
        mma_bf16_16816(uacc[0], kw_lo[kq], vb[0], vb[1]);
        mma_bf16_16816(uacc[1], kw_lo[kq], vb[2], vb[3]);
        mma_bf16_16816(uacc[0], kw_hi[kq], vb[0], vb[1]);
        mma_bf16_16816(uacc[1], kw_hi[kq], vb[2], vb[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        *reinterpret_cast<float2*>(crow + 8 * x) =
            make_float2(uacc[x][0], uacc[x][1]);
        *reinterpret_cast<float2*>(crow + 8 * cst + 8 * x) =
            make_float2(uacc[x][2], uacc[x][3]);
      }
    }

    if (et == nd - 1) {
      // the chunk's u and y: the four warps of a row block h sum their
      // parts through this step's slot ((p 0 + p 2) + (p 1 + p 3)), each
      // keeping n-tiles 2 p and 2 p + 1; then the block's parts of x and
      // k . y, and of <dC', C>
      float4* slot = reinterpret_cast<float4*>(base + (sig & 1) * CSLOT_BYTES);
      auto at = [&](int pp, int x) {  // parts of (pp, h), n-tile x, lane
        return slot + ((pp * 2 + h) * 8 + x) * 32 + lane;
      };
      auto reduce = [&](float (&acc)[8][4], float (&f)[2][4]) {
        __syncthreads();  // the slot is free
        if (p >= 2)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            *at(p - 2, x) = make_float4(acc[x][0], acc[x][1], acc[x][2],
                                        acc[x][3]);
        __syncthreads();
        if (p < 2)
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float4 r = *at(p, x);
            *at(p, x) = make_float4(acc[x][0] + r.x, acc[x][1] + r.y,
                                    acc[x][2] + r.z, acc[x][3] + r.w);
          }
        __syncthreads();
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          const float4 a0 = *at(0, 2 * p + xx), a1 = *at(1, 2 * p + xx);
          f[xx][0] = a0.x + a1.x;
          f[xx][1] = a0.y + a1.y;
          f[xx][2] = a0.z + a1.z;
          f[xx][3] = a0.w + a1.w;
        }
      };
      float fin[2][2][4];  // [u, y][n-tile 2 p + xx]
      reduce(acc_u, fin[0]);
      reduce(acc_y, fin[1]);
      // store u^T ([d][i] a chunk) and y ([j][d]); the parts over this
      // warp's 16 rows d of q_i . u_i and k_j . y_j
      float* ub = uo + cidx * hd * L;
#pragma unroll
      for (int xx = 0; xx < 2; ++xx) {
        const int i = 16 * p + 8 * xx + 2 * tq;
        float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
#pragma unroll
        for (int dh8 = 0; dh8 < 2; ++dh8) {
          const int d = d0 + 16 * h + g + 8 * dh8;
          const float* fu = fin[0][xx] + 2 * dh8;
          const float* fy = fin[1][xx] + 2 * dh8;
          if (d < hd) {
            *reinterpret_cast<float2*>(ub + (int64_t)d * L + i) =
                make_float2(fu[0], fu[1]);
            yo[(row0 + i) * hd + d] = fy[0];
            yo[(row0 + i + 1) * hd + d] = fy[1];
          }
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            px[ii] = fmaf(qv[xx][dh8][ii], fu[ii], px[ii]);
            py[ii] = fmaf(kv[xx][dh8][ii], fy[ii], py[ii]);
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
            xs[(h * 2 + 0) * L + i + ii] = px[ii];
            xs[(h * 2 + 1) * L + i + ii] = py[ii];
          }
      }
      red[t] = dot;
      __syncthreads();
      if (t < L) {
        const float r = g4[R_R * L + t];
        const int64_t o = (cidx * n_db + blockIdx.x) * L + t;
        xp[o] = r * (xs[t] + xs[2 * L + t]);
        kyp[o] = xs[L + t] + xs[3 * L + t];
      }
      if (t == 0) {
        float sum = 0.f;
        for (int i = 0; i < WALK_THREADS; ++i) sum += red[i];
        ddp[cidx * n_db + blockIdx.x] = sum;
      }
    }
    // this step's reads and writes of its slot come before the TMA loads
    // that refill it
    fence_proxy_async();
  }
}

// ---------------------------------------------------------------- 5

__global__ void __launch_bounds__(SC_THREADS)
mlstm_bwd_sm90_intra(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const float* __restrict__ rec,
                     const float* __restrict__ sv,
                     const float* __restrict__ vd,
                     const float* __restrict__ nst,
                     const float* __restrict__ uo,
                     const float* __restrict__ xp, float* __restrict__ rows,
                     float* __restrict__ dki, float* __restrict__ dns,
                     bf16* __restrict__ dq, int s, int hd, int n_db,
                     float scale) {
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* dsts = reinterpret_cast<bf16*>(sm);       // [L][LDT]: dS~
  bf16* kq = dsts + L * LDT;                      // [k, q][2 stages][L][LDT]
  float* gm = reinterpret_cast<float*>(kq + 4 * L * LDT);  // [L][L + 1]: G
  float* rw = gm + L * (L + 1);                   // per row: 8 x L
  float* r_ = rw, *im = rw + L, *dd = rw + 2 * L, *rr = rw + 3 * L;
  float* li = rw + 4 * L, *a = rw + 5 * L, *rd = rw + 6 * L;
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const int nd = (hd + DT - 1) / DT;
  auto tile = [&](int which, int stage) {
    return kq + (which * 2 + stage) * L * LDT;
  };
  load_tile64(tile(0, 0), k + row0 * hd, hd, 0, t, SC_THREADS);
  load_tile64(tile(1, 0), q + row0 * hd, hd, 0, t, SC_THREADS);
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
  for (int idx = t; idx < L * L; idx += SC_THREADS) {
    const int i = idx / L, j = idx % L;
    float gv = 0.f, dst = 0.f;
    if (j <= i) {
      const float dsv = fmaf(vdb[idx], im[i], dd[i]);
      gv = dsv * svb[idx];
      dst = dsv * scale * expf(a[i] - a[j] + li[j]);
    }
    gm[i * (L + 1) + j] = gv;
    dsts[i * LDT + j] = __float2bfloat16(dst);
  }
  __syncthreads();
  if (t < L) {  // G's row sums less its column sums, and the row's record
    float rs = 0.f, cs = 0.f;
    for (int j = 0; j < L; ++j) rs += gm[t * (L + 1) + j];
    for (int i = 0; i < L; ++i) cs += gm[i * (L + 1) + t];
    rows[(cidx * 2) * L + t] = rs - cs + rr[t];
    rows[(cidx * 2 + 1) * L + t] = cs;
  }

  // dq rows 16 w .. + 15 and the chunk-internal dk rows 16 w .. + 15, a
  // 64-column tile at a time
  const float* ub = uo + cidx * hd * L;
  const float* nb = nst + cidx * hd;
  for (int dt = 0; dt < nd; ++dt) {
    cp_async_wait<0>();
    __syncthreads();  // tile dt landed; the other stage is free
    if (dt + 1 < nd) {
      load_tile64(tile(0, (dt + 1) & 1), k + row0 * hd, hd, (dt + 1) * DT, t,
                  SC_THREADS);
      load_tile64(tile(1, (dt + 1) & 1), q + row0 * hd, hd, (dt + 1) * DT, t,
                  SC_THREADS);
      cp_async_commit();
    }
    const bf16* kt = tile(0, dt & 1);
    const bf16* qt = tile(1, dt & 1);
    float aq[8][4], ak[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) aq[nt][x] = ak[nt][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < L; kk += 16) {
      if (kk <= 16 * w) {  // dq: dS~[i, j] is 0 for j > i
        uint32_t af[4];
        ldsm_x4(af, smem_u32(dsts + (16 * w + (lane & 15)) * LDT + kk +
                             (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, smem_u32(kt + (kk + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LDT +
                                  16 * np + (lane >> 4) * 8));
          mma_bf16_16816(aq[2 * np], af, bfr[0], bfr[1]);
          mma_bf16_16816(aq[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
      if (kk >= 16 * w) {  // dk: dS~[i, j] is 0 for i < j
        uint32_t af[4];
        ldsm_x4_t(af, smem_u32(dsts + (kk + (lane & 7) + (lane >> 4) * 8) *
                                          LDT +
                               16 * w + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, smem_u32(qt + (kk + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LDT +
                                  16 * np + (lane >> 4) * 8));
          mma_bf16_16816(ak[2 * np], af, bfr[0], bfr[1]);
          mma_bf16_16816(ak[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * w + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = dt * DT + 8 * nt + 2 * tq;
        if (d >= hd) continue;
        const float q0 = r_[i] * fmaf(ub[(int64_t)d * L + i], im[i],
                                      nb[d] * dd[i]);
        const float q1 = r_[i] * fmaf(ub[(int64_t)(d + 1) * L + i], im[i],
                                      nb[d + 1] * dd[i]);
        *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + i) * hd + d) =
            __floats2bfloat162_rn(q0 + aq[nt][2 * half],
                                  q1 + aq[nt][2 * half + 1]);
        *reinterpret_cast<float2*>(dki + (row0 + i) * hd + d) =
            make_float2(ak[nt][2 * half], ak[nt][2 * half + 1]);
      }
    }
    // q^T (r dden) over the tile's columns, for dn
    const int d = dt * DT + (t & 63);
    if (t < 64 && d < hd) {
      float sum = 0.f;
#pragma unroll 8
      for (int i = 0; i < L; ++i)
        sum = fmaf(rd[i], __bfloat162float(qt[i * LDT + t]), sum);
      dns[cidx * hd + d] = sum;
    }
  }
}

// ---------------------------------------------------------------- 6

__global__ void __launch_bounds__(ROW_THREADS)
mlstm_bwd_sm90_gates(const bf16* __restrict__ k, const float* __restrict__ ig,
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
                     bf16* __restrict__ dk, float* __restrict__ dn0,
                     float* __restrict__ di, float* __restrict__ df, int s,
                     int hd, int n_db) {
  extern __shared__ __align__(16) float dnp[];  // [hd]: dn'
  __shared__ float es[L], da[L], red[ROW_THREADS];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const int64_t cidx = (int64_t)bh * nc + ch;
  const float* rbh = rec + (int64_t)bh * nc * REC * L;
  const float* rb = rec + cidx * REC * L;
  const float* nsb = dns + (int64_t)bh * nc * hd;
  float part = 0.f;  // its share of dn' . n
  for (int d = t; d < hd; d += ROW_THREADS) {
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
  for (int j = w; j < L; j += ROW_THREADS / 32) {
    const float wc = rb[R_WC * L + j];
    const int64_t off = (row0 + j) * hd;
    float kd = 0.f;
    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 kk = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(k + off + d));
      const float2 yy = *reinterpret_cast<const float2*>(yo + off + d);
      const float2 ii = *reinterpret_cast<const float2*>(dki + off + d);
      kd = fmaf(kk.x, dnp[d], kd);
      kd = fmaf(kk.y, dnp[d + 1], kd);
      *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
          __floats2bfloat162_rn(fmaf(wc, yy.x + dnp[d], ii.x),
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
    for (int i = 0; i < ROW_THREADS; ++i) nd_ += red[i];
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
      *rows;
  bf16 *pt, *dct;
};

// Byte offsets of the workspace's parts, each 256-byte aligned; returns the
// total.  Fills w where given.
static int64_t ws_layout(int bh, int s, int hd, Ws* w, unsigned char* base) {
  const int64_t nc = s / L, n_db = (hd + BE - 1) / BE, ncb = (int64_t)bh * nc;
  const int64_t sizes[15] = {4 * ncb * REC * L,       // rec
                             4 * ncb * L * L,         // S
                             4 * ncb * L * L,         // VD
                             4 * ncb * hd,            // sum_j wc_j k_j
                             4 * ncb * hd,            // chunk-start n
                             4 * ncb * hd * L,        // u^T
                             4 * (int64_t)bh * s * hd,  // y
                             4 * (int64_t)bh * s * hd,  // dk inside
                             4 * ncb * hd,            // q^T (r dden)
                             4 * ncb * n_db * L,      // x parts
                             4 * ncb * n_db * L,      // k . y parts
                             4 * ncb * n_db,          // <dC', C> parts
                             4 * ncb * 2 * L,         // intra's row parts
                             2 * ncb * L * L,         // (S / m)^T
                             2 * ncb * hd * hd};      // dC'^T
  void* ptrs[15] = {&w->rec, &w->sv,  &w->vd,  &w->ksum, &w->nst,
                    &w->u,   &w->y,   &w->dki, &w->dns,  &w->xp,
                    &w->kyp, &w->ddp, &w->rows, &w->pt,  &w->dct};
  int64_t off = 0;
  for (int i = 0; i < 15; ++i) {
    if (w != nullptr) *reinterpret_cast<void**>(ptrs[i]) = base + off;
    off += (sizes[i] + 255) & ~(int64_t)255;
  }
  return off;
}

// A map of a (rows, hd) bf16 matrix with boxes of 64 columns x 64 rows under
// the 128-byte swizzle; columns past hd read as zeros.
static int make_map(CUtensorMap* map, const void* ptr, long long rows,
                    int hd) {
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)hd, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)hd * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A map of the stored dC'^T, (chunks, hd rows e, hd columns d) bf16, with
// boxes of BE columns x 64 rows of one chunk, unswizzled; rows and columns
// past hd read as zeros.
static int make_dc_map(CUtensorMap* map, const void* ptr, long long chunks,
                       int hd) {
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)hd,
                              (cuuint64_t)chunks, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * hd * 2,
                                 (cuuint64_t)chunks * hd * hd * 2};
  const cuuint32_t box[4] = {BE, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The chunk the wrapper pads S to.
extern "C" int mlstm_bwd_sm90_chunk_len() { return L; }

// The largest head dim (a multiple of DT) whose slabs fit both walks.
extern "C" int mlstm_bwd_sm90_max_hd() {
  int hd = DT;
  while (dwalk_smem_bytes(hd + DT) <= SMEM_MAX &&
         cwalk_smem_bytes(hd + DT) <= SMEM_MAX)
    hd += DT;
  return hd;
}

// Bytes of workspace a call needs (the wrapper allocates them).
extern "C" long long mlstm_bwd_sm90_workspace_bytes(int bh, int s, int hd) {
  if (bh <= 0 || s <= 0 || hd <= 0 || s % L != 0) return 0;
  return ws_layout(bh, s, hd, nullptr, nullptr);
}

// Returns 0, a cudaError_t, or ERR_ENCODE + a CUresult.  The caller checks
// dtypes (bf16 q, k, v, dh, dq, dk, dv; float32 gates, carries and their
// gradients) and shapes and pads S to a multiple of L (dh with zeros);
// c0, n0, dc_final, dn_final may be null (zeros); dc0 (bh, hd, hd) and dn0
// (bh, hd) are always written; ws holds
// mlstm_bwd_sm90_workspace_bytes(...) bytes, 256-byte aligned.
extern "C" int mlstm_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* dh,
    const void* ig, const void* fg, const void* c0, const void* n0,
    const void* dc_final, const void* dn_final, void* dq, void* dk, void* dv,
    void* di, void* df, void* dc0, void* dn0, void* ws, int bh, int s,
    int hd, double scale, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % L != 0 || s / L > 65535 ||
      hd <= 0 || hd % 8 != 0 || hd > mlstm_bwd_sm90_max_hd() ||
      (long long)bh * s > 0x7fffffff || ((uintptr_t)ws & 255) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Ws w;
  ws_layout(bh, s, hd, &w, (unsigned char*)ws);
  const int nc = s / L, n_db = (hd + BE - 1) / BE;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *dhb = (const bf16*)dh;
  const float *igf = (const float*)ig, *fgf = (const float*)fg;
  const dim3 chunks(nc, bh), cols(n_db, bh);
  const float sc = (float)scale;
  cudaError_t err;

  size_t smem = 8 * sizeof(bf16) * L * LDT;
  if ((err = allow_smem(mlstm_bwd_sm90_scores, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_sm90_scores<<<chunks, SC_THREADS, smem, st>>>(
      qb, kb, vb, dhb, igf, fgf, w.rec, w.sv, w.vd, w.ksum, s, hd, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  mlstm_bwd_sm90_den<<<chunks, ROW_THREADS, sizeof(float) * (hd + L), st>>>(
      qb, w.rec, w.sv, w.ksum, (const float*)n0, w.nst, w.pt, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  CUtensorMap kmap, qmap, dhmap, vmap, dcmap;
  int e = make_map(&kmap, k, (long long)bh * s, hd);
  if (!e) e = make_map(&qmap, q, (long long)bh * s, hd);
  if (!e) e = make_map(&dhmap, dh, (long long)bh * s, hd);
  if (!e) e = make_map(&vmap, v, (long long)bh * s, hd);
  if (!e) e = make_dc_map(&dcmap, w.dct, (long long)bh * nc, hd);
  if (e) return e;

  smem = dwalk_smem_bytes(hd);
  if ((err = allow_smem(mlstm_bwd_sm90_dwalk, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_sm90_dwalk<<<cols, WALK_THREADS, smem, st>>>(
      kmap, qmap, dhb, w.pt, w.rec, (const float*)dc_final, w.dct,
      (float*)dc0, (bf16*)dv, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = cwalk_smem_bytes(hd);
  if ((err = allow_smem(mlstm_bwd_sm90_cwalk, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_sm90_cwalk<<<cols, WALK_THREADS, smem, st>>>(
      dhmap, vmap, dcmap, qb, kb, w.rec, (const float*)c0, w.u, w.y, w.xp,
      w.kyp, w.ddp, s, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = sizeof(bf16) * 5 * L * LDT + sizeof(float) * (L * (L + 1) + 8 * L);
  if ((err = allow_smem(mlstm_bwd_sm90_intra, smem)) != cudaSuccess)
    return (int)err;
  mlstm_bwd_sm90_intra<<<chunks, SC_THREADS, smem, st>>>(
      qb, kb, w.rec, w.sv, w.vd, w.nst, w.u, w.xp, w.rows, w.dki, w.dns,
      (bf16*)dq, s, hd, n_db, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  mlstm_bwd_sm90_gates<<<chunks, ROW_THREADS, sizeof(float) * hd, st>>>(
      kb, igf, fgf, w.rec, w.rows, w.nst, w.dns, w.y, w.dki, w.kyp, w.ddp,
      (const float*)dn_final, (bf16*)dk, (float*)dn0, (float*)di, (float*)df,
      s, hd, n_db);
  return (int)cudaGetLastError();
}
