// Chunkwise mLSTM in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_kernel.py (_kernel,
// wrapper mlstm_chunkwise) for bf16 q, k, v with hd a multiple of 8 up to
// mlstm_sm90_max_hd(); float32, and every other bf16 head dim, stay on the
// CUDA-core kernel of mlstm_kernel.cu.  It computes what that file's header
// states: for q, k, v (BH, S, hd), gates i_raw, f_raw (BH, S) float32 and the
// carry C (BH, hd, hd), n (BH, hd) float32, S a multiple of the chunk
// L = 64, per chunk
//   li = min(i_raw, 8), a = cumsum_chunk(log_sigmoid(f_raw)),
//   S_ij = (q_i . k_j) / sqrt(hd) * exp(a_i - a_j + li_j)   for j <= i,
//   r_i = exp(a_i) / sqrt(hd),  wc_j = exp(a_L - a_j + li_j),
//   out_i = r_i (q_i C) + sum_j S_ij v_j,  den_i = r_i (q_i . n) + sum_j S_ij,
//   h_i = out_i / max(|den_i|, 1),
//   C <- exp(a_L) C + sum_j wc_j k_j^T v_j,  n <- exp(a_L) n + sum_j wc_j k_j,
// with the exponents summed before exp, and writes h (bf16) and the final C
// and n.
//
// Bound on the H100: at the serving shape (BH = 16, S = 1,024, hd = 1,024)
// the function is 73 GFLOP (4 hd^2 + 4 L hd per token and head), 0.074 ms
// at the 989 TFLOP/s bf16 peak, and moves about 200 MB (0.060 ms at
// 3.35 TB/s).
//
// Precision.  bf16 x bf16 products are exact in the fp32 accumulators, so
// only three roundings are new, and each is held to the bounds the card
// checks use (tests/test_torch_mlstm_split.py repeats them on the CPU): S is
// rounded to bf16 for S v (its row sums stay fp32); C to bf16 for q C (q
// stays exactly bf16, and r_i multiplies the fp32 product, so the gate is
// not rounded into q); and in the update the gated factor v wc, formed in
// fp32, is split into (v wc)_hi = bf16(v wc) and (v wc)_lo = bf16(v wc -
// (v wc)_hi), two products with the exact k, because one rounding moves C by
// about 2e-3 of its scale against a bound of 1e-4.  n and den are fp32 on
// the CUDA cores.
//
// Design: three passes; every product on mma.sync.m16n8k16 (bf16 in, fp32
// out) with operands through ldmatrix.
//  1. mlstm_scores_sm90, one block of 4 warps per (chunk, bh), all chunks in
//     parallel: q k^T over hd in tiles of 64 (cp.async, double-buffered); in
//     the epilogue the gate, the causal mask and 1 / sqrt(hd) in fp32.
//     Writes S in bf16, per chunk four rows of 64 floats (r_i, wc_j, the fp32
//     row sums of S, exp(a_L)) and the chunk's fp32 sum_j wc_j k_j.
//  2. mlstm_den_sm90, one block per (chunk, bh), all chunks in parallel:
//     the n that enters the chunk, from n0 and the earlier chunks' sums (a
//     scan of at most S / L steps), then den_i = row sum + r_i (q_i . n) in
//     place of the row sums; the last chunk's block writes the final n.
//  3. mlstm_carry_sm90<BE>, one block of BE / 4 warps (two groups of four at
//     BE = 32) per (BE value columns, bh), walks the chunks in order.  Its
//     slab of C is held in shared memory for the whole walk, as C^T (BE rows
//     of hd fp32, each padded to start 8 banks after the last): read from
//     c0 once, written once.  A step takes one 64-row tile of C per warp
//     group; thread 0 brings the next step's q and k tiles by TMA (128-byte
//     swizzle, one mbarrier a stage) into the other of two slots.  Warp p of
//     a group owns tile rows 16 p .. + 15 and every slab column:
//       - its C_old, read from the slab as accumulator fragments and packed
//         to bf16, is the A fragment of out^T += C^T q^T (all slab columns
//         x all 64 rows i, summed over its rows of C), q^T the B fragment;
//       - C^T = exp(a_L) C^T + (v wc)_lo^T k + (v wc)_hi^T k, whose A
//         fragments are made once a chunk and stay in registers, and whose
//         accumulators go back to the slab.
//     A chunk's first step also gives (S v)^T for each warp's eight rows i
//     (S, v and the gates come by cp.async a chunk ahead); at its last,
//     each warp's part of out^T takes r_i, the parts are summed through the
//     step's slot, and h = out / max(|den|, 1) leaves through shared memory
//     in 16-byte rows.
//     BE = 32 while the slab fits (hd <= 1,152: at the serving shape 512
//     blocks of 8 warps, one per SM at a time), else 16.
// Loading q and k with 16-byte cp.async from every thread stalled the warps
// as long as the transfer took; one TMA request a tile does not.  What
// bounds it now: every column block reads each chunk's whole q and k, hd /
// BE times over per bh (about 2 GB through L2 at the serving shape), each
// step reads and writes its C tile in shared memory, and the warps meet at
// a barrier every step.  A cluster of two blocks sharing q and k (TMA
// multicast) would halve the first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define L 64              // chunk
#define DT 64             // rows d of C (columns of q, k) per tile
#define LDT 72            // bf16 row stride of a 64-column tile: rows 16 B
                          // apart in banks, so ldmatrix is conflict-free
#define SC_THREADS 128    // scores pass
#define DEN_THREADS 256   // den pass
#define I_CAP 8.0f
#define SMEM_MAX 232448   // dynamic shared memory a block may opt into

typedef __nv_bfloat16 bf16;

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

__global__ void __launch_bounds__(SC_THREADS)
mlstm_scores_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const float* __restrict__ ig, const float* __restrict__ fg,
                  bf16* __restrict__ sc, float* __restrict__ gates,
                  float* __restrict__ ksum, int s, int hd, float scale) {
  __shared__ __align__(16) bf16 qs[2][L * LDT];
  __shared__ __align__(16) bf16 ks[2][L * LDT];
  __shared__ float li[L], a[L], wc[L];
  const int ch = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
  const bf16* qb = q + row0 * hd;
  const bf16* kb = k + row0 * hd;
  float* kso = ksum + ((int64_t)bh * nc + ch) * hd;
  const int nd = (hd + DT - 1) / DT;

  load_tile64(qs[0], qb, hd, 0, t, SC_THREADS);
  load_tile64(ks[0], kb, hd, 0, t, SC_THREADS);
  cp_async_commit();
  // gates: one thread adds the L log forget gates in order
  if (t < L) {
    li[t] = fminf(ig[row0 + t], I_CAP);
    a[t] = log_sigmoid(fg[row0 + t]);
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
  if (t < L) wc[t] = expf(a[L - 1] - a[t] + li[t]);

  // warp w: score rows 16 w .. + 15, all 64 keys (8 n-tiles)
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.f;
  for (int dt = 0; dt < nd; ++dt) {
    cp_async_wait<0>();
    __syncthreads();  // tile dt landed; the other stage is free
    if (dt + 1 < nd) {
      load_tile64(qs[(dt + 1) & 1], qb, hd, (dt + 1) * DT, t, SC_THREADS);
      load_tile64(ks[(dt + 1) & 1], kb, hd, (dt + 1) * DT, t, SC_THREADS);
      cp_async_commit();
    }
    const bf16* qt = qs[dt & 1];
    const bf16* kt = ks[dt & 1];
#pragma unroll
    for (int kk = 0; kk < DT; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, smem_u32(qt + (16 * w + (lane & 15)) * LDT + kk +
                           (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // keys 16 np .. + 15
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(kt + (16 * np + (lane & 7) + (lane >> 4) * 8) *
                                      LDT +
                             kk + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    // sum_j wc_j k_j over the tile's columns, for n
    const int d = dt * DT + (t & 63);
    if (t < 64 && d < hd) {
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < L; ++j)
        sum = fmaf(wc[j], __bfloat162float(kt[j * LDT + t]), sum);
      kso[d] = sum;
    }
  }

  bf16* scb = sc + ((int64_t)bh * nc + ch) * L * L;
  float* gb = gates + ((int64_t)bh * nc + ch) * 4 * L;
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
      *reinterpret_cast<__nv_bfloat162*>(scb + i * L + j) =
          __floats2bfloat162_rn(v0, v1);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (tq == 0) gb[2 * L + i] = sum;
  }
  if (t < L) {
    gb[t] = scale * expf(a[t]);
    gb[L + t] = wc[t];
    gb[3 * L + t] = t == 0 ? expf(a[L - 1]) : 0.f;
  }
}

// The n entering chunk ch (n0 decayed and summed through the earlier
// chunks), then den_i = rowsum_i + r_i (q_i . n) over the row sums in
// gates; the last chunk's block also writes the final n.
__global__ void __launch_bounds__(DEN_THREADS)
mlstm_den_sm90(const bf16* __restrict__ q, float* __restrict__ gates,
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
      n = fmaf(gbh[(c * 4 + 3) * L], n, kbh[(int64_t)c * hd + d]);
    nprev[d] = n;
    if (ch == nc - 1)
      n_out[(int64_t)bh * hd + d] =
          fmaf(gbh[(ch * 4 + 3) * L], n, kbh[(int64_t)ch * hd + d]);
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
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  float* gb = gates + ((int64_t)bh * nc + ch) * 4 * L;
  if (part == 0) gb[2 * L + i] = fmaf(gb[i], dot, gb[2 * L + i]);
}

// A 64 x 64 bf16 tile as TMA writes it under the 128-byte swizzle: 128-byte
// rows, the 16-byte chunk c of row r at chunk c ^ (r % 8), so that the
// eight rows an ldmatrix reads fall in eight different bank groups.
#define TILE_BYTES (L * 128)
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int c) {
  return tile + r * 128 + (((c ^ r) & 7) << 4);
}

// Stages of the carry pass's q and k ring: two slots of one tile pair (q,
// k) per warp group.
__host__ __device__ constexpr int carry_stages(int be) { return 2 * (be / 16); }

// Shared memory of a carry block, in bytes: alignment for the swizzled
// stages, the stages, the C^T slab, one chunk of S and v, two chunks of
// gates, the stages' mbarriers.  A chunk's end sums out and stages h in the
// slot its last tiles used.
static size_t carry_smem_bytes(int be, int hd) {
  const size_t hdp = (size_t)(hd + DT - 1) / DT * DT;
  return 1024 + (size_t)carry_stages(be) * 2 * TILE_BYTES +
         4 * (size_t)be * (hdp + 8) + 2 * L * LDT + 2 * L * (be + 8) +
         4 * 2 * 4 * L + 8 * carry_stages(be);
}

template <int BE>
__global__ void __launch_bounds__(BE * 8, 1)
mlstm_carry_sm90(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const bf16* __restrict__ v, const bf16* __restrict__ sc,
                 const float* __restrict__ gates,
                 const float* __restrict__ c0, float* __restrict__ c_out,
                 bf16* __restrict__ h, int s, int hd) {
  constexpr int MT = BE / 16;       // m-tiles of slab columns
  constexpr int NW = BE / 4;        // warps
  constexpr int TP = NW / 4;        // warp groups = tiles per step
  constexpr int NT = 32 * NW;       // threads
  constexpr int NSV = 8 / NW;       // n-tiles of rows i per warp in S v
  constexpr int VST = BE + 8;       // bf16 row stride of the v slab and h
  extern __shared__ unsigned char smem_raw[];
  const int nd = (hd + DT - 1) / DT, hdp = nd * DT, cst = hdp + 8;
  const int nst = (nd + TP - 1) / TP;  // steps a chunk
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t stg = smem_u32(base);  // [2 TP][q, k]: slot sig % 2
  float* ct = reinterpret_cast<float*>(base + 2 * TP * 2 * TILE_BYTES);
  bf16* ss = reinterpret_cast<bf16*>(ct + BE * cst);  // [L][LDT]
  bf16* vs = ss + L * LDT;                            // [L][VST]
  float* gs = reinterpret_cast<float*>(vs + L * VST);  // [2][4 L]
  const uint32_t bars = smem_u32(gs + 2 * 4 * L);     // [2 TP] mbarriers

  const int e0 = blockIdx.x * BE, bh = blockIdx.y, nc = s / L;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int grp = w / 4, p = w % 4;  // tile of the step, rows 16 p of it

  if (t == 0) {
    for (int i = 0; i < 2 * TP; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  const float* cb = c0 ? c0 + (int64_t)bh * hd * hd : nullptr;
  for (int idx = t; idx < BE * hdp; idx += NT) {
    const int e = idx % BE, d = idx / BE;
    ct[e * cst + d] =
        (cb && d < hd && e0 + e < hd) ? cb[(int64_t)d * hd + e0 + e] : 0.f;
  }
  __syncthreads();

  // thread 0: q and k of step sig's tiles (chunk sig / nst, rows
  // (sig % nst) TP + u of C) into the stages of slot sig % 2; past nd a
  // step loads tile 0 again, unused, so every stage fills once a slot turn
  auto load_step = [&](int sig) {
    const int ch = sig / nst, pos0 = (sig - ch * nst) * TP;
    const int row = bh * s + ch * L;
#pragma unroll
    for (int u = 0; u < TP; ++u) {
      const int st = (sig & 1) * TP + u, dt = (pos0 + u) % nd;
      const uint32_t dst = stg + st * 2 * TILE_BYTES, bar = bars + 8 * st;
      mbar_expect_tx(bar, 2 * TILE_BYTES);
      tma_load2(dst, &qmap, bar, dt * DT, row);
      tma_load2(dst + TILE_BYTES, &kmap, bar, dt * DT, row);
    }
  };
  // a chunk's S, v slab and gates
  auto load_chunk = [&](int ch) {
    const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
    const bf16* scb = sc + ((int64_t)bh * nc + ch) * L * L;
    for (int idx = t; idx < L * 8; idx += NT) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      cp_async16(smem_u32(ss + r * LDT + c), scb + r * L + c, 16);
    }
    constexpr int VP = BE / 8;  // 16-byte pieces per row of the slab
    for (int idx = t; idx < L * VP; idx += NT) {
      const int r = idx / VP, c = (idx % VP) * 8;
      const int ok = e0 + c < hd ? 16 : 0;
      cp_async16(smem_u32(vs + r * VST + c),
                 v + (row0 + r) * hd + (ok ? e0 + c : 0), ok);
    }
    for (int idx = t; idx < L; idx += NT)
      cp_async16(smem_u32(gs + (ch & 1) * 4 * L + 4 * idx),
                 gates + ((int64_t)bh * nc + ch) * 4 * L + 4 * idx, 16);
    cp_async_commit();
  };

  float acc[MT][8][4];        // part of out^T (BE slab columns x 64 rows)
  float acc_sv[MT][NSV][4];   // (S v)^T, rows i 8 (NSV w + y) .. + 7
  uint32_t va_hi[MT][4][4], va_lo[MT][4][4];  // (v wc)^T, split
  float decay = 0.f;
  const int nsig = nc * nst;
  load_chunk(0);
  if (t == 0) load_step(0);
  for (int sig = 0; sig < nsig; ++sig) {
    const int ch = sig / nst, si = sig - ch * nst;
    const float* g4 = gs + (ch & 1) * 4 * L;
    if (si == 0) cp_async_wait<0>();  // the chunk's S, v and gates
#pragma unroll
    for (int u = 0; u < TP; ++u)
      mbar_wait(bars + 8 * ((sig & 1) * TP + u), (sig >> 1) & 1);
    __syncthreads();  // step sig landed; step sig - 1 is done with
    if (si == 0) {
      // (S v)^T = v^T S^T for this warp's rows i, with v^T exact; then
      // v^T scaled by wc and split into the update's A fragments
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
        const int ks = kk / 16, j = kk + 2 * tq;
        uint32_t sb[NSV][2];
#pragma unroll
        for (int y = 0; y < NSV; ++y)
          ldsm_x2(sb[y], smem_u32(ss + (8 * (NSV * w + y) + (lane & 7)) * LDT +
                                  kk + ((lane >> 3) & 1) * 8));
        // a0, a1 hold rows j, j + 1 of v; a2, a3 rows j + 8, j + 9
        const float wa0 = g4[L + j], wa1 = g4[L + j + 1];
        const float wb0 = g4[L + j + 8], wb1 = g4[L + j + 9];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t va[4];
          ldsm_x4_t(va, smem_u32(vs + (kk + (lane & 7) + (lane >> 4) * 8) *
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
      decay = g4[3 * L];
      __syncthreads();  // S and v read: the next chunk's may come
      if (ch + 1 < nc) load_chunk(ch + 1);
    }
    if (t == 0 && sig + 1 < nsig) load_step(sig + 1);

    if (si * TP + grp < nd) {
      const int dt = si * TP + grp;
      const uint32_t qt = stg + ((sig & 1) * TP + grp) * 2 * TILE_BYTES;
      const uint32_t kt = qt + TILE_BYTES;
      float* crow = ct + g * cst + dt * DT + 16 * p + 2 * tq;
      float uacc[MT][2][4];
      uint32_t ca[MT][4];  // bf16(C_old) as the A fragment of C^T q^T
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
      // out^T += bf16(C_old)^T q^T over these 16 rows of C, all 64 rows i
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // rows i 16 np .. + 15
        uint32_t qb[4];
        ldsm_x4(qb, swz(qt, 16 * np + (lane & 7) + (lane >> 4) * 8,
                        2 * p + ((lane >> 3) & 1)));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16_16816(acc[m][2 * np], ca[m], qb[0], qb[1]);
          mma_bf16_16816(acc[m][2 * np + 1], ca[m], qb[2], qb[3]);
        }
      }
      // C^T = exp(a_L) C^T + (v wc)_lo^T k + (v wc)_hi^T k
#pragma unroll
      for (int kk = 0; kk < L; kk += 16) {
        const int ks = kk / 16;
        uint32_t kb[4];
        ldsm_x4_t(kb, swz(kt, kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * p + (lane >> 4)));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16_16816(uacc[m][0], va_lo[m][ks], kb[0], kb[1]);
          mma_bf16_16816(uacc[m][1], va_lo[m][ks], kb[2], kb[3]);
          mma_bf16_16816(uacc[m][0], va_hi[m][ks], kb[0], kb[1]);
          mma_bf16_16816(uacc[m][1], va_hi[m][ks], kb[2], kb[3]);
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
      // the chunk's h: each warp's part of out^T takes its row factor
      // r_i; the parts are summed through the slot of this step (the upper
      // half of the warps into the lower, then every warp its rows i from
      // the lower half's sums, with its S v), and h leaves through shared
      // memory in 16-byte rows
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = 8 * x + 2 * tq;
        const float r0 = g4[i], r1 = g4[i + 1];
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
      // slot sl, m-tile m, n-tile x: a float4 per lane
      auto at = [&](int sl, int m, int x) {
        return reinterpret_cast<float4*>(
            red + (((sl * MT + m) * 8 + x) * 32 + lane) * 4);
      };
      __syncthreads();  // the slot's q and k are read
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
      for (int y = 0; y < NSV; ++y) {  // rows i = 8 (NSV w + y) + 2 tq, + 1
        const int i = 8 * (NSV * w + y) + 2 * tq;
        const float inv0 = 1.f / fmaxf(fabsf(g4[2 * L + i]), 1.f);
        const float inv1 = 1.f / fmaxf(fabsf(g4[2 * L + i + 1]), 1.f);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int e = 16 * m + g;
          hst[i * VST + e] = __float2bfloat16(acc_sv[m][y][0] * inv0);
          hst[(i + 1) * VST + e] = __float2bfloat16(acc_sv[m][y][1] * inv1);
          hst[i * VST + e + 8] = __float2bfloat16(acc_sv[m][y][2] * inv0);
          hst[(i + 1) * VST + e + 8] =
              __float2bfloat16(acc_sv[m][y][3] * inv1);
        }
      }
      __syncthreads();
      const int64_t row0 = (int64_t)bh * s + (int64_t)ch * L;
      constexpr int VP = BE / 8;
      for (int idx = t; idx < L * VP; idx += NT) {
        const int r = idx / VP, c = (idx % VP) * 8;
        if (e0 + c < hd)
          *reinterpret_cast<uint4*>(h + (row0 + r) * hd + e0 + c) =
              *reinterpret_cast<const uint4*>(hst + r * VST + c);
      }
    }
    // this step's reads and writes of its slot come before the TMA loads
    // that refill it
    fence_proxy_async();
  }
  __syncthreads();
  float* co = c_out + (int64_t)bh * hd * hd;
  for (int idx = t; idx < BE * hdp; idx += NT) {
    const int e = idx % BE, d = idx / BE;
    if (d < hd && e0 + e < hd) co[(int64_t)d * hd + e0 + e] = ct[e * cst + d];
  }
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

template <int BE>
static int launch_carry(const void* q, const void* k, const void* v,
                        const void* sc, const void* gates, const void* c0,
                        void* c_out, void* h, int bh, int s, int hd,
                        cudaStream_t st) {
  CUtensorMap qmap, kmap;
  int err = make_map(&qmap, q, (long long)bh * s, hd);
  if (!err) err = make_map(&kmap, k, (long long)bh * s, hd);
  if (err) return err;
  const size_t smem = carry_smem_bytes(BE, hd);
  static size_t attr_bytes = 0;  // the largest opted into so far
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_carry_sm90<BE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  mlstm_carry_sm90<BE><<<dim3((hd + BE - 1) / BE, bh), BE * 8, smem, st>>>(
      qmap, kmap, (const bf16*)v, (const bf16*)sc, (const float*)gates,
      (const float*)c0, (float*)c_out, (bf16*)h, s, hd);
  return (int)cudaGetLastError();
}

// The chunk the wrapper pads S to.
extern "C" int mlstm_sm90_chunk_len() { return L; }

// The largest head dim whose slab fits a block at BE = 16.
extern "C" int mlstm_sm90_max_hd() {
  int hd = DT;
  while (carry_smem_bytes(16, hd + DT) <= SMEM_MAX) hd += DT;
  return hd;
}

// Returns 0, a cudaError_t, or ERR_ENCODE + a CUresult.  The caller checks
// dtypes (bf16 q, k, v, h;
// float32 gates, carry and scratch) and shapes, pads S to a multiple of L
// and passes c0 and n0 as null where there are none (zeros).  Scratch: sc
// (BH, S / L, L, L) bf16, gates (BH, S / L, 4, L) and ksum (BH, S / L, hd)
// float32.  c_out and n_out receive the final C and n.
extern "C" int mlstm_sm90_launch(const void* q, const void* k, const void* v,
                                 const void* ig, const void* fg, void* sc,
                                 void* gates, void* ksum, const void* c0,
                                 const void* n0, void* c_out, void* n_out,
                                 void* h, int bh, int s, int hd, double scale,
                                 void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s % L != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > mlstm_sm90_max_hd() ||
      (long long)bh * s > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 chunks(s / L, bh);
  mlstm_scores_sm90<<<chunks, SC_THREADS, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const float*)ig, (const float*)fg,
      (bf16*)sc, (float*)gates, (float*)ksum, s, hd, (float)scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_den_sm90<<<chunks, DEN_THREADS, sizeof(float) * hd, st>>>(
      (const bf16*)q, (float*)gates, (const float*)ksum, (const float*)n0,
      (float*)n_out, s, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (carry_smem_bytes(32, hd) <= SMEM_MAX)
    return launch_carry<32>(q, k, v, sc, gates, c0, c_out, h, bh, s, hd, st);
  return launch_carry<16>(q, k, v, sc, gates, c0, c_out, h, bh, s, hd, st);
}
