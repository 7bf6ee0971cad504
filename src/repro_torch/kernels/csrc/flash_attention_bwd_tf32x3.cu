// The gradient of blockwise (flash) attention in float32 on Hopper's tensor
// cores (sm_90a): every product as three TF32 mma.sync, so that the sums keep
// float32 accuracy.
//
// What it replaces.  The JAX package has no backward Pallas kernel: its
// models call the jnp attention (src/repro/models/attention.py:40) and
// jax.grad differentiates that.  This kernel computes that gradient for the
// function that the forward kernel of src/repro/kernels/flash_attention.py
// (_kernel, wrapper flash_attention_flat :91) computes, the same function as
// flash_attention_bwd.cu (the first design, float32 FMAs on the CUDA cores),
// flash_attention_bwd_sm90.cu (bf16) and repro_torch.kernels.ref.
// attention_flat_bwd_plain: for q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd),
// query head h reading kv head h / (H / Hkv),
//   o_i  = sum_j p_ij v_j,   p_ij = softmax_j(scale * q_i . k_j)
// over the visible keys j: j < Sk; j <= i when causal (top-left aligned,
// also when Sq != Sk); j > i - window when window > 0.  Given o and dO:
//   D_i   = dO_i . o_i
//   dp_ij = dO_i . v_j,   ds_ij = p_ij (dp_ij - D_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_{i, heads of the group} ds_ij q_i
//   dv_j  = sum_{i, heads of the group} p_ij dO_i
// float32 tensors, head dim a multiple of 8 up to 256; sums in float32.  A
// row with no visible key gets dq = 0; a key no query sees gets dk = dv = 0.
//
// The arithmetic.  A single TF32 product keeps 11 bits of each operand
// and would move the float32 parity runs.  So each float32 operand x is
// split, as it goes from shared memory into a fragment, into hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (sm90.cuh: split_tf32), and
// each product A B is three mma.sync.m16n8k8 tf32 into the same float32
// accumulators, per k-step of 8: lo(A) hi(B), hi(A) lo(B), then hi(A) hi(B);
// lo lo is dropped (CUTLASS's OpMultiplyAddFastF32).  The operands are
// rounded explicitly: mma.sync ignores the low 13 bits of a tf32 operand, so
// an unrounded one would be truncated.  All five products take the split:
// S = Q K^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K.  The
// softmax, D, P = 2^(S scale log2 e - lse) and dS = P (dP - D) stay float32
// on the CUDA cores.  tests/test_torch_flash_bwd_tf32x3.py rebuilds these
// roundings in plain torch.
//
// Bound on the H100: operations.  10 hd FLOPs per visible (query, key) pair
// and query head (the five products); at qwen3_4b's train shape (B=4,
// S=1,024, 32/8 heads, hd 128, causal) 8.6e10 FLOPs, which the split makes
// three TF32 products each: 0.522 ms at the 494.7 TFLOP/s dense TF32 peak,
// against 1.283 at the 67 TFLOP/s float32 CUDA-core peak of the first
// design; 100 MB of q, k, v, o, dO, dq, dk, dv (0.030 ms at 3.35 TB/s).
// This design does S and dP in both kernels: 14 hd FLOPs a pair.  The
// split costs more than its three products: sm_90a has no tf32 conversion
// instruction, so ptxas expands each cvt.rna.tf32.f32 to four integer and
// compare instructions (eight with the subtraction for a hi/lo pair), and
// the design is held by instruction issue, not by the tensor cores.  So it
// shapes the warps' tiles to split each operand element as few times as it
// can.
//
// Design: two kernels (a third above hd 128 with the heads split),
// deterministic, no atomics: every output element is written by one block,
// and partial sums are added in a fixed order, so two calls give the same
// bits.  HDT is the head dim rounded up to 64, 128 or 256; a block has 8
// warps.  Tiles are staged in shared memory as float32 by
// 16-byte cp.async (rows of HDT + 4 floats: LD % 32 == 4; columns hd ..
// HDT - 1 and rows past the end zero-filled, so that no branch surrounds an
// mma.sync, which would make ptxas wrap each in a WARPSYNC), split to hi and
// lo when they go into fragments; neither half is kept in shared memory.
// Per tile of the other side (T = 64 rows up to hd 128, 32 above):
// - S and dP (S^T and dP^T in the dk/dv kernel) each on one half of the
//   warps, in 32 x 32 warp tiles (32 x 16 at HDT 256): an operand element
//   split once a k-step serves 4 products where a 16-row tile computing
//   both S and dP gave it 2 (splits a product 0.67 against 1.0).
// - P (P^T) goes through shared memory from the S half to the dP half,
//   which forms dS = P (dP - D) there; dQ += dS K is then a 32-row tile a
//   warp (32 x HDT / 4), dV += P^T dO on the first half and dK += dS^T Q
//   on the second 32 x HDT / 2 tiles (splits a product 0.5 at HDT 128).
// - flash_bwd_tf32x3_dq: one block per (64 query rows, head, batch row),
//   the heaviest causal tiles first.  It stages Q and dO once, computes D
//   from dO and o, and walks the visible key tiles once (K and V staged)
//   with the forward's online softmax in base 2: each row's running max m
//   (the two S warps of a row exchange their tile maxima through shared
//   memory) and sum l, P~ = 2^(S scale log2 e - m) and dS~ = P~ (dP - D)
//   against the running max, and the dQ accumulator rescaled by 2^(m_old -
//   m_new) as each tile's products join it; at the end dq = scale dQ / l
//   (0 where a row sees no key) and lse = m + log2 l (NO_LSE there).  The
//   float32 forward saves no lse: this pass makes it, without a second walk
//   over the keys, and writes it with D to a (B, H, Sq) scratch.
// - flash_bwd_tf32x3_dkdv: one block per (64 keys, kv head, batch row, part
//   of the group's query heads), the first (heaviest causal) keys first.  K
//   and V stay in shared memory; for each head of the part and each visible
//   query tile (Q, dO, lse and D staged): S^T, P^T = 2^(S^T scale log2 e -
//   lse), dP^T, dS^T, then dV and dK; the dS^T half waits on a named
//   barrier of its own warps only.
// - Accumulation: the tensor cores' float32 sums do not round to nearest,
//   and with every product of a row of keys or of a group's heads feeding
//   one accumulator their error grew with the length (on the H100,
//   chip_smoke's rglru_window case, 16 heads over a 2,048-key window: dk
//   off by 5.0e-5 of its norm, half the 1e-4 bound; 3.9e-6 here).  So each
//   tile's dQ, dV or dK products are summed from zero in registers (at most
//   T / 8 x 3 tensor-core adds) and join the accumulator by one rounded
//   fmaf, the dQ rescale folded in.
// - The products over the tile's rows take their A operand from a P or dS
//   tile in shared memory whose rows are LDX = T + 8 floats (LDX % 32 ==
//   8), and their B operand from a staged tile read down its rows: no
//   transposed copy.  m16n8k8's accumulator holds columns (2t, 2t + 1)
//   where its A fragment wants (t, t + 4), so each k-step permutes its 8
//   contracted rows: A column t is row 2t and A column t + 4 row 2t + 1, on
//   both operands.  A's pair is then one 8-byte load, the B fragment's two
//   rows 2t and 2t + 1 of the staged tile hit 32 distinct banks (2t LD + g,
//   LD % 32 == 4), and P and dS are stored as the accumulator holds them
//   (8-byte stores, LDX % 32 == 8: no bank conflict either way).
// - Shared memory at hd 128: dq 155 KB (Q, dO; K, V; P then dS in place),
//   dk/dv 172.5 KB (K, V; Q, dO; P^T, dS^T): one block an SM.  At hd 256 a
//   64-row float32 tile is 66.5 KB, hence T = 32 (212.5 and 220.4 KB); its
//   dK and dV tiles (32 x 128) take 128 accumulator registers a thread, so
//   the fresh partial products go four n-tiles at a time there.
// - The head split (hd above 128): as flash_attention_bwd_sm90.cu, a group's
//   H / Hkv heads are split over G parts, each a block (part p: heads p qpk
//   / G .. (p + 1) qpk / G - 1 of the group), G from the wrapper
//   (flash_attention.bwd_head_parts: 64-key blocks, about two an SM); at
//   G > 1 each part writes its unscaled float32 dK and dV to a per-call
//   workspace and flash_bwd_tf32x3_reduce sums the parts in order 0 .. G - 1.
// Only the predicate visible() decides P, and only on tiles that cross the
// band's edge, Sq or Sk; tiles wholly outside are skipped (tiles_meet).
// The masked-row trap: a row with no visible key gets lse = NO_LSE (1e30),
// so 2^(s - lse) = 0.
//
// Not yet here: wgmma (TF32 wgmma takes only K-major operands from shared
// memory: dV, dK and dQ would need transposed copies of P, dS, dO, Q and
// K), double-buffered tiles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define BR 64             // rows of a block's own tile (queries or keys)
#define NEG_INF_SCORE (-1e30f)
#define NO_LSE (1e30f)    // lse of a row with no visible key
#define FULL 0xffffffffu
#define REDUCE_THREADS 256

struct Strides {
  long long b, s, h;      // elements; the head-dim stride is 1
};

struct Problem {
  Strides q, k, v, o, dout;
  int h, hkv, sq, sk, hd, causal, window, parts;
  float scale, scale_log2;
};

// The shape of a block at head dim HDT (64, 128 or 256): W warps; tiles of
// 16 M x 8 N elements a warp (M m-tiles, N n-tiles of m16n8k8).  Eight
// warps at every HDT: 16 warps would halve the tiles (more hi/lo splits a
// product) and cap registers at 128 a thread.
template <int HDT>
struct Shape {
  static constexpr int W = 8;
  static constexpr int THREADS = 32 * W;
  static constexpr int T = HDT > 128 ? 32 : 64;     // streamed tile's rows
  static constexpr int LD = HDT + 4;                // floats a staged row
  static constexpr int LDX = T + 8;                 // floats a row of P, dS
  // S and dP (S^T and dP^T): each on one half of the warps, 16 MS x 8 NS,
  // the BR x T tile in W / 2 warp tiles
  static constexpr int SAREA = 2 * BR * T / W;
  static constexpr int MS = SAREA >= 512 ? 2 : 1;
  static constexpr int NS = SAREA / (16 * MS) / 8;
  static constexpr int SCOLS = T / (8 * NS);        // warp tiles across
  // dQ += dS K: every warp, 32 rows x 8 NQ (two warp rows)
  static constexpr int MQ = 2;
  static constexpr int NQ = HDT / (4 * W);
  static constexpr int QCOLS = HDT / (8 * NQ);
  // dV += P^T dO and dK += dS^T Q: each on one half of the warps, 32 rows
  // x 8 NK
  static constexpr int MK = 2;
  static constexpr int NK = HDT / (2 * W);
  static constexpr int KCOLS = HDT / (8 * NK);
  // n-tiles of a fresh partial product (product_nn): the whole warp tile,
  // but for the 32 x 64 and 32 x 128 tiles at HDT 256 (registers)
  static constexpr int CQ = NQ > 4 ? 4 : NQ;
  static constexpr int CK = NK > 8 ? 4 : NK;
  static_assert(LD % 32 == 4 && LDX % 32 == 8, "bank layout");
  static_assert((BR / (16 * MS)) * SCOLS == W / 2, "S and dP tiles");
  static_assert((BR / (16 * MQ)) * QCOLS == W, "dQ tiles");
  static_assert((BR / (16 * MK)) * KCOLS == W / 2, "dK and dV tiles");
  // shared memory, floats: Q, dO (BR rows), K, V (T), P~ then dS~ in
  // place, each row's D, max, sum and rescale, the tile's row maxima and
  // sums by warp column
  static constexpr int DQ_FLOATS =
      2 * BR * LD + 2 * T * LD + BR * LDX + 4 * BR + 2 * SCOLS * BR;
  // K, V (BR rows), Q, dO (T), P^T, dS^T, lse, D
  static constexpr int KV_FLOATS =
      2 * BR * LD + 2 * T * LD + 2 * BR * LDX + 2 * T;
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
// memory rows of LD floats by 16-byte cp.async; rows past s and columns
// hd .. HDT - 1 are zeros, so that every product runs over all HDT
// columns with no branch around an mma.  The caller commits and waits.
template <int THREADS, int LD, int HDT>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      Strides st, int b, int h, int first,
                                      int n, int s, int hd) {
  constexpr int CPR = HDT / 4;          // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < n * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const int row = first + r;
    const bool in = row < s && 4 * c < hd;
    const float* src =
        in ? base + b * st.b + (long long)row * st.s + h * st.h + 4 * c : base;
    cp_async16(smem_u32(dst + r * LD + 4 * c), src, in ? 16 : 0);
  }
}

// The three-product split into the n-tiles n0 .. n0 + NB - 1 of an
// accumulator tile: lo(A) hi(B), hi(A) lo(B), hi(A) hi(B), in that order,
// each loop issuing independent products.  No branch may surround an
// mma.sync: where the compiler cannot prove the warp converged it wraps
// each in a WARPSYNC.
template <int MM, int NB, int NN>
__device__ __forceinline__ void mma3(float (&acc)[MM][NN][4],
                                     const uint32_t (&ah)[MM][4],
                                     const uint32_t (&al)[MM][4],
                                     const uint32_t (&bh)[NB][2],
                                     const uint32_t (&bl)[NB][2], int n0) {
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      mma_tf32_1688(acc[m][n0 + n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      mma_tf32_1688(acc[m][n0 + n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
      mma_tf32_1688(acc[m][n0 + n], ah[m], bh[n][0], bh[n][1]);
}

// acc (16 MM x 8 NN) += A B^T over the staged head dim [0, HDT): A is
// 16 MM rows at a, B is 8 NN rows at bm, both staged with LD floats a row
// (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T).  Each operand
// element is split once a k-step and serves NN (A) or MM (B) products.
template <int MM, int NN, int LD, int HDT>
__device__ __forceinline__ void product_nt(float (&acc)[MM][NN][4],
                                           const float* a, const float* bm,
                                           int g, int tg) {
#pragma unroll 2
  for (int k0 = 0; k0 < HDT; k0 += 8) {
    uint32_t ah[MM][4], al[MM][4], bh[NN][2], bl[NN][2];
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      const float* row = a + (16 * m + g) * LD + k0 + tg;
      split_tf32(row[0], ah[m][0], al[m][0]);
      split_tf32(row[8 * LD], ah[m][1], al[m][1]);
      split_tf32(row[4], ah[m][2], al[m][2]);
      split_tf32(row[8 * LD + 4], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float* row = bm + (8 * n + g) * LD + k0 + tg;
      split_tf32(row[0], bh[n][0], bl[n][0]);
      split_tf32(row[4], bh[n][1], bl[n][1]);
    }
    mma3<MM, NN, NN>(acc, ah, al, bh, bl, 0);
  }
}

// acc (16 MM x 8 NN) = acc rowmul + X Y: X is 16 MM rows at x of KT
// floats (P or dS, LDX floats a row), Y is KT rows at y, 8 NN columns (a
// staged tile, LD floats a row); rowmul[m][i] scales acc's row 16 m + g +
// 8 i.  The tensor cores' float32 accumulation does not round to nearest,
// and its error grows with the products that feed one accumulator, so X Y
// goes into fresh registers, CH n-tiles at a time, and each element joins
// acc by one rounded fmaf: at most T / 8 x 3 products a tensor-core sum.  Each k-step
// of 8 takes X's columns and Y's rows in the order 0, 2, 4, 6, 1, 3, 5, 7,
// so that a thread's A pair is X's adjacent (2t, 2t + 1), as the
// accumulator that made X holds them.
template <int MM, int NN, int CH, int KT, int LDX, int LD>
__device__ __forceinline__ void product_nn(float (&acc)[MM][NN][4],
                                           const float (&rowmul)[MM][2],
                                           const float* x, const float* y,
                                           int g, int tg) {
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += CH) {
    float part[MM][CH][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < KT; k0 += 8) {
      uint32_t ah[MM][4], al[MM][4], bh[CH][2], bl[CH][2];
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        const float* row = x + (16 * m + g) * LDX + k0 + 2 * tg;
        const float2 x0 = *reinterpret_cast<const float2*>(row);
        const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * LDX);
        split_tf32(x0.x, ah[m][0], al[m][0]);
        split_tf32(x1.x, ah[m][1], al[m][1]);
        split_tf32(x0.y, ah[m][2], al[m][2]);
        split_tf32(x1.y, ah[m][3], al[m][3]);
      }
      const float* y0 = y + (k0 + 2 * tg) * LD + g + 8 * n0;
#pragma unroll
      for (int n = 0; n < CH; ++n) {
        split_tf32(y0[8 * n], bh[n][0], bl[n][0]);
        split_tf32(y0[LD + 8 * n], bh[n][1], bl[n][1]);
      }
      mma3<MM, CH, CH>(part, ah, al, bh, bl, 0);
    }
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][n0 + n][e] =
              fmaf(acc[m][n0 + n][e], rowmul[m][e / 2], part[m][n][e]);
  }
}

// A warp's accumulator tile (rows r0 + 16 m + g (+ 8), columns c0 + 8 n +
// 2 tg (+ 1)) into a P or dS tile of LDX floats a row.
template <int MM, int NN, int LDX>
__device__ __forceinline__ void store_tile(float* xs,
                                           const float (&f)[MM][NN][4],
                                           int r0, int c0, int g, int tg) {
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(xs + (r0 + 16 * m + g + 8 * i) * LDX + c0 +
                                   8 * n + 2 * tg) =
            make_float2(f[m][n][2 * i], f[m][n][2 * i + 1]);
}

// ---------------------------------------------------------------------------
// dq, lse and D: one block per (64 query rows, head, batch row)
// ---------------------------------------------------------------------------

template <int HDT>
__global__ void __launch_bounds__(Shape<HDT>::THREADS)
flash_bwd_tf32x3_dq(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ d_out,
                    const Problem p) {
  using Sh = Shape<HDT>;
  constexpr int T = Sh::T, LD = Sh::LD, LDX = Sh::LDX, W = Sh::W;
  constexpr int THREADS = Sh::THREADS, SCOLS = Sh::SCOLS;
  constexpr int MS = Sh::MS, NS = Sh::NS, MQ = Sh::MQ, NQ = Sh::NQ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BR x LD
  float* dos = qs + BR * LD;                    // BR x LD
  float* ks = dos + BR * LD;                    // T x LD
  float* vs = ks + T * LD;                      // T x LD
  float* xs = vs + T * LD;                      // BR x LDX: P~, then dS~
  float* drow = xs + BR * LDX;                  // BR: D
  float* mrow = drow + BR;                      // BR: running max
  float* lrow = mrow + BR;                      // BR: running sum
  float* arow = lrow + BR;                      // BR: this tile's rescale
  float* pmax = arow + BR;                      // SCOLS x BR: tile maxima
  float* psum = pmax + SCOLS * BR;              // SCOLS x BR: tile sums

  const int nq = (p.sq + BR - 1) / BR;
  const int q_first = (nq - 1 - (int)blockIdx.x) * BR;  // heaviest first
  const int q_last = q_first + BR - 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  // S on the first half of the warps, dP on the second (16 MS x 8 NS a
  // warp, column sc of SCOLS); dQ on every warp (16 MQ x 8 NQ)
  const int half = warp / (W / 2), wq = warp % (W / 2), sc = wq % SCOLS;
  const int rs = 16 * MS * (wq / SCOLS), cs = 8 * NS * sc;
  const int rq = 16 * MQ * (warp / Sh::QCOLS), cq = 8 * NQ * (warp % Sh::QCOLS);

  stage<THREADS, LD, HDT>(qs, q, p.q, b, h, q_first, BR, p.sq, p.hd);
  stage<THREADS, LD, HDT>(dos, dout, p.dout, b, h, q_first, BR, p.sq, p.hd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  {  // D_i = dO_i . o_i: THREADS / BR neighbouring lanes a row
    constexpr int TPR = THREADS / BR;
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
    const int row = q_first + r;
    float acc = 0.f;
    if (row < p.sq) {
      const float* orow = o + b * p.o.b + (long long)row * p.o.s + h * p.o.h;
      for (int d = part; d < p.hd; d += TPR)
        acc = fmaf(dos[r * LD + d], orow[d], acc);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (part == 0) {
      drow[r] = acc;
      mrow[r] = NEG_INF_SCORE;
      lrow[r] = 0.f;
    }
  }

  // One pass over the visible key tiles, the forward's online softmax:
  // each row's running max m and sum l in base 2; P~ = 2^(S scale log2 e -
  // m) and dS~ = P~ (dP - D) against the running max, and the dQ
  // accumulator rescaled by 2^(m_old - m_new) where a row's max grows; at
  // the end dq = scale dQ / l and lse = m + log2 l.
  const int nk = (p.sk + T - 1) / T;
  float acc[MQ][NQ][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int k_first = kt * T, k_last = k_first + T - 1;
    if (!tiles_meet(p, q_first, q_last, k_first, k_last)) continue;
    // every pair of the two tiles visible: no mask to evaluate
    const bool full = q_last < p.sq && k_last < p.sk &&
                      (!p.causal || k_last <= q_first) &&
                      (p.window <= 0 || k_first > q_last - p.window);
    __syncthreads();  // the previous tile is consumed
    stage<THREADS, LD, HDT>(ks, k, p.k, b, hk, k_first, T, p.sk, p.hd);
    stage<THREADS, LD, HDT>(vs, v, p.v, b, hk, k_first, T, p.sk, p.hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[MS][NS][4] = {};
    product_nt<MS, NS, LD, HDT>(s, (half ? dos : qs) + rs * LD,
                                (half ? vs : ks) + cs * LD, g, tg);
    if (half == 0) {  // scaled, masked scores and their row maxima
#pragma unroll
      for (int m = 0; m < MS; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rs + 16 * m + g + 8 * i;
          float mx = NEG_INF_SCORE;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int kpos = k_first + cs + 8 * n + 2 * tg + j;
              float& x = s[m][n][2 * i + j];
              x = full || visible(p, q_first + r, kpos) ? x * p.scale_log2
                                                        : NEG_INF_SCORE;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          if (tg == 0) pmax[sc * BR + r] = mx;
        }
    }
    __syncthreads();
    if (half == 0) {  // P~ against the new running max, its row sums
#pragma unroll
      for (int m = 0; m < MS; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rs + 16 * m + g + 8 * i;
          float m_new = mrow[r];
#pragma unroll
          for (int c = 0; c < SCOLS; ++c) m_new = fmaxf(m_new, pmax[c * BR + r]);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& x = s[m][n][2 * i + j];
              x = x > 0.5f * NEG_INF_SCORE ? exp2f(x - m_new) : 0.f;
              sum += x;
            }
          sum += __shfl_xor_sync(FULL, sum, 1);
          sum += __shfl_xor_sync(FULL, sum, 2);
          if (tg == 0) psum[sc * BR + r] = sum;
        }
      store_tile<MS, NS, LDX>(xs, s, rs, cs, g, tg);
    }
    __syncthreads();
    if (half == 1) {  // dS~ = P~ (dP - D), in place
#pragma unroll
      for (int m = 0; m < MS; ++m)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rs + 16 * m + g + 8 * i;
            float2* at = reinterpret_cast<float2*>(xs + r * LDX + cs + 8 * n +
                                                   2 * tg);
            const float2 pp = *at;
            const float d = drow[r];
            *at = make_float2(pp.x * (s[m][n][2 * i] - d),
                              pp.y * (s[m][n][2 * i + 1] - d));
          }
    } else if (threadIdx.x < BR) {  // each row's max, sum and rescale
      const int r = threadIdx.x;
      const float m_old = mrow[r];
      float m_new = m_old, sum = 0.f;
#pragma unroll
      for (int c = 0; c < SCOLS; ++c) {
        m_new = fmaxf(m_new, pmax[c * BR + r]);
        sum += psum[c * BR + r];
      }
      const float alpha = exp2f(m_old - m_new);
      lrow[r] = lrow[r] * alpha + sum;
      mrow[r] = m_new;
      arow[r] = alpha;
    }
    __syncthreads();
    float alpha[MQ][2];  // dQ = dQ 2^(m_old - m_new) + dS~ K
#pragma unroll
    for (int m = 0; m < MQ; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) alpha[m][i] = arow[rq + 16 * m + g + 8 * i];
    product_nn<MQ, NQ, Sh::CQ, T, LDX, LD>(acc, alpha, xs + rq * LDX,
                                           ks + cq, g, tg);
  }
  __syncthreads();

  if (threadIdx.x < BR) {
    const int r = threadIdx.x, row = q_first + r;
    const float l = lrow[r];
    if (row < p.sq) {
      const long long at = ((long long)b * p.h + h) * p.sq + row;
      lse_out[at] = l > 0.f ? mrow[r] + log2f(l) : NO_LSE;
      d_out[at] = drow[r];
    }
  }
#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rq + 16 * m + g + 8 * i, row = q_first + r;
      const float l = lrow[r];
      const float mul = l > 0.f ? p.scale / l : 0.f;  // no visible key: 0
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = cq + 8 * n + 2 * tg;
        if (col >= p.hd || row >= p.sq) continue;
        *reinterpret_cast<float2*>(
            dq + (((long long)b * p.sq + row) * p.h + h) * p.hd + col) =
            make_float2(acc[m][n][2 * i] * mul, acc[m][n][2 * i + 1] * mul);
      }
    }
}

// ---------------------------------------------------------------------------
// dk and dv: one block per (64 keys, kv head, batch row, part of the heads)
// ---------------------------------------------------------------------------

template <int HDT>
__global__ void __launch_bounds__(Shape<HDT>::THREADS)
flash_bwd_tf32x3_dkdv(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse_in,
                      const float* __restrict__ d_in, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ ws,
                      const Problem p) {
  using Sh = Shape<HDT>;
  constexpr int T = Sh::T, LD = Sh::LD, LDX = Sh::LDX, W = Sh::W;
  constexpr int THREADS = Sh::THREADS, MS = Sh::MS, NS = Sh::NS;
  constexpr int MK = Sh::MK, NK = Sh::NK;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // BR x LD
  float* vs = ks + BR * LD;                     // BR x LD
  float* qs = vs + BR * LD;                     // T x LD
  float* dos = qs + T * LD;                     // T x LD
  float* ps = dos + T * LD;                     // BR x LDX: P^T
  float* xs = ps + BR * LDX;                    // BR x LDX: dS^T
  float* lses = xs + BR * LDX;                  // T
  float* dsums = lses + T;                      // T

  const int k_first = blockIdx.x * BR, k_last = k_first + BR - 1;
  const int hk = blockIdx.y / p.parts, part = blockIdx.y % p.parts;
  const int b = blockIdx.z;
  const int qpk = p.h / p.hkv;
  const int h_lo = hk * qpk + part * qpk / p.parts;
  const int h_hi = hk * qpk + (part + 1) * qpk / p.parts;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  // S^T on the first half of the warps, dP^T on the second (16 MS keys x
  // 8 NS queries a warp); dV on the first half, dK on the second (16 MK
  // keys x 8 NK columns a warp)
  const int half = warp / (W / 2), wq = warp % (W / 2);
  const int rs = 16 * MS * (wq / Sh::SCOLS), cs = 8 * NS * (wq % Sh::SCOLS);
  const int rk = 16 * MK * (wq / Sh::KCOLS), ck = 8 * NK * (wq % Sh::KCOLS);

  stage<THREADS, LD, HDT>(ks, k, p.k, b, hk, k_first, BR, p.sk, p.hd);
  stage<THREADS, LD, HDT>(vs, v, p.v, b, hk, k_first, BR, p.sk, p.hd);
  cp_async_commit();

  float acc[MK][NK][4] = {};  // dV (first half) or dK (second)
  float ones[MK][2];
#pragma unroll
  for (int m = 0; m < MK; ++m) ones[m][0] = ones[m][1] = 1.f;
  const int nq = (p.sq + T - 1) / T;
  for (int h = h_lo; h < h_hi; ++h) {
    for (int qt = 0; qt < nq; ++qt) {
      const int q_first = qt * T, q_last = q_first + T - 1;
      if (!tiles_meet(p, q_first, q_last, k_first, k_last)) continue;
      // every pair of the two tiles visible: no mask to evaluate
      const bool full = q_last < p.sq && k_last < p.sk &&
                        (!p.causal || k_last <= q_first) &&
                        (p.window <= 0 || k_first > q_last - p.window);
      __syncthreads();  // the previous tile is consumed
      stage<THREADS, LD, HDT>(qs, q, p.q, b, h, q_first, T, p.sq, p.hd);
      stage<THREADS, LD, HDT>(dos, dout, p.dout, b, h, q_first, T, p.sq,
                              p.hd);
      cp_async_commit();
      for (int r = threadIdx.x; r < T; r += THREADS) {
        const int row = q_first + r;
        const long long at = ((long long)b * p.h + h) * p.sq + row;
        lses[r] = row < p.sq ? lse_in[at] : NO_LSE;
        dsums[r] = row < p.sq ? d_in[at] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float s[MS][NS][4] = {};
      product_nt<MS, NS, LD, HDT>(s, (half ? vs : ks) + rs * LD,
                                  (half ? dos : qs) + cs * LD, g, tg);
      if (half == 0) {
#pragma unroll
        for (int m = 0; m < MS; ++m)
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int qr = cs + 8 * n + 2 * tg + j;
                const int kpos = k_first + rs + 16 * m + g + 8 * i;
                float& x = s[m][n][2 * i + j];
                x = full || visible(p, q_first + qr, kpos)
                        ? exp2f(x * p.scale_log2 - lses[qr])
                        : 0.f;
              }
        store_tile<MS, NS, LDX>(ps, s, rs, cs, g, tg);
      }
      __syncthreads();
      if (half == 1) {
#pragma unroll
        for (int m = 0; m < MS; ++m)
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = rs + 16 * m + g + 8 * i;
              const int qr = cs + 8 * n + 2 * tg;
              const float2 pp =
                  *reinterpret_cast<const float2*>(ps + r * LDX + qr);
              *reinterpret_cast<float2*>(xs + r * LDX + qr) =
                  make_float2(pp.x * (s[m][n][2 * i] - dsums[qr]),
                              pp.y * (s[m][n][2 * i + 1] - dsums[qr + 1]));
            }
        // the second half's warps only: dS^T is theirs alone
        asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS / 2) : "memory");
      }
      product_nn<MK, NK, Sh::CK, T, LDX, LD>(acc, ones,
                                             (half ? xs : ps) + rk * LDX,
                                             (half ? qs : dos) + ck, g, tg);
    }
  }
  cp_async_wait<0>();  // K and V, where no query tile was visible

  const long long n_out = (long long)gridDim.z * p.sk * p.hkv * p.hd;
  // dV from the first half, dK (times scale, or this part's sum) from the
  // second
  float* out = p.parts == 1 ? (half ? dk : dv)
                            : ws + ((half ? 0 : p.parts) + part) * n_out;
  const float mul = p.parts == 1 && half ? p.scale : 1.f;
#pragma unroll
  for (int m = 0; m < MK; ++m)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int col = ck + 8 * n + 2 * tg;
      if (col >= p.hd) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k_first + rk + 16 * m + g + 8 * i;
        if (key >= p.sk) continue;
        const long long at =
            (((long long)b * p.sk + key) * p.hkv + hk) * p.hd + col;
        *reinterpret_cast<float2*>(out + at) =
            make_float2(acc[m][n][2 * i] * mul, acc[m][n][2 * i + 1] * mul);
      }
    }
}

// dk = scale sum_p dK_p and dv = sum_p dV_p over the parts in order.
__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_tf32x3_reduce(const float* __restrict__ ws, float* __restrict__ dk,
                        float* __restrict__ dv, long long n, int parts,
                        float scale) {
  for (long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
       i < n; i += (long long)gridDim.x * REDUCE_THREADS) {
    float a = 0.f, c = 0.f;
    for (int pp = 0; pp < parts; ++pp) {
      a += ws[pp * n + i];
      c += ws[(parts + pp) * n + i];
    }
    dk[i] = a * scale;
    dv[i] = c;
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <int HDT>
static int launch(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, float* dq, float* dk,
                  float* dv, float* lse, float* dsum, float* ws, int bsz,
                  const Problem& p, cudaStream_t st) {
  using Sh = Shape<HDT>;
  const size_t smem_dq = sizeof(float) * (size_t)Sh::DQ_FLOATS;
  const size_t smem_kv = sizeof(float) * (size_t)Sh::KV_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tf32x3_dq<HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_tf32x3_dkdv<HDT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  if (p.sq > 0) {
    dim3 grid((p.sq + BR - 1) / BR, p.h, bsz);
    flash_bwd_tf32x3_dq<HDT><<<grid, Sh::THREADS, smem_dq, st>>>(
        q, k, v, o, dout, dq, lse, dsum, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (p.sk > 0) {
    dim3 grid((p.sk + BR - 1) / BR, p.hkv * p.parts, bsz);
    flash_bwd_tf32x3_dkdv<HDT><<<grid, Sh::THREADS, smem_kv, st>>>(
        q, k, v, dout, lse, dsum, dk, dv, ws, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (p.parts > 1) {
      const long long n = (long long)bsz * p.sk * p.hkv * p.hd;
      const long long blocks = (n + REDUCE_THREADS - 1) / REDUCE_THREADS;
      flash_bwd_tf32x3_reduce<<<(unsigned)(blocks < 65535 ? blocks : 65535),
                                REDUCE_THREADS, 0, st>>>(ws, dk, dv, n,
                                                         p.parts, p.scale);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}

static bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

// q, o, dout (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) float32 through their
// element strides (innermost stride 1, the others multiples of 4, every
// base 16-byte aligned: the wrapper copies a tensor that is not); dq (B, Sq,
// H, hd), dk and dv (B, Sk, Hkv, hd) contiguous, written whole; lse and
// dsum float32 (B, H, Sq) scratch; ws 2 parts B Sk Hkv hd floats where
// parts > 1 (else unused).  Returns 0 or a cudaError_t.  The caller handles
// B == 0; at Sk == 0 the first kernel writes dq = 0, at Sq == 0 the second
// writes dk = dv = 0.
extern "C" int flash_attention_bwd_tf32x3_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    void* ws, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long dsb, long long dss,
    long long dsh, int bsz, int h, int hkv, int sq, int sk, int hd,
    int causal, int window, int parts, double scale, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      bsz <= 0 || bsz > 65535 || h > 65535 || sq < 0 || sk < 0 ||
      parts < 1 || parts > h / hkv || (long long)hkv * parts > 65535 ||
      (parts > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long strides[] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                               vsh, osb, oss, osh, dsb, dss, dsh};
  for (long long s : strides)
    if (s % 4 != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout))
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
  p.parts = parts;
  p.scale = (float)scale;
  p.scale_log2 = (float)(scale * 1.4426950408889634);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fo = (const float*)o,
              *fd = (const float*)dout;
  float *gq = (float*)dq, *gk = (float*)dk, *gv = (float*)dv,
        *fl = (float*)lse, *fs = (float*)dsum, *fw = (float*)ws;
  if (hd <= 64)
    return launch<64>(fq, fk, fv, fo, fd, gq, gk, gv, fl, fs, fw, bsz, p, st);
  if (hd <= 128)
    return launch<128>(fq, fk, fv, fo, fd, gq, gk, gv, fl, fs, fw, bsz, p,
                       st);
  return launch<256>(fq, fk, fv, fo, fd, gq, gk, gv, fl, fs, fw, bsz, p, st);
}

// BR, the keys of a dk/dv block, for the wrapper's head-split rule.
extern "C" int flash_attention_bwd_tf32x3_rows() { return BR; }
