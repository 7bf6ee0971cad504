// The gradient of blockwise (flash) attention in bfloat16 on Hopper's tensor
// cores (sm_90a): every product on wgmma, every operand tile by TMA.
//
// What it replaces.  The JAX package has no backward Pallas kernel: its
// models call the jnp attention (src/repro/models/attention.py:40) and
// jax.grad differentiates that.  This kernel computes that gradient for the
// function that the forward kernel of src/repro/kernels/flash_attention.py
// (_kernel, wrapper flash_attention_flat :91) computes, the same function
// as flash_attention_bwd.cu and repro_torch.kernels.ref.
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
// bf16 tensors, head dim a multiple of 8 up to 256; sums in float32, p and
// ds rounded to bf16 as the operands of the three accumulating products
// (the forward rounds p the same way for P V), outputs in bf16.  A row with
// no visible key gets dq = 0; a key no query sees gets dk = dv = 0.
//
// Bound on the H100: operations.  10 hd FLOPs per visible (query, key) pair
// and query head (the five products above): at qwen3_4b's train shape (B=4,
// S=1,024, 32/8 heads, hd 128, causal) and at recurrentgemma's (B=4,
// S=1,024, 16/1 heads, hd 256, causal) 8.6e10 FLOPs each, 0.087 ms at the
// 989 TFLOP/s bf16 peak, against 50 MB (hd 128) or 67 MB (hd 256) of q, k,
// v, o, dO, dq, dk, dv (0.015 / 0.020 ms at 3.35 TB/s).  This design does
// S and dP in both kernels and S once more for the log-sum-exp: 16 hd
// FLOPs a pair, a floor of about 0.139 ms.
//
// Design: two kernels, deterministic, no atomics (every output element is
// written by one block, and partial sums are added in a fixed order, so two
// calls give the same bits).  Each is warp-specialised as the forward
// (flash_attention_sm90.cu): one block of three warpgroups, a producer
// warpgroup (24 registers a thread after setmaxnreg) whose one thread
// issues TMA loads through rank-4 tensor maps of the strided (B, S, H, hd)
// tensors into a ring of STAGES stages on full and empty mbarriers, and two
// consumer warpgroups (240 registers).  The head dim is zero-padded by TMA
// to HDP = 64, 128 or 256, so every tile is made of 64-column regions of
// 128-byte rows under the 128-byte swizzle, and the wgmma descriptors are
// the forward's: a tile is K-major as the A or B operand of a product over
// the head dim, and MN-major as the B operand of a product over its rows.
// Two shapes of a block (Var<HDP>):
// - HDP <= 128: each consumer owns its own 64 rows and all HDP columns of
//   the output (128 rows a block), three stages;
// - HDP = 256: a float32 64 x 256 accumulator for each of dK and dV would
//   take 256 registers a thread, past the 255 a thread may hold, and a
//   block of 128 rows with two stages would need 256 KB of shared memory.
//   So a block owns 64 rows, its two consumers split the output's columns
//   (128 each: dQ 64, or dK 64 + dV 64 accumulator registers a thread, the
//   HDP = 128 budget), and the ring has two stages (Q and dO, or K and V,
//   64 KB a stage).  Both consumers need all of S and dP (S^T and dP^T),
//   which contract over all 256 columns: consumer 0 computes S, consumer 1
//   dP, each whole, and they exchange the float32 accumulators through
//   32 KB of shared memory between two named barriers (Var::XCH; 226.5
//   KB of the 227 a block may have).  Pass 1's key tiles alternate
//   between them (even tiles to consumer 0, odd to 1: Var::LSPLIT), and
//   each row's two running maxima and sums are combined,
//   m = max(m0, m1), l = l0 2^(m0 - m) + l1 2^(m1 - m).  On the H100 at
//   recurrentgemma's train shape this took 0.466-0.470 ms device against
//   0.536 for both consumers computing both (26 hd FLOPs a pair): the
//   split saved 0.041 ms of the dq kernel, the exchange 0.022 of the
//   dk/dv kernel; overlapping dQ with the next S and dP at two stages was
//   slower (0.551).  PERF.md keeps that comparison; only the faster
//   design is built.
// - flash_bwd_sm90_q: one block per (BM query rows, head, batch row), the
//   heaviest causal tiles first.  The producer loads the block's Q and dO
//   tiles once, then the block's key tiles twice: K alone (pass 1), then
//   K and V (pass 2).  Each consumer computes D_i from o and dO in device
//   memory; pass 1: S = Q K^T (m64n64k16, both operands K-major) and the
//   forward's online max and sum on the accumulator, hence lse_i (base 2,
//   of the scores times scale log2 e); pass 2, per key tile: S and
//   dP = dO V^T (m64n64k16_ss), P = 2^(S scale log2 e - lse) and
//   dS = P (dP - D) on the accumulator fragments, then dQ += dS K (its
//   columns, m64n{HDP or 128}k16 with dS, cast to bf16, as the register A
//   operand: the accumulator fragment of a product is the A fragment of
//   the next; K MN-major, the layout V takes in the forward's P V).  With
//   three stages the dQ product of tile i - 1 runs while the S and dP
//   products of tile i are waited for and while dS of tile i is formed
//   (the forward's overlap); with two (HDP = 256) that would leave no load
//   in flight, so each tile's products are waited for in turn, as the
//   forward does there.  Pass 1 waits for each S (S and dP taking turns as
//   two buffers was slower on the H100: the branch around the second issue
//   serialised the wgmma).  It writes dq * scale, lse and D (float32
//   (B, H, Sq_pad) scratch, Sq_pad a multiple of ROWS; rows past Sq
//   included, lse = NO_LSE there).
// - flash_bwd_sm90_kv: one block per (BM key rows, kv head, batch row,
//   part of the group's query heads), the heaviest causal tiles (the first
//   keys) first.  K and V of the block's keys stay in shared memory.  The
//   producer walks the part's query heads and their visible query tiles
//   and brings Q, dO, and the tile's lse and D (a bulk copy each).  Per
//   tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16_ss); keys are the M
//   rows, so the fragments of P^T and dS^T = P^T (dP^T - D) are the A
//   fragments of dV += P^T dO and dK += dS^T Q (their columns,
//   m64n{HDP or 128}k16_rs, dO and Q MN-major).  Registers: dK 64 + dV 64
//   + S 32 + dP 32 a thread, near the 240 of a consumer, so P^T and dS^T
//   are formed and packed to bf16 one column pair at a time, with that
//   pair's lse and D read from shared memory just before (read all at
//   once, the 32 values pushed a consumer past 240 registers: 948 bytes of
//   spills and serialised wgmma), and a warpgroup waits for its own
//   products (the two consumer warpgroups overlap each other).
// - The head split (HDP = 256 only): a (64 keys, kv head, batch row) block
//   walks every query head of its group, and MQA leaves few of them (16/1
//   heads, B = 4, Sk = 1,024: 64 blocks on 132 SMs).  So the group's H /
//   Hkv heads are split into G parts, each a block of its own (part p:
//   heads p qpk / G .. (p + 1) qpk / G - 1 of the group, so uneven groups
//   work); the part index is the fastest grid coordinate beside the kv
//   head, so the heaviest key tiles of every part still start first.  At
//   G > 1 each part writes its unscaled float32 dK and dV to a per-call
//   workspace, and flash_bwd_sm90_reduce sums the parts in order 0 .. G - 1
//   and writes dk = sum * scale and dv = sum in bf16.  The wrapper picks G
//   (flash_attention.bwd_head_parts): G = 1 up to hd 128 (those grids
//   already hold 128 keys a block and are left as they were) and where Sk
//   is 0; else with base = Hkv B ceil(Sk / 64) blocks, G = round(2 SMs /
//   base) clamped to 1 .. H / Hkv, about two blocks an SM, since under the
//   causal mask the first key tiles carry the most work.  At the train
//   shape G = 4 (256 blocks; 33.6 MB of workspace, read once): 0.472 ms
//   device against 0.893 at G = 1, 0.597 at 2, 0.528 at 3, 0.487 at 6,
//   0.498 at 8 and 0.560 at 16 (the reduction 0.011 at 4, 0.052 at 16).
// Only tiles that cross the band's edge, Sq or Sk are masked, with the
// forward's predicate (visible()); tiles wholly outside the band are never
// loaded.  The masked-row trap: a row with no visible key gets lse = NO_LSE
// (1e30), so 2^(s - lse) = 0, and P is zeroed wherever visible() is false.
// An mbarrier wait traps after SPIN_LIMIT polls, so a fault in the ring is
// a CUDA error and not a hang.
//
// Not yet here: lse from the forward (one S product less a pair), dq by
// float32 atomics from the dk/dv kernel (one kernel, S and dP once), a
// persistent grid, the overlap of a warpgroup's own products in
// flash_bwd_sm90_kv.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define NC 2                       // consumer warpgroups per block
#define THREADS (128 * (NC + 1))   // + one producer warpgroup
#define BT 64                      // rows of a tile (queries or keys)
#define WIDE_HD 128  // above this padded head dim the consumers split columns
#define ROWS 128     // the lse and D scratch's unit: a multiple of every BM
#define REGION (64 * 128)  // bytes of one 64-row x 64-column swizzled region
#define NEG_INF_SCORE (-1e30f)
#define NO_LSE (1e30f)  // lse of a row with no visible key: 2^(x - NO_LSE) = 0
#define FULL_MASK 0xffffffffu
#define SPIN_LIMIT (1u << 28)  // polls of an mbarrier before a wait traps
#define REDUCE_THREADS 256

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, s, h;  // elements; the head-dim stride is 1
};

struct Problem {
  int h, hkv, sq, sq_pad, sk, hd, causal, window;
  float scale, scale_log2;
};

// The shape of a block at padded head dim HDP.
template <int HDP>
struct Var {
  static constexpr int NR = HDP / 64;              // 64-column regions
  static constexpr int TILE = NR * REGION;         // one 64-row tile
  static constexpr int CS = HDP > WIDE_HD ? 2 : 1; // consumers on one tile
  static constexpr int NT = NC / CS;               // a block's own tiles
  static constexpr int BM = BT * NT;               // a block's own rows
  static constexpr int NCOL = HDP / CS;            // a consumer's columns
  static constexpr int STAGES = CS == 1 ? 3 : 2;   // what 227 KB holds
  // the two consumers of a tile exchange S and dP, and split pass 1
  static constexpr bool XCH = CS == 2;
  static constexpr bool LSPLIT = CS == 2;
  // dQ of tile i - 1 overlaps S and dP of tile i (needs a third stage)
  static constexpr bool OVERLAP = STAGES >= 3;
  // an exchanged 64 x 64 float32 accumulator per consumer
  static constexpr int XBYTES = XCH ? NC * BT * BT * 4 : 0;
  static_assert(ROWS % BM == 0, "the scratch unit covers whole blocks");
};

// flash_bwd_sm90_q: NT Q and NT dO tiles, STAGES K and V tiles,
// 2 STAGES + 1 mbarriers, NC x 64 floats of D, [the exchange], [NC x 2 x
// 64 floats of pass 1's maxima and sums]
template <int HDP>
struct LayoutQ {
  using V = Var<HDP>;
  static constexpr int BARS = V::TILE * (2 * V::NT + 2 * V::STAGES);
  static constexpr int DROWS = BARS + 8 * (2 * V::STAGES + 1);
  static constexpr int XCHG = DROWS + 4 * BT * NC;
  static constexpr int ML = XCHG + V::XBYTES;
  static constexpr int BYTES = ML + (V::LSPLIT ? 8 * BT * NC : 0) + 1024;
};

// flash_bwd_sm90_kv: NT K and NT V tiles, STAGES Q and dO tiles,
// STAGES x 64 floats of lse and of D, 2 STAGES + 1 mbarriers
template <int HDP>
struct LayoutKV {
  using V = Var<HDP>;
  static constexpr int VECS = V::TILE * (2 * V::NT + 2 * V::STAGES);
  static constexpr int BARS = VECS + 2 * V::STAGES * 4 * BT;
  static constexpr int XCHG = BARS + 8 * (2 * V::STAGES + 1);
  static constexpr int BYTES = XCHG + V::XBYTES + 1024;
};

// 2^x on the special-function unit (flush-to-zero; 2^(-1e30) is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Waits until the barrier's phase with the given parity has completed;
// traps (a CUDA error, not a hang) after SPIN_LIMIT polls.  One asm block,
// so that the compiler sees no divergent branch around the wgmma products.
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

// A barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A barrier over the two consumer warpgroups (ids 1 + NC ..).
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * NC) : "memory");
}

// The exchange (Var::XCH): this consumer's 64 x 64 accumulator `mine`
// (S or S^T at cp = 0, dP or dP^T at cp = 1) goes to its slot of x, the
// other's comes back, and s and dp end up holding S and dP.  `turn` > 0
// first waits until the other consumer has read the slot's previous
// contents.
__device__ __forceinline__ void exchange(float* x, int cp, int turn,
                                         float (&s)[BT / 2],
                                         float (&dp)[BT / 2]) {
  const int t = threadIdx.x % 128;
  if (turn > 0) consumers_sync(2 + NC);
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) x[(cp * (BT / 2) + i) * 128 + t] = s[i];
  consumers_sync(1 + NC);
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    const float other = x[((1 - cp) * (BT / 2) + i) * 128 + t];
    const float mine = s[i];
    s[i] = cp ? other : mine;
    dp[i] = cp ? mine : other;
  }
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completed on an mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The forward's mask: key kpos visible to query qpos.
__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  bool ok = qpos < p.sq && kpos < p.sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Whether the 64 x 64 tile of queries q0.. and keys k0.. holds a pair that
// is not visible (uniform across a warpgroup).
__device__ __forceinline__ bool tile_masked(const Problem& p, int q0, int k0) {
  return q0 + BT > p.sq || k0 + BT > p.sk ||
         (p.causal && k0 + BT - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + BT - 1 - p.window);
}

// Key tiles [begin, end) that query rows first .. last may see.
__device__ __forceinline__ void key_band(const Problem& p, int first,
                                         int last, int& begin, int& end) {
  begin = 0;
  end = (p.sk + BT - 1) / BT;
  if (p.causal) end = min(end, (last + BT) / BT);
  if (p.window > 0) begin = max(0, first - p.window + 1) / BT;
  if (last < first || end < begin) end = begin;  // no rows
}

// Query tiles [begin, end) that may see keys first .. last.
__device__ __forceinline__ void query_band(const Problem& p, int first,
                                           int last, int& begin, int& end) {
  begin = p.causal ? first / BT : 0;
  end = (p.sq + BT - 1) / BT;
  if (p.window > 0) end = min(end, (last + p.window - 1) / BT + 1);
  if (last < first || end < begin) end = begin;  // no keys
}

// D (64 x 64) = A (64 x HDP) B^T, both tiles K-major in shared memory.
template <int HDP>
__device__ __forceinline__ void product_ss(float (&d)[BT / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * REGION + (kk & 3) * 32;
    wgmma_m64n64k16_ss(d, wgmma_desc(a + off, 16, 1024),
                       wgmma_desc(b + off, 16, 1024), kk > 0);
  }
}

// D (64 x N) += A (64 x 64, register fragments) B, B the N columns from
// shared address b of a 64-row tile read MN-major.
template <int N>
__device__ __forceinline__ void product_rs(float (&d)[N / 2],
                                           const uint32_t (&a)[BT / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_rs<N>(d, a[kk], wgmma_desc(b + kk * 16 * 128, REGION, 1024));
}

// An accumulator fragment (64 x 64 fp32) as the bf16 A fragments of a
// product over its columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[BT / 16][4],
                                       const float (&x)[BT / 2]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// A 64 x N fp32 accumulator times mul into rows first + (fragment row),
// columns c0 + (fragment column), of a (B, S, H, hd) bf16 tensor at
// (b, head): rows below s, columns below hd.
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, Strides st, int first,
                                           int s, int c0, int hd, float mul,
                                           const float (&acc)[N / 2]) {
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int r_a = first + warp * 16 + (lane >> 2), r_b = r_a + 8;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + 8 * j + c2;
    if (col < hd) {
      if (r_a < s)
        *reinterpret_cast<__nv_bfloat162*>(base + r_a * st.s + col) =
            __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (r_b < s)
        *reinterpret_cast<__nv_bfloat162*>(base + r_b * st.s + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * mul,
                                  acc[4 * j + 3] * mul);
    }
  }
}

// The same accumulator, unscaled, into a float32 partial: rows of `pitch`
// floats from base.
template <int N>
__device__ __forceinline__ void store_part(float* base, long long pitch,
                                           int first, int s, int c0, int hd,
                                           const float (&acc)[N / 2]) {
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int r_a = first + warp * 16 + (lane >> 2), r_b = r_a + 8;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + 8 * j + c2;
    if (col < hd) {
      if (r_a < s)
        *reinterpret_cast<float2*>(base + r_a * pitch + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r_b < s)
        *reinterpret_cast<float2*>(base + r_b * pitch + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq, lse and D: one block per (BM query rows, head, batch row)
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_sm90_q(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const bf16* __restrict__ o, Strides os,
                 const bf16* __restrict__ dout, Strides dos,
                 bf16* __restrict__ dq, Strides dqs,
                 float* __restrict__ lse_out, float* __restrict__ d_out,
                 const Problem p) {
  using V = Var<HDP>;
  using L = LayoutQ<HDP>;
  constexpr int TILE = V::TILE, NR = V::NR, NT = V::NT, BM = V::BM;
  constexpr int CS = V::CS, NCOL = V::NCOL, STAGES = V::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                  // NT tiles
  const uint32_t sDO = sQ + NT * TILE;       // NT tiles
  const uint32_t sK = sDO + NT * TILE;       // STAGES tiles
  const uint32_t sV = sK + STAGES * TILE;    // STAGES tiles
  const uint32_t full = base + L::BARS;      // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;  // STAGES mbarriers
  const uint32_t qbar = empty + 8 * STAGES;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* sD = reinterpret_cast<float*>(gbase + L::DROWS);
  float* sX = reinterpret_cast<float*>(gbase + L::XCHG);
  float* sML = reinterpret_cast<float*>(gbase + L::ML);

  const int head = blockIdx.x, b = blockIdx.y;
  const int blk_first = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = head / (p.h / p.hkv);
  int kt_begin, kt_end;
  key_band(p, blk_first, min(blk_first + BM, p.sq) - 1, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128 * NC);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: Q and dO once, then K (pass 1) and K + V (pass 2) per tile
    setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(qbar, 2 * NT * TILE);
      for (int c = 0; c < NT; ++c)
        for (int r = 0; r < NR; ++r) {
          tma_load4(sQ + c * TILE + r * REGION, &qmap, qbar, 64 * r, head,
                    blk_first + BT * c, b);
          tma_load4(sDO + c * TILE + r * REGION, &domap, qbar, 64 * r, head,
                    blk_first + BT * c, b);
        }
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int st = it % STAGES;
        const bool pass2 = it >= n_tiles;
        const int k0 = (kt_begin + (pass2 ? it - n_tiles : it)) * BT;
        bar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, (pass2 ? 2 : 1) * TILE);
        for (int r = 0; r < NR; ++r) {
          tma_load4(sK + st * TILE + r * REGION, &kmap, full + 8 * st,
                    64 * r, kvh, k0, b);
          if (pass2)
            tma_load4(sV + st * TILE + r * REGION, &vmap, full + 8 * st,
                      64 * r, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows my_first .. my_first + 63 of tile
  // wg / CS, dQ columns c0 .. c0 + NCOL - 1
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int my_first = blk_first + BT * (wg / CS);
  const int cp = wg % CS, c0 = cp * NCOL;
  const bool writes_rows = cp == 0;  // lse and D: one consumer a tile
  int my_begin, my_end;
  key_band(p, my_first, min(my_first + BT, p.sq) - 1, my_begin, my_end);
  const uint32_t myQ = sQ + (wg / CS) * TILE, myDO = sDO + (wg / CS) * TILE;
  const int r_a = my_first + warp * 16 + (lane >> 2);  // fragment rows
  const int r_b = r_a + 8;                             // r_a, r_b
  const int c2 = (lane & 3) * 2;                       // columns c2, c2+1
  const long long row0 = ((long long)b * p.h + head) * p.sq_pad;

  // D_i = dO_i . o_i from device memory: two threads a row, 16 bytes a load
  {
    const int row = t >> 1, qpos = my_first + row;
    float acc = 0.f;
    if (qpos < p.sq) {
      const bf16* orow = o + b * os.b + (long long)qpos * os.s + head * os.h;
      const bf16* drow =
          dout + b * dos.b + (long long)qpos * dos.s + head * dos.h;
      for (int c = (t & 1) * 8; c < p.hd; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(o2[e]);
          const float2 y = __bfloat1622float2(d2[e]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(FULL_MASK, acc, 1);
    if ((t & 1) == 0) {
      sD[BT * wg + row] = acc;
      if (writes_rows) d_out[row0 + qpos] = acc;
    }
    warpgroup_sync(1 + wg);
  }
  const float d_a = sD[BT * wg + warp * 16 + (lane >> 2)];
  const float d_b = sD[BT * wg + warp * 16 + (lane >> 2) + 8];

  float s[BT / 2], dp[BT / 2];
  bar_wait(qbar, 0);

  // pass 1: each row's lse (base 2) by the forward's online max and sum
  float m_a = NEG_INF_SCORE, m_b = NEG_INF_SCORE, l_a = 0.f, l_b = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES, kt = kt_begin + i;
    bar_wait(full + 8 * st, (i / STAGES) & 1);
    if (kt >= my_begin && kt < my_end && (!V::LSPLIT || kt % CS == cp)) {
      fence_regs(s);
      wgmma_fence();
      product_ss<HDP>(s, myQ, sK + st * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const int k0 = kt * BT;
      const bool masked = tile_masked(p, my_first, k0);
      float mx_a = NEG_INF_SCORE, mx_b = NEG_INF_SCORE;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xa = s[4 * j + e] * p.scale_log2;
          float xb = s[4 * j + 2 + e] * p.scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + c2 + e;
            if (!visible(p, r_a, key)) xa = NEG_INF_SCORE;
            if (!visible(p, r_b, key)) xb = NEG_INF_SCORE;
          }
          s[4 * j + e] = xa;
          s[4 * j + 2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xa = s[4 * j + e], xb = s[4 * j + 2 + e];
          float pa = fast_exp2(xa - mn_a), pb = fast_exp2(xb - mn_b);
          if (masked) {
            if (xa == NEG_INF_SCORE) pa = 0.f;
            if (xb == NEG_INF_SCORE) pb = 0.f;
          }
          sum_a += pa;
          sum_b += pb;
        }
      }
      l_a = l_a * fast_exp2(m_a - mn_a) + sum_a;
      l_b = l_b * fast_exp2(m_b - mn_b) + sum_b;
      m_a = mn_a;
      m_b = mn_b;
    }
    mbar_arrive(empty + 8 * st);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(FULL_MASK, l_a, off);
    l_b += __shfl_xor_sync(FULL_MASK, l_b, off);
  }
  if constexpr (V::LSPLIT) {
    // the two consumers' maxima and sums (even and odd key tiles), in
    // consumer order: m = max(m0, m1), l = l0 2^(m0 - m) + l1 2^(m1 - m)
    const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
    if ((lane & 3) == 0) {
      sML[(2 * cp) * BT + ra] = m_a;
      sML[(2 * cp) * BT + rb] = m_b;
      sML[(2 * cp + 1) * BT + ra] = l_a;
      sML[(2 * cp + 1) * BT + rb] = l_b;
    }
    consumers_sync(1 + NC);
    const float m0a = sML[ra], m1a = sML[2 * BT + ra];
    const float m0b = sML[rb], m1b = sML[2 * BT + rb];
    const float ma = fmaxf(m0a, m1a), mb = fmaxf(m0b, m1b);
    l_a = sML[BT + ra] * fast_exp2(m0a - ma) +
          sML[3 * BT + ra] * fast_exp2(m1a - ma);
    l_b = sML[BT + rb] * fast_exp2(m0b - mb) +
          sML[3 * BT + rb] * fast_exp2(m1b - mb);
    m_a = ma;
    m_b = mb;
  }
  const float lse_a = l_a > 0.f ? m_a + log2f(l_a) : NO_LSE;
  const float lse_b = l_b > 0.f ? m_b + log2f(l_b) : NO_LSE;
  if (writes_rows && (lane & 3) == 0) {
    lse_out[row0 + r_a] = lse_a;
    lse_out[row0 + r_b] = lse_b;
  }

  // pass 2: dq_i = sum_j p_ij (dp_ij - D_i) k_j
  float acc[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) acc[i] = 0.f;
  uint32_t dsf[BT / 16][4];
  // S and dP of the tile in stage st: one wgmma group (XCH: S or dP
  // alone into s, by the consumer's column part)
  auto issue_sdp = [&](int st) {
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (V::XCH) {
      product_ss<HDP>(s, cp ? myDO : myQ, (cp ? sV : sK) + st * TILE);
    } else {
      product_ss<HDP>(s, myQ, sK + st * TILE);
      product_ss<HDP>(dp, myDO, sV + st * TILE);
    }
    wgmma_commit();
  };
  // dQ (this consumer's columns) += dS K from dsf: one wgmma group
  auto issue_dq = [&](int st) {
    fence_regs(acc);
    wgmma_fence();
    product_rs<NCOL>(acc, dsf, sK + st * TILE + (c0 / 64) * REGION);
    wgmma_commit();
  };
  // P and dS of key tile kt on the accumulators: dp becomes dS
  auto grad = [&](int kt) {
    const int k0 = kt * BT;
    const bool masked = tile_masked(p, my_first, k0);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = fast_exp2(s[4 * j + e] * p.scale_log2 - lse_a);
        float pb = fast_exp2(s[4 * j + 2 + e] * p.scale_log2 - lse_b);
        if (masked) {
          const int key = k0 + 8 * j + c2 + e;
          if (!visible(p, r_a, key)) pa = 0.f;
          if (!visible(p, r_b, key)) pb = 0.f;
        }
        dp[4 * j + e] = pa * (dp[4 * j + e] - d_a);
        dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d_b);
      }
    }
  };

  // Tiles of the block's band outside this warpgroup's are handed back
  // unread.
  const int i_first = max(my_begin - kt_begin, 0);
  const int i_end = min(my_end - kt_begin, n_tiles);
  auto ring = [&](int i) { return n_tiles + i; };  // ring index of pass 2
  int i = 0;
  for (; i < n_tiles && i < i_first; ++i) {
    bar_wait(full + 8 * (ring(i) % STAGES), (ring(i) / STAGES) & 1);
    mbar_arrive(empty + 8 * (ring(i) % STAGES));
  }
  if constexpr (V::OVERLAP) {
    // The S and dP products of tile i and the dQ product of tile i - 1 run
    // together; stage i - 1 is handed back once the latter is in.
    if (i < i_end) {
      int st = ring(i) % STAGES;
      bar_wait(full + 8 * st, (ring(i) / STAGES) & 1);
      issue_sdp(st);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grad(kt_begin + i);
      pack_a(dsf, dp);
      for (++i; i < i_end; ++i) {
        const int prev = st;
        st = ring(i) % STAGES;
        bar_wait(full + 8 * st, (ring(i) / STAGES) & 1);
        issue_sdp(st);
        issue_dq(prev);
        wgmma_wait<1>();  // S and dP of tile i are in
        fence_regs(s);
        fence_regs(dp);
        grad(kt_begin + i);
        wgmma_wait<0>();  // dQ of tile i - 1 is in
        fence_regs(acc);
        mbar_arrive(empty + 8 * prev);
        pack_a(dsf, dp);
      }
      issue_dq(st);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * st);
    }
  } else {
    // two stages: each tile's products in turn, so that the next tile's
    // load runs during the whole of this one
    for (int turn = 0; i < i_end; ++i, ++turn) {
      const int st = ring(i) % STAGES;
      bar_wait(full + 8 * st, (ring(i) / STAGES) & 1);
      issue_sdp(st);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if constexpr (V::XCH) exchange(sX, cp, turn, s, dp);
      grad(kt_begin + i);
      pack_a(dsf, dp);
      issue_dq(st);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * st);
    }
  }
  for (; i < n_tiles; ++i) {
    bar_wait(full + 8 * (ring(i) % STAGES), (ring(i) / STAGES) & 1);
    mbar_arrive(empty + 8 * (ring(i) % STAGES));
  }

  store_rows<NCOL>(dq + b * dqs.b + head * dqs.h, dqs, my_first, p.sq, c0,
                   p.hd, p.scale, acc);
}

// ---------------------------------------------------------------------------
// dk and dv: one block per (BM key rows, kv head x part, batch row)
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_sm90_kv(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap,
                  const float* __restrict__ lse_in,
                  const float* __restrict__ d_in, bf16* __restrict__ dk,
                  Strides dks, bf16* __restrict__ dv, Strides dvs,
                  float* __restrict__ ws, int parts, int bsz,
                  const Problem p) {
  using V = Var<HDP>;
  using L = LayoutKV<HDP>;
  constexpr int TILE = V::TILE, NR = V::NR, NT = V::NT, BM = V::BM;
  constexpr int CS = V::CS, NCOL = V::NCOL, STAGES = V::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base;                    // NT tiles
  const uint32_t sV = sK + NT * TILE;          // NT tiles
  const uint32_t sQ = sV + NT * TILE;          // STAGES tiles
  const uint32_t sDO = sQ + STAGES * TILE;     // STAGES tiles
  const uint32_t sL = base + L::VECS;          // STAGES x 64 floats of lse
  const uint32_t sDs = sL + STAGES * 4 * BT;   // STAGES x 64 floats of D
  const uint32_t full = base + L::BARS;        // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;    // STAGES mbarriers
  const uint32_t kvbar = empty + 8 * STAGES;
  const float* lse_s = reinterpret_cast<const float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::VECS);
  const float* d_s = lse_s + STAGES * BT;
  float* sX = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::XCHG);

  const int kvh = blockIdx.x / parts, part = blockIdx.x % parts;
  const int b = blockIdx.y;
  const int blk_first = blockIdx.z * BM;
  const int qpk = p.h / p.hkv;
  const int h_first = kvh * qpk + part * qpk / parts;
  const int h_end = kvh * qpk + (part + 1) * qpk / parts;
  int qt_begin, qt_end;
  query_band(p, blk_first, min(blk_first + BM, p.sk) - 1, qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int n_items = (h_end - h_first) * nq;  // (head, query tile)
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128 * NC);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: K and V once, then Q, dO, lse and D per (head, query tile)
    setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(kvbar, 2 * NT * TILE);
      for (int c = 0; c < NT; ++c)
        for (int r = 0; r < NR; ++r) {
          tma_load4(sK + c * TILE + r * REGION, &kmap, kvbar, 64 * r, kvh,
                    blk_first + BT * c, b);
          tma_load4(sV + c * TILE + r * REGION, &vmap, kvbar, 64 * r, kvh,
                    blk_first + BT * c, b);
        }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % STAGES;
        const int head = h_first + it / nq;
        const int q0 = (qt_begin + it % nq) * BT;
        const long long row = ((long long)b * p.h + head) * p.sq_pad + q0;
        bar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * TILE + 2 * 4 * BT);
        for (int r = 0; r < NR; ++r) {
          tma_load4(sQ + st * TILE + r * REGION, &qmap, full + 8 * st,
                    64 * r, head, q0, b);
          tma_load4(sDO + st * TILE + r * REGION, &domap, full + 8 * st,
                    64 * r, head, q0, b);
        }
        bulk_load(sL + st * 4 * BT, lse_in + row, 4 * BT, full + 8 * st);
        bulk_load(sDs + st * 4 * BT, d_in + row, 4 * BT, full + 8 * st);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys my_first .. my_first + 63 of tile wg / CS,
  // dK and dV columns c0 .. c0 + NCOL - 1
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int my_first = blk_first + BT * (wg / CS);
  const int cp = wg % CS, c0 = cp * NCOL;
  const uint32_t coff = (c0 / 64) * REGION;  // the columns in a tile
  int my_begin, my_end;
  query_band(p, my_first, min(my_first + BT, p.sk) - 1, my_begin, my_end);
  const uint32_t myK = sK + (wg / CS) * TILE, myV = sV + (wg / CS) * TILE;
  const int r_a = my_first + warp * 16 + (lane >> 2);  // fragment rows (keys)
  const int r_b = r_a + 8;
  const int c2 = (lane & 3) * 2;  // columns (queries) c2, c2 + 1

  float gk[NCOL / 2], gv[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) gk[i] = gv[i] = 0.f;
  float s[BT / 2], dp[BT / 2];
  uint32_t pf[BT / 16][4], dsf[BT / 16][4];
  bar_wait(kvbar, 0);

  int turn = 0;  // tiles this consumer has computed (XCH)
  for (int it = 0; it < n_items; ++it) {
    const int st = it % STAGES;
    const int qt = qt_begin + it % nq;
    bar_wait(full + 8 * st, (it / STAGES) & 1);
    if (qt >= my_begin && qt < my_end) {
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      if constexpr (V::XCH) {
        product_ss<HDP>(s, cp ? myV : myK, (cp ? sDO : sQ) + st * TILE);
      } else {
        product_ss<HDP>(s, myK, sQ + st * TILE);
        product_ss<HDP>(dp, myV, sDO + st * TILE);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if constexpr (V::XCH) exchange(sX, cp, turn++, s, dp);
      const int q0 = qt * BT;
      const bool masked = tile_masked(p, q0, my_first);
      const float* lse_t = lse_s + st * BT;
      const float* d_t = d_s + st * BT;
      // P^T and dS^T column pair by column pair, packed as they are formed
      // (pair j is k-columns 8 (j % 2) .. of the A fragment j / 2), so that
      // the accumulators die as the fragments grow
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(lse_t + 8 * j + c2);
        const float2 dq2 = *reinterpret_cast<const float2*>(d_t + 8 * j + c2);
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse = e ? lq.y : lq.x, dsum = e ? dq2.y : dq2.x;
          float pa = fast_exp2(s[4 * j + e] * p.scale_log2 - lse);
          float pb = fast_exp2(s[4 * j + 2 + e] * p.scale_log2 - lse);
          if (masked) {
            const int qpos = q0 + 8 * j + c2 + e;
            if (!visible(p, qpos, r_a)) pa = 0.f;
            if (!visible(p, qpos, r_b)) pb = 0.f;
          }
          pv[e] = pa;
          pv[2 + e] = pb;
          dsv[e] = pa * (dp[4 * j + e] - dsum);
          dsv[2 + e] = pb * (dp[4 * j + 2 + e] - dsum);
        }
        const int kk = j / 2, at = 2 * (j & 1);
        pf[kk][at] = pack_bf16(pv[0], pv[1]);
        pf[kk][at + 1] = pack_bf16(pv[2], pv[3]);
        dsf[kk][at] = pack_bf16(dsv[0], dsv[1]);
        dsf[kk][at + 1] = pack_bf16(dsv[2], dsv[3]);
        // the next pairs' lse and D are loaded after this pair is packed
        if (j & 1) asm volatile("" ::: "memory");
      }
      fence_regs(gv);
      fence_regs(gk);
      wgmma_fence();
      product_rs<NCOL>(gv, pf, sDO + st * TILE + coff);
      product_rs<NCOL>(gk, dsf, sQ + st * TILE + coff);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);
      fence_regs(gk);
    }
    mbar_arrive(empty + 8 * st);
  }

  if (parts == 1) {
    store_rows<NCOL>(dk + b * dks.b + kvh * dks.h, dks, my_first, p.sk, c0,
                     p.hd, p.scale, gk);
    store_rows<NCOL>(dv + b * dvs.b + kvh * dvs.h, dvs, my_first, p.sk, c0,
                     p.hd, 1.f, gv);
  } else {
    // part `part` of dK, then of dV: (B, Sk, Hkv, hd) float32 each
    const long long n = (long long)bsz * p.sk * p.hkv * p.hd;
    const long long pitch = (long long)p.hkv * p.hd;
    float* wk = ws + part * n + ((long long)b * p.sk * p.hkv + kvh) * p.hd;
    store_part<NCOL>(wk, pitch, my_first, p.sk, c0, p.hd, gk);
    store_part<NCOL>(wk + parts * n, pitch, my_first, p.sk, c0, p.hd, gv);
  }
}

// ---------------------------------------------------------------------------
// the head split's sum: dk = scale sum_p dK_p, dv = sum_p dV_p, parts in
// order; four elements a thread, blockIdx.y 0 for dk and 1 for dv
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_sm90_reduce(const float* __restrict__ ws, bf16* __restrict__ dk,
                      Strides dks, bf16* __restrict__ dv, Strides dvs,
                      int parts, int bsz, int sk, int hkv, int hd,
                      float scale) {
  const long long n = (long long)bsz * sk * hkv * hd;  // elements a part
  const long long e =
      4 * ((long long)blockIdx.x * REDUCE_THREADS + threadIdx.x);
  if (e >= n) return;
  const int which = blockIdx.y;
  const float* src = ws + which * parts * n + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int q = 1; q < parts; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(src + q * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = which == 0 ? scale : 1.f;
  const int c = (int)(e % hd);
  long long r = e / hd;
  const int h = (int)(r % hkv);
  r /= hkv;
  const int s = (int)(r % sk);
  const int b = (int)(r / sk);
  const Strides st = which == 0 ? dks : dvs;
  bf16* out = (which == 0 ? dk : dv) + b * st.b + s * st.s + h * st.h + c;
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * mul, acc.y * mul);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * mul, acc.w * mul);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = v;
}

// -- host side -----------------------------------------------------------------

// A rank-4 map of a (B, S, H, hd) bf16 tensor (dims listed innermost
// first) with boxes of 64 head-dim columns x 1 head x 64 rows x 1 batch row
// under the 128-byte swizzle; boxes past hd, S, H or B read as zeros.
static int make_map(CUtensorMap* map, const void* ptr, int bsz, int seq,
                    int heads, int hd, Strides st) {
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)bsz};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, BT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int HDP>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv, float* lse,
                  float* dsum, float* ws, int parts,
                  const Strides (&in)[5], const Strides (&out)[3], int bsz,
                  const Problem& p, cudaStream_t st) {
  constexpr int BM = Var<HDP>::BM;
  // tensor maps; a side with no rows never loads, so it borrows the
  // other's map
  CUtensorMap qmap, kmap, vmap, domap;
  int err = 0;
  if (p.sq > 0) {
    err = make_map(&qmap, q, bsz, p.sq, p.h, p.hd, in[0]);
    if (!err) err = make_map(&domap, dout, bsz, p.sq, p.h, p.hd, in[4]);
  }
  if (!err && p.sk > 0) {
    err = make_map(&kmap, k, bsz, p.sk, p.hkv, p.hd, in[1]);
    if (!err) err = make_map(&vmap, v, bsz, p.sk, p.hkv, p.hd, in[2]);
  }
  if (err) return err;
  if (p.sq == 0) qmap = domap = kmap;
  if (p.sk == 0) kmap = vmap = qmap;
  static bool attr_set = false;  // once per head-dim variant
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_sm90_q<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LayoutQ<HDP>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_sm90_kv<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LayoutKV<HDP>::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (p.sq > 0) {
    dim3 grid(p.h, bsz, (p.sq + BM - 1) / BM);
    flash_bwd_sm90_q<HDP><<<grid, THREADS, LayoutQ<HDP>::BYTES, st>>>(
        qmap, kmap, vmap, domap, (const bf16*)o, in[3], (const bf16*)dout,
        in[4], (bf16*)dq, out[0], lse, dsum, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (p.sk > 0) {
    dim3 grid(p.hkv * parts, bsz, (p.sk + BM - 1) / BM);
    flash_bwd_sm90_kv<HDP><<<grid, THREADS, LayoutKV<HDP>::BYTES, st>>>(
        qmap, kmap, vmap, domap, lse, dsum, (bf16*)dk, out[1], (bf16*)dv,
        out[2], ws, parts, bsz, p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (parts > 1) {
      const long long n4 = (long long)bsz * p.sk * p.hkv * p.hd / 4;
      dim3 rgrid((unsigned)((n4 + REDUCE_THREADS - 1) / REDUCE_THREADS), 2);
      flash_bwd_sm90_reduce<<<rgrid, REDUCE_THREADS, 0, st>>>(
          ws, (bf16*)dk, out[1], (bf16*)dv, out[2], parts, bsz, p.sk, p.hkv,
          p.hd, p.scale);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// The lse and D scratch's unit of query rows: it holds Sq rounded up to a
// multiple of it per (batch row, head), a multiple of every variant's
// block of query rows (Var<HDP>::BM: 128 up to hd 128, 64 above).
extern "C" int flash_attention_bwd_sm90_rows() { return ROWS; }

// q, o, dout (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) bf16 through their
// element strides (innermost stride 1, the others multiples of 8 elements,
// bases 16-byte aligned); dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv, hd)
// through theirs (the same rules), written whole; lse and dsum float32
// (B, H, sq_pad) scratch, sq_pad a multiple of ROWS at least Sq.  parts
// (1 .. H / Hkv; above 1 only above hd 128): the blocks a group's query
// heads are split over; at parts > 1, ws is float32 workspace of
// 2 parts B Sk Hkv hd elements, 16-byte aligned.  Returns 0, a cudaError_t,
// or ERR_ENCODE + a CUresult.  The caller handles B == 0.  At Sk == 0 the
// first kernel writes dq = 0, at Sq == 0 the second writes dk = dv = 0.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    void* ws, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long dsb, long long dss,
    long long dsh, long long dqsb, long long dqss, long long dqsh,
    long long dksb, long long dkss, long long dksh, long long dvsb,
    long long dvss, long long dvsh, int bsz, int h, int hkv, int sq,
    int sq_pad, int sk, int hd, int causal, int window, int parts,
    double scale, void* stream) {
  const int bm = hd > WIDE_HD ? Var<256>::BM : Var<128>::BM;
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      bsz <= 0 || bsz > 65535 || h > 65535 || sq < 0 || sk < 0 ||
      sq_pad % ROWS != 0 || sq_pad < sq || (sq + bm - 1) / bm > 65535 ||
      (sk + bm - 1) / bm > 65535 || parts < 1 || parts > h / hkv ||
      (parts > 1 && (hd <= WIDE_HD || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (sq == 0 && sk == 0) return 0;
  Problem p;
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sq_pad = sq_pad;
  p.sk = sk;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = (float)scale;
  p.scale_log2 = (float)(scale * 1.4426950408889634);  // scale * log2(e)
  const Strides in[5] = {{qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                         {osb, oss, osh}, {dsb, dss, dsh}};
  const Strides out[3] = {{dqsb, dqss, dqsh}, {dksb, dkss, dksh},
                          {dvsb, dvss, dvsh}};
  cudaStream_t st = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                      (float*)dsum, w, parts, in, out, bsz, p, st);
  if (hd <= 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                       (float*)dsum, w, parts, in, out, bsz, p, st);
  return launch<256>(q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)dsum,
                     w, parts, in, out, bsz, p, st);
}
