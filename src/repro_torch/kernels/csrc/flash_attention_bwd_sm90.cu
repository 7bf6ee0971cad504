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
// bf16 tensors, head dim a multiple of 8 up to 128; sums in float32, p and
// ds rounded to bf16 as the operands of the three accumulating products
// (the forward rounds p the same way for P V), outputs in bf16.  A row with
// no visible key gets dq = 0; a key no query sees gets dk = dv = 0.
//
// Bound on the H100: operations.  10 hd FLOPs per visible (query, key) pair
// and query head (the five products above): at the trainer's shape (B=4,
// S=1,024, 32/8 heads, hd 128, causal) 8.6e10 FLOPs, 0.087 ms at the 989
// TFLOP/s bf16 peak, against 50 MB of q, k, v, o, dO, dq, dk, dv (0.015 ms
// at 3.35 TB/s).  This design does S and dP in both kernels and S once more
// for the log-sum-exp: 16 hd FLOPs a pair, a floor of about 0.139 ms.
//
// Design: two kernels, deterministic, no atomics (every output element is
// written by one block, so two calls give the same bits).  Each is
// warp-specialised as the forward (flash_attention_sm90.cu): one block of
// three warpgroups, a producer warpgroup (24 registers a thread after
// setmaxnreg) whose one thread issues TMA loads through rank-4 tensor maps
// of the strided (B, S, H, hd) tensors into a ring of three stages on full
// and empty mbarriers, and two consumer warpgroups (240 registers) of 64
// rows each.  The head dim is zero-padded by TMA to HDP = 64 or 128, so
// every tile is made of 64-column regions of 128-byte rows under the
// 128-byte swizzle, and the wgmma descriptors are the forward's: a tile is
// K-major as the A or B operand of a product over the head dim, and
// MN-major as the B operand of a product over its rows.
// - flash_bwd_sm90_q: one block per (128 query rows, head, batch row), the
//   heaviest causal tiles first.  The producer loads the two Q and dO
//   tiles once, then the block's key tiles twice: K alone (pass 1), then
//   K and V (pass 2).  Each consumer computes D_i from o and dO in device
//   memory; pass 1: S = Q K^T (m64n64k16, both operands K-major) and the
//   forward's online max and sum on the accumulator, hence lse_i (base 2,
//   of the scores times scale log2 e); pass 2, per key tile: S and
//   dP = dO V^T (m64n64k16_ss), P = 2^(S scale log2 e - lse) and
//   dS = P (dP - D) on the accumulator fragments, then dQ += dS K
//   (m64n{HDP}k16 with dS, cast to bf16, as the register A operand: the
//   accumulator fragment of a product is the A fragment of the next; K
//   MN-major, the layout V takes in the forward's P V).  The dQ product of
//   tile i - 1 runs while the S and dP products of tile i are waited for
//   and while dS of tile i is formed (the forward's overlap); pass 1 waits
//   for each S (S and dP taking turns as two buffers was slower on the
//   H100: the branch around the second issue serialised the wgmma).  It
//   writes dq * scale, lse and D (float32 (B, H, Sq_pad) scratch, rows
//   past Sq included, lse = NO_LSE there).
// - flash_bwd_sm90_kv: one block per (128 key rows, kv head, batch row),
//   the heaviest causal tiles (the first keys) first.  Each consumer owns
//   64 keys whose K and V tiles stay in shared memory.  The producer walks
//   the group's query heads and their visible query tiles and brings Q,
//   dO, and the tile's lse and D (a bulk copy each).  Per tile:
//   S^T = K Q^T and dP^T = V dO^T (m64n64k16_ss); keys are the M rows, so
//   the fragments of P^T and dS^T = P^T (dP^T - D) are the A fragments of
//   dV += P^T dO and dK += dS^T Q (m64n{HDP}k16_rs, dO and Q MN-major).
//   Registers at HDP = 128: dK 64 + dV 64 + S 32 + dP 32 a thread, near
//   the 240 of a consumer, so P^T and dS^T are formed and packed to bf16
//   one column pair at a time, with that pair's lse and D read from shared
//   memory just before (read all at once, the 32 values pushed a consumer
//   past 240 registers: 948 bytes of spills and serialised wgmma), and a
//   warpgroup waits for its own products (the two consumer warpgroups
//   overlap each other).
// Only tiles that cross the band's edge, Sq or Sk are masked, with the
// forward's predicate (visible()); tiles wholly outside the band are never
// loaded.  The masked-row trap: a row with no visible key gets lse = NO_LSE
// (1e30), so 2^(s - lse) = 0, and P is zeroed wherever visible() is false.
// An mbarrier wait traps after SPIN_LIMIT polls, so a fault in the ring is
// a CUDA error and not a hang.
//
// Why hd above 128 stays on the CUDA cores (flash_attention_bwd.cu): a
// 64 x 256 float32 accumulator for each of dK and dV takes 256 registers a
// thread, past the 255 a thread may hold.  Nothing trains at hd 256 on the
// card (recurrentgemma's rglru_scan has no backward kernel).
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
#define BM (BT * NC)               // a block's own rows
#define STAGES 3
#define REGION (64 * 128)  // bytes of one 64-row x 64-column swizzled region
#define NEG_INF_SCORE (-1e30f)
#define NO_LSE (1e30f)  // lse of a row with no visible key: 2^(x - NO_LSE) = 0
#define FULL_MASK 0xffffffffu
#define SPIN_LIMIT (1u << 28)  // polls of an mbarrier before a wait traps

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, s, h;  // elements; the head-dim stride is 1
};

struct Problem {
  int h, hkv, sq, sq_pad, sk, hd, causal, window;
  float scale, scale_log2;
};

template <int HDP>
struct Tiles {
  static constexpr int NR = HDP / 64;       // 64-column regions
  static constexpr int TILE = NR * REGION;  // one 64-row tile
};

// flash_bwd_sm90_q: NC Q and NC dO tiles, STAGES K and V tiles,
// 2 STAGES + 1 mbarriers, NC x 64 floats of D
template <int HDP>
struct LayoutQ {
  static constexpr int TILE = Tiles<HDP>::TILE;
  static constexpr int BARS = TILE * (2 * NC + 2 * STAGES);
  static constexpr int DROWS = BARS + 8 * (2 * STAGES + 1);
  static constexpr int BYTES = DROWS + 4 * BM + 1024;
};

// flash_bwd_sm90_kv: NC K and NC V tiles, STAGES Q and dO tiles,
// STAGES x 64 floats of lse and of D, 2 STAGES + 1 mbarriers
template <int HDP>
struct LayoutKV {
  static constexpr int TILE = Tiles<HDP>::TILE;
  static constexpr int VECS = TILE * (2 * NC + 2 * STAGES);
  static constexpr int BARS = VECS + 2 * STAGES * 4 * BT;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;
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

// D (64 x HDP) += A (64 x 64, register fragments) B, B a 64-row tile read
// MN-major.
template <int HDP>
__device__ __forceinline__ void product_rs(float (&d)[HDP / 2],
                                           const uint32_t (&a)[BT / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_rs<HDP>(d, a[kk], wgmma_desc(b + kk * 16 * 128, REGION, 1024));
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

// A 64 x HDP fp32 accumulator times mul into rows first + (fragment row) of
// a (B, S, H, hd) bf16 tensor at (b, head): rows below s, columns below hd.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* base, Strides st, int first,
                                           int s, int hd, float mul,
                                           const float (&acc)[HDP / 2]) {
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int r_a = first + warp * 16 + (lane >> 2), r_b = r_a + 8;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + c2;
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

// ---------------------------------------------------------------------------
// dq, lse and D: one block per (128 query rows, head, batch row)
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
  using L = LayoutQ<HDP>;
  constexpr int TILE = L::TILE, NR = HDP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                  // NC tiles
  const uint32_t sDO = sQ + NC * TILE;       // NC tiles
  const uint32_t sK = sDO + NC * TILE;       // STAGES tiles
  const uint32_t sV = sK + STAGES * TILE;    // STAGES tiles
  const uint32_t full = base + L::BARS;      // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;  // STAGES mbarriers
  const uint32_t qbar = empty + 8 * STAGES;
  float* sD = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::DROWS);

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
      mbar_expect_tx(qbar, 2 * NC * TILE);
      for (int c = 0; c < NC; ++c)
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

  // consumer warpgroup wg: query rows my_first .. my_first + 63
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int my_first = blk_first + BT * wg;
  int my_begin, my_end;
  key_band(p, my_first, min(my_first + BT, p.sq) - 1, my_begin, my_end);
  const uint32_t myQ = sQ + wg * TILE, myDO = sDO + wg * TILE;
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
      d_out[row0 + qpos] = acc;
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
    if (kt >= my_begin && kt < my_end) {
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
  const float lse_a = l_a > 0.f ? m_a + log2f(l_a) : NO_LSE;
  const float lse_b = l_b > 0.f ? m_b + log2f(l_b) : NO_LSE;
  if ((lane & 3) == 0) {
    lse_out[row0 + r_a] = lse_a;
    lse_out[row0 + r_b] = lse_b;
  }

  // pass 2: dq_i = sum_j p_ij (dp_ij - D_i) k_j
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  uint32_t dsf[BT / 16][4];
  // S and dP of the tile in stage st: one wgmma group
  auto issue_sdp = [&](int st) {
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_ss<HDP>(s, myQ, sK + st * TILE);
    product_ss<HDP>(dp, myDO, sV + st * TILE);
    wgmma_commit();
  };
  // dQ += dS K from dsf: one wgmma group
  auto issue_dq = [&](int st) {
    fence_regs(acc);
    wgmma_fence();
    product_rs<HDP>(acc, dsf, sK + st * TILE);
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
  // unread.  The S and dP products of tile i and the dQ product of tile
  // i - 1 run together; stage i - 1 is handed back once the latter is in.
  const int i_first = max(my_begin - kt_begin, 0);
  const int i_end = min(my_end - kt_begin, n_tiles);
  auto ring = [&](int i) { return n_tiles + i; };  // ring index of pass 2
  int i = 0;
  for (; i < n_tiles && i < i_first; ++i) {
    bar_wait(full + 8 * (ring(i) % STAGES), (ring(i) / STAGES) & 1);
    mbar_arrive(empty + 8 * (ring(i) % STAGES));
  }
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
  for (; i < n_tiles; ++i) {
    bar_wait(full + 8 * (ring(i) % STAGES), (ring(i) / STAGES) & 1);
    mbar_arrive(empty + 8 * (ring(i) % STAGES));
  }

  store_rows<HDP>(dq + b * dqs.b + head * dqs.h, dqs, my_first, p.sq, p.hd,
                  p.scale, acc);
}

// ---------------------------------------------------------------------------
// dk and dv: one block per (128 key rows, kv head, batch row)
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
                  const Problem p) {
  using L = LayoutKV<HDP>;
  constexpr int TILE = L::TILE, NR = HDP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base;                    // NC tiles
  const uint32_t sV = sK + NC * TILE;          // NC tiles
  const uint32_t sQ = sV + NC * TILE;          // STAGES tiles
  const uint32_t sDO = sQ + STAGES * TILE;     // STAGES tiles
  const uint32_t sL = base + L::VECS;          // STAGES x 64 floats of lse
  const uint32_t sDs = sL + STAGES * 4 * BT;   // STAGES x 64 floats of D
  const uint32_t full = base + L::BARS;        // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;    // STAGES mbarriers
  const uint32_t kvbar = empty + 8 * STAGES;
  const float* lse_s = reinterpret_cast<const float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::VECS);
  const float* d_s = lse_s + STAGES * BT;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int blk_first = blockIdx.z * BM;
  const int qpk = p.h / p.hkv;
  int qt_begin, qt_end;
  query_band(p, blk_first, min(blk_first + BM, p.sk) - 1, qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int n_items = qpk * nq;  // (query head, query tile), head-major
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
      mbar_expect_tx(kvbar, 2 * NC * TILE);
      for (int c = 0; c < NC; ++c)
        for (int r = 0; r < NR; ++r) {
          tma_load4(sK + c * TILE + r * REGION, &kmap, kvbar, 64 * r, kvh,
                    blk_first + BT * c, b);
          tma_load4(sV + c * TILE + r * REGION, &vmap, kvbar, 64 * r, kvh,
                    blk_first + BT * c, b);
        }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % STAGES;
        const int head = kvh * qpk + it / nq;
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

  // consumer warpgroup wg: keys my_first .. my_first + 63
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int my_first = blk_first + BT * wg;
  int my_begin, my_end;
  query_band(p, my_first, min(my_first + BT, p.sk) - 1, my_begin, my_end);
  const uint32_t myK = sK + wg * TILE, myV = sV + wg * TILE;
  const int r_a = my_first + warp * 16 + (lane >> 2);  // fragment rows (keys)
  const int r_b = r_a + 8;
  const int c2 = (lane & 3) * 2;  // columns (queries) c2, c2 + 1

  float gk[HDP / 2], gv[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) gk[i] = gv[i] = 0.f;
  float s[BT / 2], dp[BT / 2];
  uint32_t pf[BT / 16][4], dsf[BT / 16][4];
  bar_wait(kvbar, 0);

  for (int it = 0; it < n_items; ++it) {
    const int st = it % STAGES;
    const int qt = qt_begin + it % nq;
    bar_wait(full + 8 * st, (it / STAGES) & 1);
    if (qt >= my_begin && qt < my_end) {
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_ss<HDP>(s, myK, sQ + st * TILE);
      product_ss<HDP>(dp, myV, sDO + st * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
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
      product_rs<HDP>(gv, pf, sDO + st * TILE);
      product_rs<HDP>(gk, dsf, sQ + st * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);
      fence_regs(gk);
    }
    mbar_arrive(empty + 8 * st);
  }

  store_rows<HDP>(dk + b * dks.b + kvh * dks.h, dks, my_first, p.sk, p.hd,
                  p.scale, gk);
  store_rows<HDP>(dv + b * dvs.b + kvh * dvs.h, dvs, my_first, p.sk, p.hd,
                  1.f, gv);
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
                  float* dsum, const Strides (&in)[5], const Strides (&out)[3],
                  int bsz, const Problem& p, cudaStream_t st) {
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
    dim3 grid(p.hkv, bsz, (p.sk + BM - 1) / BM);
    flash_bwd_sm90_kv<HDP><<<grid, THREADS, LayoutKV<HDP>::BYTES, st>>>(
        qmap, kmap, vmap, domap, lse, dsum, (bf16*)dk, out[1], (bf16*)dv,
        out[2], p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Query rows a block of flash_bwd_sm90_q covers: the lse and D scratch
// holds Sq rounded up to a multiple of it per (batch row, head).
extern "C" int flash_attention_bwd_sm90_rows() { return BM; }

// q, o, dout (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) bf16 through their
// element strides (innermost stride 1, the others multiples of 8 elements,
// bases 16-byte aligned); dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv, hd)
// through theirs (the same rules), written whole; lse and dsum float32
// (B, H, sq_pad) scratch, sq_pad a multiple of BM at least Sq.  Returns 0,
// a cudaError_t, or ERR_ENCODE + a CUresult.  The caller handles B == 0.
// At Sk == 0 the first kernel writes dq = 0, at Sq == 0 the second writes
// dk = dv = 0.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss, long long dsh,
    long long dqsb, long long dqss, long long dqsh, long long dksb,
    long long dkss, long long dksh, long long dvsb, long long dvss,
    long long dvsh, int bsz, int h, int hkv, int sq, int sq_pad, int sk,
    int hd, int causal, int window, double scale, void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      bsz <= 0 || bsz > 65535 || h > 65535 || sq < 0 || sk < 0 ||
      sq_pad % BM != 0 || sq_pad < sq || (sq + BM - 1) / BM > 65535 ||
      (sk + BM - 1) / BM > 65535)
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
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                      (float*)dsum, in, out, bsz, p, st);
  return launch<128>(q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)dsum,
                     in, out, bsz, p, st);
}
