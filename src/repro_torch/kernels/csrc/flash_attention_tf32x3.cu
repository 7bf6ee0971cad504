// Blockwise (flash) attention in float32 on Hopper's tensor cores (sm_90a):
// both products as three TF32 mma.sync, so that the sums keep float32
// accuracy.
//
// What it replaces.  The Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_kernel :34, wrapper flash_attention_flat :91, pallas_call :116) for
// float32 inputs; bf16 runs flash_attention_sm90.cu.  It computes the same
// function as that kernel, flash_attention.cu (the first design, float32 FMAs
// on the CUDA cores, on no route) and repro_torch.kernels.ref.
// attention_flat_plain: for q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd),
// query head h reading kv head h / (H / Hkv) (no copy of K or V),
//   out_i = sum_j p_ij v_j,   p_ij = softmax_j(scale * q_i . k_j)
// over the visible keys j: j < Sk; j <= i when causal (top-left aligned,
// also when Sq != Sk); j > i - window when window > 0.  float32 tensors, hd a
// multiple of 8 up to 256, float32 sums and output; a row with no visible key
// gives 0.  The tensors are read, and the output written, in place through
// their (B, S, H) element strides: the (B, S, H, hd) entry point makes no
// transposing copy, and the flat (BH, S, hd) one passes (1, S, BH, hd) views.
//
// The arithmetic.  A single TF32 product keeps 11 bits of each operand and
// would move the float32 parity runs.  So each float32 operand x is split as
// it goes from shared memory or a register into a fragment (sm90.cuh:
// split_tf32_fast): hi = x rounded to tf32 as cvt.rna rounds it (to nearest,
// ties away from zero) in two integer instructions, and lo = x - hi, which
// mma.sync reads as tf32 by dropping its low 13 bits.  Each product A B is
// three mma.sync.m16n8k8 tf32 per k-step of 8, into float32 accumulators: lo(A)
// hi(B), hi(A) lo(B), then hi(A) hi(B).  That covers S = Q K^T (over the head
// dim, each key tile's S from zero) and O += P V.  The softmax stays float32
// on the CUDA cores, in base 2 as in flash_attention_bwd_tf32x3.cu's dq
// kernel: each row's running max m and sum l, x = S scale log2 e, P = 2^(x -
// m), and the accumulator rescaled by alpha = 2^(m_old - m_new).  The tensor
// cores' float32 sums do not round to nearest, and their error grows with the
// products that feed one accumulator (one accumulator over every tile gave
// relative norms of 2.7e-5 to 5e-5 in the split-TF32 backwards).  So each key
// tile's P V products are summed from zero (T / 8 k-steps x 3 products) and
// join O by one rounded fmaf with the rescale folded in: O = fmaf(O, alpha,
// part).  S is summed from zero KG k-steps at a time (3 KG products), the
// groups' sums joined by rounded adds: KG = 1 up to HDT 128, 4 at HDT 256.
// With all of S's 3 HDT / 8 products in one accumulator, or in groups of 4
// k-steps at HDT 128, the output was about as far from the plain version as
// the first design's, yet it moved one expert choice of olmoe's two-layer
// float32 train step on the card against the CPU (chip_smoke's
// train_parity_moe, step 1); with KG = 1 none moved.  At HDT 256 KG = 1 ran
// slower for want of registers, and the hd-256 parity phases hold with KG =
// 4.  At the end out = O / max(l, 1e-30).
// tests/test_torch_flash_fwd_tf32x3.py rebuilds this arithmetic, and its
// order of sums, in plain torch.
//
// The masked-row trap: masked scores are -1e30 (NEG_INF_SCORE), and p is 0
// wherever the mask is false (x <= -5e29), so a row that has seen no visible
// key keeps m = -1e30, l = 0 and O = 0, and gives 0.
//
// Bound on the H100: operations.  4 hd FLOPs per visible (query, key) pair
// and query head, three TF32 products each.  qwen3_4b's prefill (B=4, S=1,024,
// 32/8 heads, hd 128, causal): 3.44e10 FLOPs, 0.209 ms at 3 x operations over
// the 494.7 TFLOP/s dense TF32 peak (0.513 at the first design's 67 TFLOP/s
// CUDA-core peak), against 42 MB of q, k, v and output (0.013 ms at 3.35
// TB/s).  The parity phases' shape (B=2, S=128, 32/8 heads, hd 128, causal):
// 0.00313 ms by bytes, which binds there.  sm_90a has no tf32 conversion
// instruction, so each split costs ALU instructions; split_tf32_fast takes
// three where cvt.rna's split takes nine.  Every K and V element is split once
// by each of a block's 4 warps, about 2.7 instructions for each mma.sync:
// the design is held by instruction dispatch about as much as by the tensor
// cores.
//
// Design: one kernel, flash_fwd_tf32x3<HDT>, HDT the head dim rounded up to
// 64, 128 or 256.  One block of 4 warps per (BR = 64 query rows, head, batch
// row); warp w owns query rows 16 w .. 16 w + 15 of the tile, whole: its S
// tile, its softmax state and its 16 x HDT accumulator O stay in its
// registers, so a row's max and sum are two quad shuffles and no warp waits on
// another's softmax.  Blocks are launched heaviest causal tiles first (the
// query tile is the grid's slow axis, counted from the last).  The visible key
// tiles are one contiguous range (tiles wholly outside the causal or window
// band, or past Sk, are never visited); only the warp tiles that cross the
// band's edge or Sk evaluate the mask.
// - Loads: Q (BR rows) once, then each visible tile of T keys of K and V, by
//   16-byte cp.async into rows of LD = HDT + 4 floats (LD % 32 == 4: every
//   fragment read below hits 32 distinct banks), zero-filled past hd and past
//   Sk or Sq, so that no branch surrounds an mma.sync (ptxas wraps one under
//   a run-time branch in a WARPSYNC).  K and V go in a two-slot ring: the next
//   visible tile's copy is started before the current tile is waited for and
//   computed.
// - S = Q K^T: 16 x T a warp, HDT / 8 k-steps, each Q fragment split once
//   and used for the T / 8 n-tiles.
// - O += P V with P in registers: m16n8k8's accumulator holds columns (2t,
//   2t + 1) where its A fragment wants (t, t + 4), so each k-step takes its 8
//   keys in the order 0, 2, 4, 6, 1, 3, 5, 7 on both operands (A column t is
//   key 2t, A column t + 4 key 2t + 1; V's rows 2t and 2t + 1): an S
//   accumulator n-tile is P V's A fragment as it stands.  The fresh sum of a
//   tile goes CH n-tiles of O at a time (P split again for each), the rest of
//   O waiting in registers.
// - Tiles per head-dim class (shared memory: Q, then K and V in two slots;
//   O takes HDT / 2 registers a thread):
//     HDT  64: T = 64, CH = 8, KG = 1;  87,040 B, 2 blocks (8 warps) an SM
//     HDT 128: T = 32, CH = 8, KG = 1; 101,376 B, 2 blocks (8 warps) an SM
//     HDT 256: T = 32, CH = 4, KG = 4; 199,680 B, 1 block (4 warps) an SM
//   At HDT 128 a 64-key ring (169 KB) would leave one block an SM; at HDT
//   256 a 64-row float32 tile is 66.5 KB, so T = 32 is the most the ring and
//   Q fit in 227 KB.  ptxas (CUDA 12.8) gives 174, 252 and 255 registers a
//   thread, the last spilling 32 bytes; the S loop is unrolled whole.
// Deterministic: no atomics, every output element is written by one warp and
// the order of every sum is fixed, so two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define BR 64             // query rows of a block
#define WARPS 4           // 16 query rows a warp
#define THREADS (32 * WARPS)
#define NEG_INF_SCORE (-1e30f)
#define FULL 0xffffffffu

struct Strides {
  long long b, s, h;      // elements; the head-dim stride is 1
};

struct Problem {
  Strides q, k, v, o;
  int h, hkv, sq, sk, hd, causal, window;
  float scale_log2;
};

// The tiling at head dim HDT (64, 128 or 256).
template <int HDT>
struct Shape {
  static constexpr int T = HDT > 64 ? 32 : 64;    // keys a tile
  static constexpr int LD = HDT + 4;              // floats a staged row
  static constexpr int NS = T / 8;                // n-tiles of a warp's S
  static constexpr int NO = HDT / 8;              // n-tiles of a warp's O
  static constexpr int CH = HDT > 128 ? 4 : 8;    // n-tiles of a fresh P V sum
  static constexpr int KG = HDT > 128 ? 4 : 1;    // k-steps of a fresh S sum
  static constexpr int FLOATS = BR * LD + 4 * T * LD;  // Q; K, V in two slots
  static_assert(LD % 32 == 4, "bank layout");
  static_assert(NO % CH == 0, "P V chunks");
  static_assert(HDT % (8 * KG) == 0, "S groups");
};

// Rows [first, first + n) of a (B, S, H, hd) tensor at (b, h) into shared
// memory rows of LD floats by 16-byte cp.async; rows past s and columns
// hd .. HDT - 1 are zeros.  The caller commits.
template <int LD, int HDT>
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

// acc[n] += A B_n for the NN n-tiles, the split's three products in the order
// lo(A) hi(B), hi(A) lo(B), hi(A) hi(B), each loop issuing independent
// products.  No branch may surround an mma.sync.
template <int NN>
__device__ __forceinline__ void mma3(float (&acc)[NN][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NN][2],
                                     const uint32_t (&bl)[NN][2]) {
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32_1688(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32_1688(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32_1688(acc[n], ah, bh[n][0], bh[n][1]);
}

template <int HDT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 const Problem p) {
  using Sh = Shape<HDT>;
  constexpr int T = Sh::T, LD = Sh::LD, NS = Sh::NS, NO = Sh::NO;
  constexpr int CH = Sh::CH, KG = Sh::KG;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BR x LD
  float* ring = qs + BR * LD;                   // slot s: K, then V, T x LD

  const int q_first = (gridDim.y - 1 - (int)blockIdx.y) * BR;  // heaviest first
  const int h = blockIdx.x % p.h, b = blockIdx.x / p.h;
  const int hk = h / (p.h / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int w_first = q_first + 16 * warp, w_last = w_first + 15;

  // the visible key tiles: kt_lo .. kt_hi
  const int q_hi = min(q_first + BR, p.sq) - 1;
  int kt_lo = 0, kt_hi = (p.sk + T - 1) / T - 1;
  if (p.causal) kt_hi = min(kt_hi, q_hi / T);
  if (p.window > 0) kt_lo = max(0, q_first - p.window + 1) / T;

  stage<LD, HDT>(qs, q, p.q, b, h, q_first, BR, p.sq, p.hd);
  cp_async_commit();
  if (kt_lo <= kt_hi) {
    stage<LD, HDT>(ring, k, p.k, b, hk, kt_lo * T, T, p.sk, p.hd);
    stage<LD, HDT>(ring + T * LD, v, p.v, b, hk, kt_lo * T, T, p.sk, p.hd);
    cp_async_commit();
  }

  float acc[NO][4] = {};                 // O: rows g, g + 8; columns 8 n + 2 tg
  float m[2] = {NEG_INF_SCORE, NEG_INF_SCORE}, l[2] = {0.f, 0.f};
  const float* qa = qs + (16 * warp + g) * LD + tg;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    float* ks = ring + ((kt - kt_lo) & 1) * 2 * T * LD;
    const float* vs = ks + T * LD;
    if (kt < kt_hi) {  // the next visible tile into the other slot
      float* next = ring + ((kt + 1 - kt_lo) & 1) * 2 * T * LD;
      stage<LD, HDT>(next, k, p.k, b, hk, (kt + 1) * T, T, p.sk, p.hd);
      stage<LD, HDT>(next + T * LD, v, p.v, b, hk, (kt + 1) * T, T, p.sk,
                     p.hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T over the staged head dim: each KG k-steps from zero, the
    // groups' sums added in order
    float s[NS][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < HDT; k0 += 8 * KG) {
      float part[NS][4] = {};
#pragma unroll
      for (int k1 = k0; k1 < k0 + 8 * KG; k1 += 8) {
        uint32_t ah[4], al[4], bh[NS][2], bl[NS][2];
        split4_tf32<SplitFast>(qa[k1], qa[k1 + 8 * LD], qa[k1 + 4],
                               qa[k1 + 8 * LD + 4], ah, al);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kb = ks + (8 * n + g) * LD + k1 + tg;
          split_tf32_fast(kb[0], bh[n][0], bl[n][0]);
          split_tf32_fast(kb[4], bh[n][1], bl[n][1]);
        }
        mma3<NS>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
    }

    // scaled, masked scores; the online softmax of rows g and g + 8
    const int k_first = kt * T;
    const bool full = k_first + T <= p.sk &&
                      (!p.causal || k_first + T - 1 <= w_first) &&
                      (p.window <= 0 || k_first > w_last - p.window);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = w_first + g + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k_first + 8 * n + 2 * tg + j;
          bool vis = full || kpos < p.sk;
          if (!full && p.causal) vis = vis && kpos <= qpos;
          if (!full && p.window > 0) vis = vis && kpos > qpos - p.window;
          float& x = s[n][2 * i + j];
          x = vis ? x * p.scale_log2 : NEG_INF_SCORE;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[n][2 * i + j];
          x = x > 0.5f * NEG_INF_SCORE ? exp2f(x - mx) : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      alpha[i] = exp2f(m[i] - mx);
      l[i] = fmaf(l[i], alpha[i], sum);
      m[i] = mx;
    }

    // O = O alpha + P V: CH n-tiles at a time, each from zero
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += CH) {
      float part[CH][4] = {};
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t ah[4], al[4], bh[CH][2], bl[CH][2];
        split4_tf32<SplitFast>(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ah,
                               al);
        const float* vb = vs + (8 * kk + 2 * tg) * LD + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          split_tf32_fast(vb[8 * n], bh[n][0], bl[n][0]);
          split_tf32_fast(vb[LD + 8 * n], bh[n][1], bl[n][1]);
        }
        mma3<CH>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e / 2], part[n][e]);
    }
    __syncthreads();  // this slot is consumed before it is filled again
  }
  cp_async_wait<0>();  // Q, where no key tile was visible

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w_first + g + 8 * i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);  // no visible key: O = 0, so 0
    float* orow = out + b * p.o.b + (long long)row * p.o.s + h * p.o.h;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * tg;
      if (col < p.hd)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    }
  }
}

template <int HDT>
static int launch(const float* q, const float* k, const float* v, float* out,
                  int bsz, const Problem& p, cudaStream_t st) {
  using Sh = Shape<HDT>;
  const size_t smem = sizeof(float) * (size_t)Sh::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3<HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bsz * p.h, (p.sq + BR - 1) / BR);
  flash_fwd_tf32x3<HDT><<<grid, THREADS, smem, st>>>(q, k, v, out, p);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

// q, out (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) float32 through their
// element strides (innermost stride 1, the others multiples of 4, q, k and v
// 16-byte aligned: the wrapper copies a tensor that is not; out is written
// by 8-byte stores).  Returns 0 or a cudaError_t.  The caller handles B == 0
// and Sq == 0; at Sk == 0 every row is 0.
extern "C" int flash_attention_tf32x3_launch(
    const void* q, const void* k, const void* v, void* out, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, int bsz, int h, int hkv, int sq, int sk, int hd,
    int causal, int window, double scale, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      bsz <= 0 || sq <= 0 || sk < 0 || (long long)bsz * h > 0x7fffffffLL ||
      (sq + BR - 1) / BR > 65535)
    return (int)cudaErrorInvalidValue;
  const long long strides[] = {qsb, qss, qsh, ksb, kss, ksh,
                               vsb, vss, vsh, osb, oss, osh};
  for (long long s : strides)
    if (s % 4 != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.q = Strides{qsb, qss, qsh};
  p.k = Strides{ksb, kss, ksh};
  p.v = Strides{vsb, vss, vsh};
  p.o = Strides{osb, oss, osh};
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = (float)(scale * 1.4426950408889634);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v;
  float* fo = (float*)out;
  if (hd <= 64) return launch<64>(fq, fk, fv, fo, bsz, p, st);
  if (hd <= 128) return launch<128>(fq, fk, fv, fo, bsz, p, st);
  return launch<256>(fq, fk, fv, fo, bsz, p, st);
}

// BR, the query rows of a block, for the wrapper's grid check.
extern "C" int flash_attention_tf32x3_rows() { return BR; }
