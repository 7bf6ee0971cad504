// Blockwise (flash) attention in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_kernel, wrapper flash_attention_flat) for bf16 inputs; float32 runs the
// split-TF32 kernel of flash_attention_tf32x3.cu.  q (B, Sq, H, hd),
// k and v (B, Sk, Hkv, hd), out (B, Sq, H, hd), each read and written in
// place through its strides (innermost stride 1, the others multiples of 8
// elements, bases 16-byte aligned), so neither the (B, S, H, hd) layout of
// the models nor the flat (BH, S, hd) layout of flash_attention_flat (B = 1,
// H = BH) needs a transposing copy.  Query head h reads kv head
// h / (H / Hkv):
//   out[b, i, h] = sum_j p_ij v[b, j, h / qpk],
//   p = softmax_j(scale * q[b, i, h] . k[b, j, h / qpk])
// over the visible keys j: j < Sk; j <= i when causal (top-left aligned,
// also when Sq != Sk); j > i - window when window > 0.  Sums in float32,
// output in bf16.  A row with no visible key gives 0.
//
// Bound on the H100: operations.  At qwen3_4b's prefill (B=4, S=1,024, 32/8
// heads, hd 128, causal) about 34 GFLOP, 35 us at the 989 TFLOP/s bf16 peak,
// against 42 MB (13 us at 3.35 TB/s); at recurrentgemma's (B=4, S=3,072,
// 16/1 heads, hd 256, window 2,048) 275 GFLOP, 0.28 ms.
//
// Design (warp-specialised: a producer and consumers).  One block of three
// warpgroups per (128 query rows, head, batch row); the heaviest query
// tiles of a causal grid start first.  The head dim is padded with zeros to
// HDP, a multiple of 64, so that every operand tile is made of 64-column
// regions of 128-byte rows under the 128-byte swizzle: what TMA's
// SWIZZLE_128B writes and a wgmma descriptor of type B128 reads.
// - Producer warpgroup (24 registers a thread after setmaxnreg): one thread
//   issues TMA loads through rank-4 tensor maps of the strided tensors
//   (boxes of 64 columns x 64 rows, zero-filled past hd, Sq and Sk): the two
//   Q tiles once, then K and V tiles of 64 keys into a ring of three stages
//   (two at HDP = 256, for want of shared memory), each stage completed on
//   a "full" mbarrier and handed back on an "empty" one.
// - Two consumer warpgroups (240 registers a thread: the 64 x 256 fp32
//   output accumulator alone takes 128), each owning 64 query rows whose Q
//   tile stays in shared memory for the whole key loop.  Per key tile:
//   S = Q K^T    wgmma m64n64k16, both operands from shared memory, K-major;
//   online softmax on S's accumulator fragment in registers (each thread
//                holds 2 rows x 16 keys; row max and sum over the 4 lanes of
//                a quad), the output accumulator rescaled in registers;
//   O += P V     wgmma m64n{HDP}k16 with P, cast to bf16, as the register A
//                operand (for 16-bit types the accumulator fragment of the
//                first product is the A fragment of the second) and V as the
//                MN-major B operand from the same smem layout as K.
//   With three stages the S product of tile i and the P V product of tile
//   i - 1 are issued together and run while the warpgroup computes the
//   softmax of tile i (the two consumer warpgroups overlap each other's
//   softmax too).  A key tile outside a warpgroup's own band is only
//   handed back.
// Only tiles that cross the band's edge or Sk are masked; interior tiles
// skip it, and key tiles wholly outside the band are never loaded (the TPU
// kernel's band skip, :50-54).
//
// The masked-row trap, as in flash_attention.cu: masked scores are -1e30
// (not -inf); while a row has seen no visible key its running max is still
// -1e30 and exp(s - m) would be 1, so p is zeroed wherever the mask is
// false (the TPU kernel's where(mask, p, 0), :77), and the final division
// is by max(l, 1e-30) (:87).
//
// Not yet here: that overlap at HDP = 256, larger key tiles, a
// persistent grid (see PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#define NC 2                       // consumer warpgroups per block
#define THREADS (128 * (NC + 1))   // + one producer warpgroup
#define BM (64 * NC)               // query rows per block
#define BK 64                      // keys per tile
#define REGION (64 * 128)  // bytes of one 64-row x 64-column swizzled region
#define NEG_INF_SCORE (-1e30f)

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, s, h;  // elements; the head-dim stride is 1
};

template <int HDP>
struct Layout {
  static constexpr int NR = HDP / 64;       // 64-column regions
  static constexpr int TILE = NR * REGION;  // one 64-row Q, K or V tile
  static constexpr int STAGES = HDP <= 192 ? 3 : 2;  // what 227 KB holds
  // NC Q tiles, STAGES K and V tiles, 2 * STAGES + 1 mbarriers, alignment
  static constexpr int BARS = TILE * (NC + 2 * STAGES);
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

// Key tiles [begin, end) that rows first .. last may see.
__device__ __forceinline__ void band(int first, int last, int sk, int causal,
                                     int window, int& begin, int& end) {
  begin = 0;
  end = (sk + BK - 1) / BK;
  if (causal) end = min(end, (last + BK) / BK);
  if (window > 0) begin = max(0, first - window + 1) / BK;
  if (last < first) end = begin;  // no rows
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  bf16* __restrict__ out, Strides os, int h, int hkv, int sq,
                  int sk, int hd, int causal, int window, float scale_log2) {
  using L = Layout<HDP>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                    // NC tiles
  const uint32_t sK = sQ + NC * L::TILE;       // STAGES tiles
  const uint32_t sV = sK + STAGES * L::TILE;   // STAGES tiles
  const uint32_t full = base + L::BARS;        // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;    // STAGES mbarriers
  const uint32_t qbar = empty + 8 * STAGES;

  const int blk_first = (gridDim.x - 1 - blockIdx.x) * BM;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  int kt_begin, kt_end;
  band(blk_first, min(blk_first + BM, sq) - 1, sk, causal, window, kt_begin,
       kt_end);
  const int n_tiles = max(kt_end - kt_begin, 0);
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
    // producer: one thread keeps the TMA loads of the ring in flight
    setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(qbar, NC * L::TILE);
      for (int c = 0; c < NC; ++c)
        for (int r = 0; r < L::NR; ++r)
          tma_load4(sQ + c * L::TILE + r * REGION, &qmap, qbar, 64 * r, head,
                    blk_first + 64 * c, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const int k0 = (kt_begin + i) * BK;
        mbar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * L::TILE);
        for (int r = 0; r < L::NR; ++r) {
          tma_load4(sK + st * L::TILE + r * REGION, &kmap, full + 8 * st,
                    64 * r, kvh, k0, b);
          tma_load4(sV + st * L::TILE + r * REGION, &vmap, full + 8 * st,
                    64 * r, kvh, k0, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows my_first .. my_first + 63
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
    const int my_first = blk_first + 64 * wg;
    const int my_last = min(my_first + 64, sq) - 1;
    int my_begin, my_end;
    band(my_first, my_last, sk, causal, window, my_begin, my_end);
    const uint32_t myQ = sQ + wg * L::TILE;

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float s[BK / 2];
    uint32_t pf[BK / 16][4];
    float m_a = NEG_INF_SCORE, m_b = NEG_INF_SCORE, l_a = 0.f, l_b = 0.f;
    const int r_a = my_first + warp * 16 + (lane >> 2);  // fragment rows
    const int r_b = r_a + 8;                             // r_a, r_b
    const int c2 = (lane & 3) * 2;                       // columns c2, c2+1

    // S = Q K^T into s: one wgmma group
    auto issue_qk = [&](int st) {
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * REGION + (kk & 3) * 32;
        wgmma_m64n64k16_ss(s, wgmma_desc(myQ + off, 16, 1024),
                           wgmma_desc(sK + st * L::TILE + off, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
    };
    // O += P V from pf: one wgmma group
    auto issue_pv = [&](int st) {
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HDP>(o, pf[kk],
                      wgmma_desc(sV + st * L::TILE + kk * 16 * 128, REGION,
                                 1024));
      wgmma_commit();
    };
    // online softmax of key tile kt on s (s[4j + e] is (r_a, k0 + 8j + c2
    // + e), s[4j + 2 + e] is (r_b, the same key)): s becomes p, m and l
    // move on, and the output's corrections come back
    auto softmax = [&](int kt, float& corr_a, float& corr_b) {
      const int k0 = kt * BK;
      const bool masked = k0 + BK > sk ||
                          (causal && k0 + BK - 1 > my_first) ||
                          (window > 0 && k0 <= my_last - window);
      float mx_a = NEG_INF_SCORE, mx_b = NEG_INF_SCORE;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xa = s[4 * j + e] * scale_log2;
          float xb = s[4 * j + 2 + e] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + c2 + e;
            bool va = key < sk, vb = key < sk;
            if (causal) { va = va && key <= r_a; vb = vb && key <= r_b; }
            if (window > 0) {
              va = va && key > r_a - window;
              vb = vb && key > r_b - window;
            }
            if (!va) xa = NEG_INF_SCORE;
            if (!vb) xb = NEG_INF_SCORE;
          }
          s[4 * j + e] = xa;
          s[4 * j + 2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      corr_a = fast_exp2(m_a - mn_a);
      corr_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xa = s[4 * j + e], xb = s[4 * j + 2 + e];
          float pa = fast_exp2(xa - mn_a), pb = fast_exp2(xb - mn_b);
          if (masked) {
            if (xa == NEG_INF_SCORE) pa = 0.f;
            if (xb == NEG_INF_SCORE) pb = 0.f;
          }
          s[4 * j + e] = pa;
          s[4 * j + 2 + e] = pb;
          sum_a += pa;
          sum_b += pb;
        }
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
    };
    // O *= corrections, then P (s) to the bf16 A fragments of P V
    auto rescale_pack = [&](float corr_a, float corr_b) {
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        o[4 * j] *= corr_a;
        o[4 * j + 1] *= corr_a;
        o[4 * j + 2] *= corr_b;
        o[4 * j + 3] *= corr_b;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Tiles of the block's band outside this warpgroup's are handed back
    // unread.  With three or more stages (HDP <= 192) the products of S
    // for tile i and of P V for tile i - 1 run while this warpgroup does
    // the softmax of tile i, and stage i - 1 is handed back after it; with
    // two (HDP = 256) that would leave no load in flight, so each tile's
    // products are waited for in turn.
    mbar_wait(qbar, 0);
    const int i_first = max(my_begin - kt_begin, 0);
    const int i_end = min(my_end - kt_begin, n_tiles);
    int i = 0;
    for (; i < n_tiles && i < i_first; ++i) {
      mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
      mbar_arrive(empty + 8 * (i % STAGES));
    }
    float corr_a, corr_b;
    if constexpr (STAGES >= 3) {
      if (i < i_end) {
        mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
        issue_qk(i % STAGES);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(kt_begin + i, corr_a, corr_b);
        rescale_pack(corr_a, corr_b);
        for (++i; i < i_end; ++i) {
          const int st = i % STAGES, prev = (i - 1) % STAGES;
          mbar_wait(full + 8 * st, (i / STAGES) & 1);
          issue_qk(st);
          issue_pv(prev);
          wgmma_wait<1>();  // S of tile i is in
          fence_regs(s);
          softmax(kt_begin + i, corr_a, corr_b);
          wgmma_wait<0>();  // P V of tile i - 1 is in
          fence_regs(o);
          mbar_arrive(empty + 8 * prev);
          rescale_pack(corr_a, corr_b);
        }
        issue_pv((i - 1) % STAGES);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + 8 * ((i - 1) % STAGES));
      }
    } else {
      for (; i < i_end; ++i) {
        const int st = i % STAGES;
        mbar_wait(full + 8 * st, (i / STAGES) & 1);
        issue_qk(st);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(kt_begin + i, corr_a, corr_b);
        rescale_pack(corr_a, corr_b);
        issue_pv(st);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty + 8 * st);
      }
    }
    for (; i < n_tiles; ++i) {
      mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
      mbar_arrive(empty + 8 * (i % STAGES));
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    bf16* ob = out + b * os.b + head * os.h;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col < hd) {
        if (r_a < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r_a * os.s + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (r_b < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r_b * os.s + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                    o[4 * j + 3] * inv_b);
      }
    }
  }
}

// -- host side -----------------------------------------------------------------

// A rank-4 map of a (B, S, H, hd) bf16 tensor (dims listed innermost
// first) with boxes of 64 head-dim columns x 1 head x 64 rows x 1 batch row
// under the 128-byte swizzle; boxes past hd, S, H or B read as zeros.
static int make_map(CUtensorMap* map, const void* ptr, int bsz, int seq,
                    int heads, int hd, long long sb, long long ss,
                    long long sh) {
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)bsz};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
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
static int launch(const void* q, const void* k, const void* v, bf16* out,
                  Strides qs, Strides ks, Strides vs, Strides os, int bsz,
                  int h, int hkv, int sq, int sk, int hd, int causal,
                  int window, float scale_log2, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, bsz, sq, h, hd, qs.b, qs.s, qs.h);
  if (!err) err = make_map(&kmap, k, bsz, sk, hkv, hd, ks.b, ks.s, ks.h);
  if (!err) err = make_map(&vmap, v, bsz, sk, hkv, hd, vs.b, vs.s, vs.h);
  if (err) return err;
  const int smem = Layout<HDP>::BYTES;
  static bool attr_set = false;  // once per head-dim variant
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((sq + BM - 1) / BM, h, bsz);
  flash_sm90_kernel<HDP><<<grid, THREADS, smem, st>>>(
      qmap, kmap, vmap, out, os, h, hkv, sq, sk, hd, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

// Returns 0, a cudaError_t, or ERR_ENCODE + a CUresult.  Strides are in
// elements, (batch, sequence, head) for each of q, k, v and out.  The
// caller checks shapes, dtypes and alignment (h % hkv == 0, hd % 8 == 0, 8
// <= hd <= 256, h, bsz <= 65535, sq >= 1, strides positive multiples of 8,
// bases 16-byte aligned).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, int bsz, int h, int hkv, int sq, int sk, int hd,
    int causal, int window, double scale, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || hkv <= 0 || h % hkv != 0 ||
      sq <= 0 || bsz <= 0 || bsz > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const float sl2 = (float)(scale * 1.4426950408889634);  // scale * log2(e)
  cudaStream_t st = (cudaStream_t)stream;
  bf16* op = (bf16*)out;
  if (hd <= 64)
    return launch<64>(q, k, v, op, qs, ks, vs, os, bsz, h, hkv, sq, sk, hd,
                      causal, window, sl2, st);
  if (hd <= 128)
    return launch<128>(q, k, v, op, qs, ks, vs, os, bsz, h, hkv, sq, sk, hd,
                       causal, window, sl2, st);
  if (hd <= 192)
    return launch<192>(q, k, v, op, qs, ks, vs, os, bsz, h, hkv, sq, sk, hd,
                       causal, window, sl2, st);
  return launch<256>(q, k, v, op, qs, ks, vs, os, bsz, h, hkv, sq, sk, hd,
                     causal, window, sl2, st);
}
