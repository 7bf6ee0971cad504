// Blockwise (flash) attention for Hopper (sm_90a) in float32 on the CUDA
// cores: the float32 forward's first design, on no route.  float32 calls
// run the split-TF32 tensor-core kernel of flash_attention_tf32x3.cu, and
// bfloat16 the wgmma kernel of flash_attention_sm90.cu;
// repro_torch.kernels.flash_attention._fwd_cuda_cores launches this one for
// tools/flash_fwd_check.py, which times it beside the route.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_kernel, wrapper flash_attention_flat) for float32 inputs.  For q (BH,
// Sq, hd) and k, v (BHkv, Sk, hd), all contiguous, query row b reads kv
// row b / (BH / BHkv), so GQA never replicates K or V in memory:
//   out[b, i] = sum_j p_ij v[b/qpk, j],  p = softmax_j(scale * q_i . k_j)
// over the visible keys j: j < Sk; j <= i when causal (top-left aligned,
// also when Sq != Sk); j > i - window when window > 0.  A row with no
// visible key gives 0.
//
// Design.  One block of 256 threads per (b, tile of BQ = 64 query
// rows).  The block walks the key tiles of BK = 64 keys itself, which
// takes the place of the TPU kernel's sequential key-block grid axis and
// its VMEM scratch: the running max m, denominator l and the output
// accumulator stay in registers across the loop.  A key tile wholly
// outside the causal / window band, or past Sk, is skipped (the TPU
// kernel's band skip, :50-54).  Tiles of q (pre-scaled), K and V live in
// shared memory as float32; K and q rows are padded by one float so the
// score loop reads them without bank conflicts.  Thread t owns rows
// 4 * (t / 16) .. + 3 of the tile, keys (t % 16) + 16 j of each key tile
// (scores), and output columns (t % 16) + 16 c (the accumulator); the 16
// threads of a row group sit in one half-warp, so row max and row sum
// are half-warp shuffles and P reaches the P.V product by shuffles too.
//
// The masked-row trap: masked scores are NEG_INF = -1e30 (not -inf, as in
// the TPU kernel).  While a row has seen no visible key its running max
// is still -1e30, and exp(s - m) would be 1 for its masked scores, so p
// is zeroed wherever the mask is false (the TPU kernel's where(mask, p,
// 0), :77), and the final division is by max(l, 1e-30) (:87).
//
// Bound on the H100.  At the main path's prefill shape (B=4, H=32,
// Hkv=8, S=1024, hd=128, causal) the function needs about 2 B H S^2 hd =
// 34 GFLOP (QK^T and PV over the causal half), 35 us at the bf16 tensor
// core peak, against 42 MB of q, k, v and output, 13 us at 3.35 TB/s: it
// is bound by operations.  This first kernel does those operations as
// float32 FMAs on the CUDA cores, fed from shared memory (about 4 loads
// per 16 FMAs in the score loop), so it is bound by shared-memory issue
// and the float32 rate, far from the tensor-core bound.  A single TF32
// pass on the tensor cores would round the inputs to TF32, which the
// float32 parity runs cannot take; flash_attention_tf32x3.cu keeps float32
// accuracy with three TF32 products of split operands.  It takes
// contiguous flat (BH, S, hd) tensors only.
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define THREADS 256
#define ROWS 4          // query rows per thread
#define KEYS (BK / 16)  // keys per thread and key tile
#define MAX_HD 256
#define MAX_COLS (MAX_HD / 16)
#define NEG_INF_SCORE (-1e30f)
#define FULL 0xffffffffu  // every warp runs the shuffles converged

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

static size_t smem_bytes(int hd) {
  // q: BQ x (hd+1), K: BK x (hd+1), V: BK x hd, all float32
  return sizeof(float) * ((size_t)BQ * (hd + 1) + (size_t)BK * (hd + 1) +
                          (size_t)BK * hd);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int qpk, int sq,
             int sk, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                     // BQ x ld
  float* ks = qs + BQ * ld;             // BK x ld
  float* vs = ks + BK * ld;             // BK x hd

  const int b = blockIdx.x;
  const int q_first = blockIdx.y * BQ;
  const int q_last = q_first + BQ - 1;
  const int t = threadIdx.x;
  const int tr = t / 16;                // row group: rows tr*ROWS ..
  const int tc = t % 16;                // key / column slot
  const T* qb = q + (size_t)b * sq * hd;
  const T* kb = k + (size_t)(b / qpk) * sk * hd;
  const T* vb = v + (size_t)(b / qpk) * sk * hd;

  for (int idx = t; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd;
    const int row = q_first + r;
    qs[r * ld + d] = row < sq ? to_f(qb[(size_t)row * hd + d]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][MAX_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF_SCORE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) acc[i][c] = 0.f;
  }

  const int nk = (sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_first = kt * BK;
    const int k_last = k_first + BK - 1;
    bool run = k_first < sk;
    if (causal) run = run && k_first <= q_last;
    if (window > 0) run = run && k_last > q_first - window;
    if (!run) continue;              // uniform across the block

    __syncthreads();                 // previous tile fully consumed
    for (int idx = t; idx < BK * hd; idx += THREADS) {
      const int r = idx / hd, d = idx % hd;
      const int key = k_first + r;
      float kv = 0.f, vv = 0.f;
      if (key < sk) {
        kv = to_f(kb[(size_t)key * hd + d]);
        vv = to_f(vb[(size_t)key * hd + d]);
      }
      ks[r * ld + d] = kv;
      vs[r * hd + d] = vv;
    }
    __syncthreads();

    // scores s[i][j] for rows tr*ROWS+i, keys tc+16j of this tile
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[ROWS], kv[KEYS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(tr * ROWS + i) * ld + d];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) kv[j] = ks[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KEYS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax per row (the row's 16 threads share a half-warp)
    float p[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_first + tr * ROWS + i;
      float mx = NEG_INF_SCORE;
      bool vis[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int kpos = k_first + tc + 16 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        vis[j] = ok;
        if (!ok) s[i][j] = NEG_INF_SCORE;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        p[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off, 16);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) acc[i][c] *= corr;
    }

    // acc[i][c] += sum over the tile's keys of p[row i][key] * V[key][col c]
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
#pragma unroll 4
      for (int src = 0; src < 16; ++src) {
        const int key = src + 16 * j;
        float pk[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          pk[i] = __shfl_sync(FULL, p[i][j], src, 16);
#pragma unroll
        for (int c = 0; c < MAX_COLS; ++c) {
          const int col = tc + 16 * c;
          if (col < hd) {
            const float vv = vs[key * hd + col];
#pragma unroll
            for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pk[i], vv, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q_first + tr * ROWS + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = out + ((size_t)b * sq + row) * hd;
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      const int col = tc + 16 * c;
      if (col < hd) ob[col] = from_f<T>(acc[i][c] * inv);
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int bh, int bhkv, int sq, int sk, int hd, int causal,
                  int window, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_kernel<T><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, bh / bhkv, sq, sk, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t.  The caller checks shapes (bh % bhkv == 0,
// hd % 8 == 0, 8 <= hd <= 256, bh >= 1, 1 <= ceil(sq / 64) <= 65535).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int bhkv, int sq, int sk, int hd,
                                      int causal, int window, double scale,
                                      void* stream) {
  if (hd <= 0 || hd > MAX_HD || hd % 8 != 0 || bhkv <= 0 || bh % bhkv != 0)
    return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, out, bh, bhkv, sq, sk, hd, causal, window,
                       (float)scale, (cudaStream_t)stream);
}
