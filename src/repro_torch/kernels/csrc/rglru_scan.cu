// RG-LRU linear recurrence for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (_kernel, wrapper rglru_scan).  For log_a, b (B, S, W) and h0 (B, W),
// all float32 and contiguous:
//   h[b, t, w] = exp(log_a[b, t, w]) * h[b, t-1, w] + b[b, t, w],
//   h[b, -1, w] = h0[b, w].
//
// Design.  One thread per channel (b, w), looping over t with h in a
// register.  Neighbouring threads own neighbouring w, so every load of
// log_a and b and every store of h is coalesced along W.  The loads do
// not depend on h, so the loop is unrolled by UNROLL steps: the loads of
// a group are issued before its chain of fused multiply-adds, which keeps
// UNROLL loads per array in flight for each thread.  The TPU kernel's
// log-depth doubling inside a VMEM block is a TPU adaptation (its VPU
// has no cheap serial loop); a chunked two-level scan over S, as in
// hub_route.cu, would add blocks along S and is later work.
//
// Bound on the H100: bytes.  The function reads log_a and b and writes h
// once, 12 bytes per element: at the serving shape (B=4, S=3,072,
// W=4,096) 604 MB, 0.180 ms at 3.35 TB/s, against 2 operations per
// element.  B * W = 16,384 threads (128 blocks of 128) is about one
// thread per FP32 lane of 132 SMs, so the kernel depends on having
// enough loads in flight per thread to cover the memory latency.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define UNROLL 8

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, int bsz,
             int s, int w) {
  const int64_t ch = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (ch >= (int64_t)bsz * w) return;
  const int64_t bi = ch / w, wi = ch % w;
  const int64_t base = bi * (int64_t)s * w + wi;
  const float* la = log_a + base;
  const float* bb = b + base;
  float* o = out + base;
  float h = h0[ch];
  int t = 0;
  for (; t + UNROLL <= s; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = la[(int64_t)(t + u) * w];
      bv[u] = bb[(int64_t)(t + u) * w];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = fmaf(expf(av[u]), h, bv[u]);
      o[(int64_t)(t + u) * w] = h;
    }
  }
  for (; t < s; ++t) {
    h = fmaf(expf(la[(int64_t)t * w]), h, bb[(int64_t)t * w]);
    o[(int64_t)t * w] = h;
  }
}

// Returns 0 or a cudaError_t.  The caller checks dtypes and shapes and
// passes a zero h0 where there is none.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* out, int bsz, int s,
                                 int w, void* stream) {
  if (bsz < 0 || s < 0 || w < 0) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)bsz * w;
  if (n == 0 || s == 0) return 0;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  rglru_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)b, (const float*)h0, (float*)out,
      bsz, s, w);
  return (int)cudaGetLastError();
}
