// An empty kernel, launched through the same ctypes route as the port's
// kernels: its call and device time are what one launch costs on the
// card, the floor beneath every kernel whose work is smaller than that
// (minskew and hub_route at the engine's shapes).  chip_smoke.py and
// tools/engine_kernels.py time it; no path of the port launches it.
#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
