// The step's stage stamps: a one-thread kernel that writes the card's
// %globaltimer (nanoseconds) into one int64 slot, bound to Python through
// the plain C launcher at the bottom (lpr_tpu_torch/kernels/stamp.py loads
// it with ctypes).
//
// The frozen step launches one between each pair of its device stages
// while its CUDA graph is captured, so every replay writes the time at
// which each stage's last kernel had finished (the stream runs them in
// order).  In a CUPTI trace the same kernels split each replay into its
// stages.  A launch is a few microseconds of device time; a step holds
// ten of them.

#include <cuda_runtime.h>

__global__ void stamp_kernel(long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = (long long)t;
}

// Launches one stamp into `slot` (a device pointer to one int64) on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int lpr_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)slot);
  return (int)cudaGetLastError();
}
