// One-tile copy kernel that proves the toolchain builds and the card runs
// a kernel of this library.
//
// Replaces the Pallas probe in src/repro/compat.py (pallas_interpret_works,
// a (8, 128) float32 copy through pl.pallas_call). Here it is launched once
// by chip_smoke.py after the build; it never picks a tier, since the device
// of the tensors does that. Bound by launch latency: it moves 8 KB.
#include <cuda_runtime.h>

namespace {

__global__ void copy_kernel(const float* __restrict__ src,
                            float* __restrict__ dst, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_copy_probe_f32(const void* src, void* dst, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  copy_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}
