// Shared-memory poison: fill every SM's shared memory with NaN bytes.
//
// A check kernel, not a port of a TPU kernel. Launched just before a
// flash or decode kernel, it leaves each SM's shared memory holding
// 0x7FC0 words (a NaN in bf16, and as word pairs a NaN in f32), so a
// consumer that reads a tile before its TMA or cp.async bytes land reads
// NaN instead of the bytes an earlier launch on the same inputs left
// there. The grid is the occupancy limit at the given dynamic
// shared-memory size times the SM count, so every SM runs blocks of
// that size.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void smem_poison_kernel(int words) {
  extern __shared__ uint32_t smem[];
  volatile uint32_t* s = smem;  // stores no later load reads: keep them
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = 0x7FC07FC0u;
  __syncthreads();
}

extern "C" const char* k8s_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int k8s_smem_poison(int smem_bytes, cudaStream_t stream) {
  const int threads = 256;
  cudaError_t err = cudaFuncSetAttribute(
      smem_poison_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, smem_poison_kernel, threads, smem_bytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) per_sm = 1;
  smem_poison_kernel<<<sms * per_sm, threads, smem_bytes, stream>>>(smem_bytes / 4);
  return cudaGetLastError();
}

// The largest dynamic shared memory one block of this device may opt in
// to (bytes): poisoning at this size covers an SM's whole shared memory.
extern "C" int k8s_smem_poison_max_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess) return -1;
  return bytes;
}
