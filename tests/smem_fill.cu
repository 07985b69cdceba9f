// A check aid of the `cuda` tests, not a kernel of the port and not built
// into its library: tests/test_torch_kernels_cuda.py compiles this file
// alone with nvcc into its own temporary directory. It fills the shared
// memory of every SM with one 32-bit pattern, so that a kernel launched
// right after it on the same stream meets that pattern wherever it reads
// shared memory it has not written (NaN before the fp32 stream forwards on
// wgmma, whose activation tiles are zeroed at the start, walk_wgmma.cuh
// stream_fwd_wg, and before the fp32 embedder), and reads back how much of
// a fill the next kernel finds. One block of 1,024 threads an SM, each
// taking the most dynamic shared memory a block may, so no SM holds two and
// every SM holds one.

#include <cuda_runtime.h>

__global__ void __launch_bounds__(1024, 1)
smem_fill_kernel(unsigned bits, int words) {
  extern __shared__ unsigned smem_fill_words[];
  volatile unsigned* s = smem_fill_words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = bits;
}

// The same blocks reading what they find: counts[b] += the words of block
// b's shared memory that hold the pattern (whether a fill survives into the
// next kernel).
__global__ void __launch_bounds__(1024, 1)
smem_probe_kernel(unsigned bits, int words, int* counts) {
  extern __shared__ unsigned smem_fill_words[];
  const volatile unsigned* s = smem_fill_words;
  int n = 0;
  for (int i = threadIdx.x; i < words; i += blockDim.x) n += s[i] == bits;
  atomicAdd(&counts[blockIdx.x], n);
}

// The launch shape of both: one block an SM, the most shared memory a block
// may take.
static cudaError_t smem_shape(const void* kernel, int* sms, int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *bytes);
  return e;
}

// The 32-bit words a block of either kernel covers (the most shared memory
// a block may take, over 4), or a negative CUDA error.
extern "C" int papr_smem_words() {
  int sms = 0, bytes = 0;
  cudaError_t e = smem_shape((const void*)smem_fill_kernel, &sms, &bytes);
  return e == cudaSuccess ? bytes / 4 : -(int)e;
}

// bits: the pattern (0x7fc00000: a quiet NaN); returns cudaGetLastError().
extern "C" int papr_smem_fill(int bits, void* stream) {
  int sms = 0, bytes = 0;
  cudaError_t e = smem_shape((const void*)smem_fill_kernel, &sms, &bytes);
  if (e != cudaSuccess) return (int)e;
  smem_fill_kernel<<<sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
      (unsigned)bits, bytes / 4);
  return (int)cudaGetLastError();
}

// counts: one zeroed int32 an SM (the device's multiprocessor count).
extern "C" int papr_smem_probe(int bits, void* counts, void* stream) {
  int sms = 0, bytes = 0;
  cudaError_t e = smem_shape((const void*)smem_probe_kernel, &sms, &bytes);
  if (e != cudaSuccess) return (int)e;
  smem_probe_kernel<<<sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
      (unsigned)bits, bytes / 4, static_cast<int*>(counts));
  return (int)cudaGetLastError();
}
