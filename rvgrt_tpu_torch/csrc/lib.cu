// Shared C entry points of the kernel library (see ops/_lib.py).
#include <cuda_runtime.h>

extern "C" const char* rvgrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The card's memory limits that bound a kernel's working set, in bytes:
// out[0] shared memory a block may opt in to, out[1] the L2 cache, out[2]
// the most of L2 that may be set aside for persisting accesses, out[3] the
// largest access-policy window a stream may set.
extern "C" int rvgrt_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrL2CacheSize,
      cudaDevAttrMaxPersistingL2CacheSize,
      cudaDevAttrMaxAccessPolicyWindowSize};
  for (int k = 0; k < 4; ++k) {
    const cudaError_t err = cudaDeviceGetAttribute(out + k, attrs[k], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
