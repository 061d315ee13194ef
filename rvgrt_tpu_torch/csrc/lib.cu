// Shared C entry points of the kernel library (see ops/_lib.py).
#include <cuda_runtime.h>

extern "C" const char* rvgrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
