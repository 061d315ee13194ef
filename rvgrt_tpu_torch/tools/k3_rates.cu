// Issue rates of the integer and float instructions K3's offset loop can be
// built from, on the card it runs on (k3_sweep.py --rates).
//
// Each thread runs 8 independent chains of one operation for `iters`
// iterations; the grid holds many blocks per SM, so the chains' latency is
// hidden and the time measures issue.  rvgrt_rate(kind, ...) launches the
// probe of one kind; the caller times it and counts 8 x iters operations a
// thread (a packed u16x2 operation counts once, for its two halves).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int kKind>
__device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b, uint32_t c) {
  if (kKind == 0) return __viaddmin_u16x2(a, b, c);      // K3's add-and-min
  if (kKind == 1) return __vminu2(a, c);                 // K3's pair min
  if (kKind == 2) return min(a + b, c);                  // 32-bit add, min
  if (kKind == 3) return min(a, c);                      // 32-bit min
  const float f = fminf(__uint_as_float(a) + __uint_as_float(b),
                        __uint_as_float(c));             // float add, min
  return __float_as_uint(f);
}

template <int kKind>
__global__ void rate_kernel(uint32_t* out, int iters, uint32_t seed) {
  uint32_t x[8];
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (t * 2654435761u) ^ (seed + i);
  const uint32_t b = seed | 1u;
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = op<kKind>(x[i], b, x[(i + 1) & 7]);
  }
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r ^= x[i];
  if (r == seed) out[t] = r;  // keeps the chains live
}

}  // namespace

extern "C" int rvgrt_rate(int kind, void* out, int blocks, int threads,
                          int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  switch (kind) {
    case 0: rate_kernel<0><<<blocks, threads, 0, s>>>(o, iters, 7u); break;
    case 1: rate_kernel<1><<<blocks, threads, 0, s>>>(o, iters, 7u); break;
    case 2: rate_kernel<2><<<blocks, threads, 0, s>>>(o, iters, 7u); break;
    case 3: rate_kernel<3><<<blocks, threads, 0, s>>>(o, iters, 7u); break;
    case 4: rate_kernel<4><<<blocks, threads, 0, s>>>(o, iters, 7u); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
