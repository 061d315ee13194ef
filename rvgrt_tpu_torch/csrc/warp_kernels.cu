// K2: exact 4-tap bilinear warp of the packed RGBN temporal history.
//
// Replaces the Pallas kernel rvgrt_tpu/ops/warp_kernels.py::
// warp_packed_bilinear (body _warp_kernel, pl.pallas_call in
// warp_packed_bilinear).  For every output pixel, gather the four u32 RGBN
// words around the f32 source coordinate (xs, ys) - the +1 taps clamped to
// the last row/column - unpack each byte to f32 and blend with the bilinear
// weights, in the TPU kernel's order:
//
//   out[k] = w00*p00[k] + w01*p01[k] + w10*p10[k] + w11*p11[k]
//
// giving 4 f32 planes [r, g, b, n].  The TPU kernel DMA'd a per-tile window
// of the history and counted the lanes whose taps fell outside it; both
// were workarounds for Mosaic, which cannot lower a gather.  Here every
// thread gathers its taps directly from device memory, so nothing can fall
// outside a window and the overflow count the wrapper returns is always 0.
//
// What bounds it on the H100: bytes.  At the main path's 2400 x 3840
// history a call reads xs, ys and the history (3 x 36.9 MB; neighbouring
// outputs share their taps, so the gathers mostly hit L2) and writes the
// four planes (147 MB), ~0.26 GB in all.  Design: one thread per output
// pixel, consecutive threads on consecutive pixels, so the coordinate loads
// and plane stores coalesce; no shared memory - the motion field is smooth,
// so a warp's taps fall in a few neighbouring history rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32(1/255), the constant of the reference unpack
__device__ __forceinline__ float unpack_byte(uint32_t w, int sh) {
  return (float)(int)((w >> sh) & 0xFFu) * 0x1.010102p-8f;
}

__global__ void warp_kernel(const uint32_t* __restrict__ packed,
                            const float* __restrict__ xs,
                            const float* __restrict__ ys,
                            float* __restrict__ out, int hh, int hw,
                            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = xs[i];
  const float y = ys[i];
  int x0 = (int)floorf(x);
  int y0 = (int)floorf(y);
  const float fx = x - (float)x0;
  const float fy = y - (float)y0;
  // callers clip the coordinates into the history; clamp the taps anyway
  // so no address can leave the buffer
  x0 = x0 < 0 ? 0 : (x0 > hw - 1 ? hw - 1 : x0);
  y0 = y0 < 0 ? 0 : (y0 > hh - 1 ? hh - 1 : y0);
  const int x1 = x0 + 1 < hw - 1 ? x0 + 1 : hw - 1;
  const int y1 = y0 + 1 < hh - 1 ? y0 + 1 : hh - 1;
  const uint32_t v00 = packed[(long long)y0 * hw + x0];
  const uint32_t v01 = packed[(long long)y0 * hw + x1];
  const uint32_t v10 = packed[(long long)y1 * hw + x0];
  const uint32_t v11 = packed[(long long)y1 * hw + x1];
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int sh = 8 * k;
    out[k * n + i] = w00 * unpack_byte(v00, sh) + w01 * unpack_byte(v01, sh) +
                     w10 * unpack_byte(v10, sh) + w11 * unpack_byte(v11, sh);
  }
}

}  // namespace

extern "C" int rvgrt_warp_bilinear(const void* packed, const void* xs,
                                   const void* ys, void* out, int hh, int hw,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  warp_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const float*)xs, (const float*)ys,
      (float*)out, hh, hw, n);
  return (int)cudaGetLastError();
}
