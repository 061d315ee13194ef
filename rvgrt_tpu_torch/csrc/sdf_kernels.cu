// K3: the SDF min-plus distance pass along one axis of a uint8 volume.
//
// Replaces the Pallas kernel rvgrt_tpu/ops/sdf_kernels.py::minconv_pass_pallas
// (body _minconv_kernel, pl.pallas_call in minconv_axis1).  For a volume
// viewed as (outer, n, inner) with the pass running along the middle axis:
//
//   out[o, y, x] = min(cap, isqrt(min over off in [0, cap] of
//                                 min(d[y - off], d[y + off])^2 + off^2))
//
// with d = 255 outside [0, n) (255^2 loses to every real candidate) and the
// integer fix-up after sqrt.  Axis 1 of a (Z, Y, X) volume is
// (outer=Z, n=Y, inner=X); axis 0 is (outer=1, n=Z, inner=Y*X): the same
// kernel reads rows of the same strip, so no transpose is needed.
//
// What bounds it on the H100: integer operations.  Each output costs cap
// offset pairs x 3 int32 ops (pair min, multiply-add, running min); at the
// 1024^3 world the volume is 512^3 cells with cap 64, about 2.6e10 ops a
// pass, against 0.27 GB of bytes to move (one u8 read, one u8 write).
// Design: one block per (outer, inner strip); the block stages the strip's
// (n + 2 cap) rows once in shared memory (u8, coalesced row loads), so every
// one of the 2 cap + 1 taps of every output is a shared-memory read; all
// arithmetic is int32 in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void minconv_mid_kernel(const uint8_t* __restrict__ in,
                                   uint8_t* __restrict__ out, int n,
                                   long long inner, int cap, int strip) {
  extern __shared__ uint8_t col[];  // (n + 2 cap) rows x strip columns
  const long long x0 = (long long)blockIdx.x * strip;
  const int w = (int)((inner - x0) < strip ? (inner - x0) : strip);
  const long long base = (long long)blockIdx.y * n * inner + x0;
  const int rows = n + 2 * cap;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows * strip;
       i += nthreads) {
    const int r = i / strip;
    const int c = i - r * strip;
    const int y = r - cap;
    uint8_t v = 255;
    if (c < w && y >= 0 && y < n) v = in[base + (long long)y * inner + c];
    col[i] = v;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= w) return;
  for (int y = threadIdx.y; y < n; y += blockDim.y) {
    const uint8_t* p = col + (y + cap) * strip + c;
    const int d0 = p[0];
    int acc = d0 * d0;
    for (int off = 1; off <= cap; ++off) {
      const int lo = p[-off * strip];
      const int hi = p[off * strip];
      const int m = lo < hi ? lo : hi;
      const int cand = m * m + off * off;
      acc = cand < acc ? cand : acc;
    }
    // floor(sqrt) with the integer fix-up of the reference passes
    int d = (int)sqrtf((float)acc);
    if (d * d > acc) d -= 1;
    if ((d + 1) * (d + 1) <= acc) d += 1;
    out[base + (long long)y * inner + c] = (uint8_t)(d < cap ? d : cap);
  }
}

}  // namespace

// Shared memory a strip may use: two blocks per SM still fit.
static const int kSmemBudget = 96 * 1024;

extern "C" int rvgrt_minconv_mid(const void* in, void* out, int outer, int n,
                                 long long inner, int cap, void* stream) {
  const int rows = n + 2 * cap;
  int strip = 128;
  while (strip > 32 && rows * strip > kSmemBudget) strip /= 2;
  while (strip > 1 && strip / 2 >= inner) strip /= 2;
  const size_t smem = (size_t)rows * strip;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        minconv_mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ty = 512 / strip < 8 ? 512 / strip : 8;
  dim3 block(strip, ty > 0 ? ty : 1);
  dim3 grid((unsigned)((inner + strip - 1) / strip), (unsigned)outer);
  minconv_mid_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, n, inner, cap, strip);
  return (int)cudaGetLastError();
}
