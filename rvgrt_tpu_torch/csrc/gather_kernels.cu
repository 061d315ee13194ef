// P1 and P2: the gather probe's two kernels (a flat clamped take and a
// per-column take_along_axis) from a u32 table in device memory.
//
// P1 replaces the Pallas kernel scripts/probe_r7.py::pallas_take:
//   out[i] = tbl[clamp(idx[i], 0, n - 1)]       (jnp.take, mode="clip")
// P2 replaces scripts/probe_r7.py::pallas_tala:
//   out[r, c] = t2[i2[r, c], c]                 (jnp.take_along_axis, axis 0)
// with jnp.take_along_axis's own handling of an index outside [0, S): a
// negative index counts from the end once (i + S), and one still outside
// gives the fill word of its default "fill" mode, 0xFFFFFFFF for u32.
//
// The TPU kernels held the whole table in VMEM, the core's fast scratch
// memory, to ask whether a gather from it beats XLA's gather from HBM.
// Hopper has no such software-managed level of tens of MB: a block's
// shared memory is at most 227 KB, so a table of 2-100 MB is gathered from
// device memory, through the 50 MB L2, which keeps a table up to about its
// size resident across the launch.
//
// What bounds them on the H100: bytes.  A lane reads its 4 B index and
// writes its 4 B word, both coalesced; each distinct 32 B sector of the
// table that the indices touch is read once from HBM (a random word costs a
// whole sector).  Design: one thread per lane, neighbouring threads on
// neighbouring lanes; the table word is read through the read-only path
// (__ldg); no shared memory, since a random gather has no reuse to stage.
//
// rvgrt_take_clip_l2 is the probe's question asked of L2 directly: the same
// kernel, launched with an access-policy window over the table, so that up
// to the card's persisting share of L2 keeps table lines across launches
// (rvgrt_set_persisting_l2 sets that share; 0 gives it back and clears the
// persisting lines).  It is a measurement, not on any path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void take_clip_kernel(const uint32_t* __restrict__ tbl,
                                 long long n, const int* __restrict__ idx,
                                 uint32_t* __restrict__ out, long long lanes) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= lanes) return;
  long long j = idx[i];
  j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
  out[i] = __ldg(tbl + j);
}

__global__ void take_along_cols_kernel(const uint32_t* __restrict__ t2,
                                       int rows, int cols,
                                       const int* __restrict__ i2,
                                       uint32_t* __restrict__ out,
                                       long long lanes) {
  const long long e = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (e >= lanes) return;
  const int c = (int)(e % cols);
  int r = i2[e];
  if (r < 0) r += rows;
  out[e] = (r >= 0 && r < rows) ? __ldg(t2 + (long long)r * cols + c)
                                : 0xFFFFFFFFu;
}

unsigned grid_for(long long lanes) {
  return (unsigned)((lanes + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" int rvgrt_take_clip(const void* tbl, long long n, const void* idx,
                               void* out, long long lanes, void* stream) {
  if (lanes <= 0) return 0;
  take_clip_kernel<<<grid_for(lanes), kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tbl, n, (const int*)idx, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int rvgrt_take_along_cols(const void* t2, int rows, int cols,
                                     const void* i2, void* out,
                                     long long lanes, void* stream) {
  if (lanes <= 0) return 0;
  take_along_cols_kernel<<<grid_for(lanes), kBlock, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)t2, rows, cols, (const int*)i2, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int rvgrt_take_clip_l2(const void* tbl, long long n,
                                  const void* idx, void* out,
                                  long long lanes, long long window_bytes,
                                  float hit_ratio, void* stream) {
  if (lanes <= 0) return 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow.base_ptr = const_cast<void*>(tbl);
  attr[0].val.accessPolicyWindow.num_bytes = (size_t)window_bytes;
  attr[0].val.accessPolicyWindow.hitRatio = hit_ratio;
  attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_for(lanes));
  cfg.blockDim = dim3(kBlock);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, take_clip_kernel, (const uint32_t*)tbl, n, (const int*)idx,
      (uint32_t*)out, lanes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int rvgrt_set_persisting_l2(long long bytes) {
  cudaError_t err =
      cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)bytes);
  if (err == cudaSuccess && bytes == 0) {
    err = cudaCtxResetPersistingL2Cache();
  }
  return (int)err;
}
