// P1 and P2: the gather probe's two kernels (a flat clamped take and a
// per-column take_along_axis) from a u32 table.
//
// P1 replaces the Pallas kernel scripts/probe_r7.py::pallas_take:
//   out[i] = tbl[clamp(idx[i], 0, n - 1)]       (jnp.take, mode="clip")
// P2 replaces scripts/probe_r7.py::pallas_tala:
//   out[r, c] = t2[i2[r, c], c]                 (jnp.take_along_axis, axis 0)
// with jnp.take_along_axis's own handling of an index outside [0, S): a
// negative index counts from the end once (i + S), and one still outside
// gives the fill word of its default "fill" mode, 0xFFFFFFFF for u32.
//
// What bounds them on the H100 (tools/probe_r7.py; PERF.md).  A lane reads
// a 4 B index and writes a 4 B word, both streams coalesced; its table word
// is random, and the card moves a whole 32 B sector for it.  Tables of 2-8
// MiB stay in the 50 MB L2 from call to call: there a call of 1M lanes
// takes about 4 us for the launch and the 8 MB of streams, and the random
// words come at about 160 G a second, the rate at which L1 and L2 serve
// random sectors (5 TB/s of 32 B sectors for 4 MB of words); one lane a
// thread and torch.take meet the same rate.  From 32 MiB up the table
// outgrows L2 (or shares it with the streams), and each distinct sector
// the indices touch is a random 32 B read from HBM, about 32 G a second at
// 100 MiB: the byte bound counts those sectors.
//
// Design, one templated body (gather_body) for both kernels; P2 is P1 with
// the address r * cols + c and its wrap-and-fill rule:
// - Each thread owns kV = 4 consecutive lanes: one 16 B index load, all
//   four table loads issued before any is used, one 16 B store.  In P2 a
//   thread's lanes lie in one row of i2 (the wrapper takes this path only
//   when cols % 4 == 0), so their columns are c0 .. c0 + 3: no lane divides.
//   Of 1, 4, 8 and 16 on the H100 (tools/gather_sweep.py), kV = 4 is the
//   fastest at 2-8 MiB and level with one lane a thread above; 8 and 16
//   are slower: the random-sector rate of L1 and L2 sets the time, not the
//   latency of a load, so more loads a thread buy nothing.
// - Persistent: the grid is the SM count times the blocks an SM holds
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, read once by the
//   wrapper through rvgrt_gather_limits), capped at the groups there are; a
//   thread strides over groups and loads the next group's indices before it
//   stores the current group's words.
// - L2 cache-policy hints (bits of `hints`, picked apart by the probe's
//   ablation): kStream reads indices and writes words evict-first
//   (__ldcs / __stcs), so the two 4 MB streams of each call do not push
//   table lines out; kKeep reads table words with
//   ld.global.nc.L1::no_allocate.L2::cache_hint under a
//   createpolicy.fractional.L2::evict_last policy, so L2 would keep them
//   before the streams and L1 allocate no line for a word used once.
//   Without kKeep the word is read through __ldg.  On the H100 kStream
//   gains about 6 % at 32 MiB, and kKeep nothing at 2-32 MiB and a 3-4 %
//   loss at 64-100 MiB, where the table cannot stay: the wrapper passes
//   kStream alone.
// - A scalar loop in the same kernel takes what the vector path does not:
//   the ragged tail (lanes % 4), and every lane when cols % 4 != 0 or the
//   indices or words are not 16 B aligned (a view at an offset).  No copy
//   is made.  The wrapper decides (ops/gather_kernels.py::launch_plan).
// - Offsets into the table are 64-bit (r * cols passes 2^31 at large S).
//
// The on-chip variant (gather_cluster_kernel) asks the TPU probe's question
// of Hopper's on-chip memory.  A table that fits the shared memory of a
// 16-CTA cluster (16 x 227 KB = 3.55 MiB; the 2 MiB rung) is cut into 16
// slices of a whole number of 16 B units; each CTA copies its slice into
// its own shared memory with one 1D bulk asynchronous copy (TMA's form
// without a tensor map, cp.async.bulk, completing on an mbarrier; the last
// 1-3 words of an odd-sized table by plain loads), the cluster syncs, and
// each lane reads its word from the owning CTA with mapa +
// ld.shared::cluster: 4 B a word over the SM-to-SM network, the table read
// from L2 once a cluster, against a 32 B sector a word on the L2 path.
// The cluster is non-portable (16 > 8 CTAs), one CTA of 1024 threads an
// SM; a launch the card refuses returns its error.  The same body gathers.
// On the H100 it loses (26 us against 10.6 us at 2 MiB): the set-up alone
// (launch, copies, syncs) takes about 9.5 us, and the network serves remote
// words at about a third of L2's random-sector rate.  So the wrapper reads
// through L2, and the variant is the probe's measurement (on_chip=True).
//
// rvgrt_gather with window_bytes > 0 is the L2 path launched with an
// access-policy window over the table, so that up to the card's persisting
// share of L2 keeps table lines across launches (rvgrt_set_persisting_l2
// sets that share; 0 gives it back and clears the persisting lines).  It is
// a measurement, as the on-chip variant is.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kV = 4;              // lanes a thread owns
constexpr int kBlock = 256;        // threads of a block on the L2 path
constexpr int kClusterSize = 16;   // CTAs of the on-chip variant's cluster
constexpr int kClusterBlock = 1024;  // threads of one of its CTAs
constexpr int kBarrierBytes = 16;  // its mbarrier, before the slice
constexpr int kTake = 0, kTakeAlong = 1;  // P1, P2
constexpr int kStream = 1, kKeep = 2;     // the hints
constexpr int kUnits = kV / 4;             // 16 B index units a thread owns
static_assert(kV % 4 == 0, "a thread's lanes are whole 16 B units");

struct Gather {
  const uint32_t* tbl;
  long long n;        // table words
  int rows, cols;     // P2: the table is (rows, cols)
  const int* idx;
  uint32_t* out;
  long long lanes;
  long long groups;   // kV-lane groups on the vector path
  int slice;          // on chip: table words a CTA holds
};

template <int kHints>
__device__ __forceinline__ int4 load_idx4(const int4* p) {
  if constexpr ((kHints & kStream) != 0) return __ldcs(p);
  return *p;
}

template <int kHints>
__device__ __forceinline__ int load_idx(const int* p) {
  if constexpr ((kHints & kStream) != 0) return __ldcs(p);
  return *p;
}

template <int kHints>
__device__ __forceinline__ void store4(int4* p, int4 v) {
  if constexpr ((kHints & kStream) != 0) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

template <int kHints>
__device__ __forceinline__ void store1(uint32_t* p, uint32_t v) {
  if constexpr ((kHints & kStream) != 0) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// Table words from device memory, through L2.
struct FromGlobal {
  const uint32_t* tbl;
  uint64_t policy;  // createpolicy's L2 policy (kKeep)

  template <int kHints>
  __device__ __forceinline__ uint32_t get(long long j) const {
    if constexpr ((kHints & kKeep) != 0) {
      uint32_t w;
      asm volatile(
          "ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
          : "=r"(w)
          : "l"(tbl + j), "l"(policy));
      return w;
    }
    return __ldg(tbl + j);
  }
};

// Table words from the cluster's shared memory: word j lies in CTA
// j / slice, at j % slice of its slice.
struct FromCluster {
  uint32_t part;   // shared address of this CTA's slice
  uint32_t slice;

  template <int kHints>
  __device__ __forceinline__ uint32_t get(long long j) const {
    const uint32_t jj = (uint32_t)j, rank = jj / slice;
    uint32_t remote, w;
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(remote)
        : "r"(part + 4u * (jj - rank * slice)), "r"(rank));
    asm volatile("ld.shared::cluster.u32 %0, [%1];"
                 : "=r"(w)
                 : "r"(remote)
                 : "memory");
    return w;
  }
};

template <int kKind, int kHints, class Src>
__device__ __forceinline__ uint32_t word(const Gather& a, int i, int c,
                                         const Src& src) {
  if constexpr (kKind == kTake) {
    const long long j = i < 0 ? 0 : (i >= a.n ? a.n - 1 : (long long)i);
    return src.template get<kHints>(j);
  } else {
    const int r = i < 0 ? i + a.rows : i;
    return (r >= 0 && r < a.rows)
               ? src.template get<kHints>((long long)r * a.cols + c)
               : 0xFFFFFFFFu;
  }
}

// Lanes of thread `first` (of `stride` threads): kV-lane groups first,
// then the scalar lanes after a.groups * kV.
template <int kKind, int kHints, class Src>
__device__ __forceinline__ void gather_body(const Gather& a, long long first,
                                            long long stride,
                                            const Src& src) {
  const int4* idx4 = reinterpret_cast<const int4*>(a.idx);
  int4* out4 = reinterpret_cast<int4*>(a.out);
  long long g = first;
  if (g < a.groups) {
    int c0 = 0, step = 0;  // P2: the column of the group's first lane
    if constexpr (kKind == kTakeAlong) {
      c0 = (int)(g * kV % a.cols);
      step = (int)(stride * kV % a.cols);
    }
    int4 iv[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      iv[u] = load_idx4<kHints>(idx4 + kUnits * g + u);
    }
    for (;;) {
      int ix[kV];
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        ix[4 * u] = iv[u].x;
        ix[4 * u + 1] = iv[u].y;
        ix[4 * u + 2] = iv[u].z;
        ix[4 * u + 3] = iv[u].w;
      }
      uint32_t w[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        w[k] = word<kKind, kHints>(a, ix[k], c0 + k, src);
      }
      const long long next = g + stride;
      const bool more = next < a.groups;
      if (more) {  // the next group's indices, in flight beside the words
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          iv[u] = load_idx4<kHints>(idx4 + kUnits * next + u);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        store4<kHints>(out4 + kUnits * g + u,
                       make_int4((int)w[4 * u], (int)w[4 * u + 1],
                                 (int)w[4 * u + 2], (int)w[4 * u + 3]));
      }
      if (!more) break;
      g = next;
      if constexpr (kKind == kTakeAlong) {
        c0 += step;
        if (c0 >= a.cols) c0 -= a.cols;
      }
    }
  }
  for (long long e = a.groups * kV + first; e < a.lanes; e += stride) {
    const int c = kKind == kTakeAlong ? (int)(e % a.cols) : 0;
    store1<kHints>(a.out + e,
                   word<kKind, kHints>(a, load_idx<kHints>(a.idx + e), c,
                                       src));
  }
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

template <int kKind, int kHints>
__global__ void __launch_bounds__(kBlock) gather_kernel(Gather a) {
  FromGlobal src{a.tbl, 0};
  if constexpr ((kHints & kKeep) != 0) src.policy = evict_last_policy();
  gather_body<kKind, kHints>(a, (long long)blockIdx.x * kBlock + threadIdx.x,
                             (long long)gridDim.x * kBlock, src);
}

// Not .aligned: threads arrive from loops of different trip counts.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

template <int kKind>
__global__ void __launch_bounds__(kClusterBlock, 1)
    gather_cluster_kernel(Gather a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t part = bar + kBarrierBytes;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + kBarrierBytes);
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const long long begin = (long long)rank * a.slice;
  const long long left = a.n - begin;
  const int mine = left <= 0 ? 0 : (left < a.slice ? (int)left : a.slice);
  const uint32_t bulk = (uint32_t)(mine / 4) * 16u;  // whole 16 B units
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bulk > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(bulk)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(part),
          "l"(a.tbl + begin), "r"(bulk), "r"(bar)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                   : "memory");
    }
  }
  for (int k = mine / 4 * 4 + threadIdx.x; k < mine; k += kClusterBlock) {
    words[k] = a.tbl[begin + k];  // the 1-3 words after the last unit
  }
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bar)
      : "memory");
  cluster_sync();  // every slice is in place
  gather_body<kKind, kStream>(
      a, (long long)blockIdx.x * kClusterBlock + threadIdx.x,
      (long long)gridDim.x * kClusterBlock,
      FromCluster{part, (uint32_t)a.slice});
  cluster_sync();  // no CTA leaves while another reads its slice
}

using Kernel = void (*)(Gather);

template <int kKind>
Kernel l2_kernel(int hints) {
  switch (hints) {
    case 0: return gather_kernel<kKind, 0>;
    case kStream: return gather_kernel<kKind, kStream>;
    case kKeep: return gather_kernel<kKind, kKeep>;
    default: return gather_kernel<kKind, kStream | kKeep>;
  }
}

Kernel l2_kernel(int kind, int hints) {
  return kind == kTake ? l2_kernel<kTake>(hints) : l2_kernel<kTakeAlong>(hints);
}

Kernel cluster_kernel(int kind) {
  return kind == kTake ? gather_cluster_kernel<kTake>
                       : gather_cluster_kernel<kTakeAlong>;
}

// Lets the cluster kernel have a non-portable cluster and `bytes` of
// dynamic shared memory (once for the largest size asked so far).
cudaError_t allow_cluster(int kind, size_t bytes) {
  static size_t allowed[2] = {0, 0};
  if (bytes <= allowed[kind]) return cudaSuccess;
  const Kernel fn = cluster_kernel(kind);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (err == cudaSuccess) allowed[kind] = bytes;
  return err;
}

cudaLaunchConfig_t cluster_config(int clusters, size_t bytes,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterSize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kClusterSize);
  cfg.blockDim = dim3(kClusterBlock);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

Gather make_gather(const void* tbl, long long n, int cols, const void* idx,
                   void* out, long long lanes, long long groups, int slice) {
  Gather a;
  a.tbl = (const uint32_t*)tbl;
  a.n = n;
  a.cols = cols > 0 ? cols : 1;
  a.rows = (int)(n / a.cols);
  a.idx = (const int*)idx;
  a.out = (uint32_t*)out;
  a.lanes = lanes;
  a.groups = groups;
  a.slice = slice;
  return a;
}

bool valid(int kind, long long n, int cols, long long lanes,
           long long groups) {
  return (kind == kTake || kind == kTakeAlong) && n > 0 && groups >= 0 &&
         groups * kV <= lanes && (kind == kTake || cols > 0);
}

}  // namespace

// The L2 path: `kind` 0 is P1 over an n-word table, 1 is P2 over an
// (n / cols, cols) one; `groups` kV-lane groups on the vector path, the
// rest of the lanes scalar; `grid` blocks of kBlock threads; `hints` bits
// kStream | kKeep; window_bytes > 0 adds an access-policy window over the
// table's first window_bytes, hit_ratio of it persisting.
extern "C" int rvgrt_gather(int kind, const void* tbl, long long n, int cols,
                            const void* idx, void* out, long long lanes,
                            long long groups, int grid, int hints,
                            long long window_bytes, float hit_ratio,
                            void* stream) {
  if (lanes <= 0) return 0;
  if (!valid(kind, n, cols, lanes, groups) || grid < 1 || hints < 0 ||
      hints > (kStream | kKeep)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBlock);
  cfg.stream = (cudaStream_t)stream;
  if (window_bytes > 0) {
    attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
    attr[0].val.accessPolicyWindow.base_ptr = const_cast<void*>(tbl);
    attr[0].val.accessPolicyWindow.num_bytes = (size_t)window_bytes;
    attr[0].val.accessPolicyWindow.hitRatio = hit_ratio;
    attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, l2_kernel(kind, hints),
      make_gather(tbl, n, cols, idx, out, lanes, groups, 0));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The on-chip variant: `clusters` clusters of kClusterSize CTAs, each CTA
// holding `slice` table words (a multiple of 4); the table's address must
// be 16 B aligned.
extern "C" int rvgrt_gather_cluster(int kind, const void* tbl, long long n,
                                    int cols, const void* idx, void* out,
                                    long long lanes, long long groups,
                                    int clusters, int slice, void* stream) {
  if (lanes <= 0) return 0;
  if (!valid(kind, n, cols, lanes, groups) || clusters < 1 || slice < 4 ||
      slice % 4 != 0 || (long long)slice * kClusterSize < n ||
      ((uintptr_t)tbl & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = kBarrierBytes + 4 * (size_t)slice;
  cudaError_t err = allow_cluster(kind, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(clusters, bytes, attr, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(
      &cfg, cluster_kernel(kind),
      make_gather(tbl, n, cols, idx, out, lanes, groups, slice));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the wrapper's launch plan needs, for device `device`: out[0] the SM
// count; out[1], out[2] the blocks of kBlock threads an SM holds on the L2
// path, P1 and P2 (the least over the hint variants); out[3] the shared
// memory a block may opt in to; out[4], out[5] the clusters of
// kClusterSize CTAs the card holds at once at the largest slice that fits
// (0: the on-chip variant does not launch), P1 and P2.
extern "C" int rvgrt_gather_limits(int device, int* out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(out + 3,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  }
  for (int kind = 0; kind < 2 && err == cudaSuccess; ++kind) {
    out[1 + kind] = 1 << 30;
    for (int hints = 0; hints <= (kStream | kKeep) && err == cudaSuccess;
         ++hints) {
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, l2_kernel(kind, hints), kBlock, 0);
      if (blocks < out[1 + kind]) out[1 + kind] = blocks;
    }
    const size_t bytes =
        kBarrierBytes + (size_t)((out[3] - kBarrierBytes) / 16 * 16);
    if (err == cudaSuccess) err = allow_cluster(kind, bytes);
    if (err == cudaSuccess) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = cluster_config(1, bytes, attr, 0);
      err = cudaOccupancyMaxActiveClusters(out + 4 + kind,
                                           cluster_kernel(kind), &cfg);
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

extern "C" int rvgrt_set_persisting_l2(long long bytes) {
  cudaError_t err =
      cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)bytes);
  if (err == cudaSuccess && bytes == 0) {
    err = cudaCtxResetPersistingL2Cache();
  }
  return (int)err;
}
