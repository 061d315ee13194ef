// K3: the SDF min-plus distance pass along one axis of a uint8 volume.
//
// Replaces the Pallas kernel rvgrt_tpu/ops/sdf_kernels.py::minconv_pass_pallas
// (body _minconv_kernel, pl.pallas_call in minconv_axis1).  For a volume
// viewed as (outer, n, inner) with the pass running along the middle axis:
//
//   out[o, y, x] = min(cap, isqrt(min over off in [0, cap] of
//                                 min(d[y - off], d[y + off])^2 + off^2))
//
// where a neighbour outside [0, n) never wins.  Axis 1 of a (Z, Y, X)
// volume is (outer=Z, n=Y, inner=X); axis 0 is (outer=1, n=Z, inner=Y*X):
// the same kernel reads rows of the same strip, so no transpose is needed.
//
// What bounds it on the H100: bytes, once the work is cut.  The function
// moves one u8 in and one u8 out a cell, 0.27 GB a pass at 512^3 (0.080 ms
// at 3.35 TB/s).  Brute force does cap tap pairs an output at three int32
// operations each (1.6 ms at 512^3, cap 64, at the int32 rate).  The design:
//
// 1. Exact early exit.  Every candidate at offset off is at least off^2 and
//    the running minimum acc only falls, so once off^2 >= acc no later tap
//    can change it.  A thread leaves its offset loop at the first chunk start
//    with off^2 >= the largest acc it holds.  Taps past that point (to the
//    end of a chunk) leave acc as it is, so the result is exact for any u8
//    input and any cap in 1..255.  A tap at offset cap is never needed
//    (its candidate is >= cap^2 >= acc): offsets run 1 .. cap - 1.
// 2. Far rows are skipped.  A row is far where all 64 columns of the strip
//    are at cap or outside the volume: its candidates are >= cap^2 >= acc.
//    The staging counts the near rows; a warp, whose lanes share their rows,
//    skips a chunk of offsets whose rows are all far and stops where every
//    row left is far.  On the 1024^3 world's field the exit alone leaves
//    51-53 tap pairs a cell; the skip leaves 2-6, since most cells are sky.
// 3. Squares, clamped, as u16 in shared memory.  min(lo, hi)^2 =
//    min(lo^2, hi^2), so the strip is staged once as squares of
//    min(d, cap): clamping leaves min(acc, cap^2), and so the output,
//    unchanged (the output is cap exactly when acc >= cap^2), and a
//    neighbour outside [0, n) is staged as cap^2, which never lowers acc
//    below cap^2.  A thread owns two adjacent columns as one u32 word, so a
//    warp's shared-memory load moves 128 B.  On packed squares one tap pair
//    is two Hopper DPX instructions for two outputs: a packed u16 min of the
//    pair, then a packed add-and-min into acc (__vminu2, __viaddmin_u16x2),
//    each at the int32 rate (H100 80GB HBM3, 700 W;
//    rvgrt_tpu_torch/tools/k3_rates.cu).  u16 holds every candidate while
//    cap^2 + (cap - 1)^2 <= 65535, cap <= 181; above that the same loop
//    runs on 32-bit halves (kWide).
// 4. Rows in registers.  Each thread reduces R consecutive output rows of
//    its two columns.  Going from offset off to off + 1 shifts its window of
//    lower rows down by one and its window of upper rows up by one, so each
//    offset loads two new words (not 2 R) and does R packed tap pairs.  The
//    windows are register rings; the offset loop is unrolled R times, so
//    every ring index is known at compile time.
// 5. The strip's load overlaps other blocks' compute.  A block covers 64
//    columns and a tile of 256 output rows and stages them with cap halo
//    rows on each side (50 KB at cap 64); with 63 registers a thread, four
//    blocks of 8 warps fit on an SM, so while one block loads its strip the
//    others reduce theirs.  Each thread keeps two 16-byte loads in flight
//    and converts the bytes to clamped squares on their way into shared
//    memory, which is why this was kept over cp.async (it copies bytes as
//    they are; a second pass through shared memory would convert them).
//    The tiles of one strip are neighbours in launch order, so the halo rows
//    they share come from L2.
// 6. The square root stays off the conversion pipe: the integer goes in and
//    out through a float's mantissa, and an approximate root with the
//    integer fix-up is exact.
//
// Measured at 512^3, cap 64, the 1024^3 world's field (NVIDIA H100 80GB
// HBM3, 700 W; rvgrt_tpu_torch/tools/k3_sweep.py): about 0.31 ms (axis 1)
// and 0.35 ms (axis 0) a pass, 4x the byte bound.  That script builds
// copies of this file with other constants and times each on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;    // output rows a thread reduces at once (R)
constexpr int kTile = 256;  // output rows per block, whole groups of kRows
constexpr int kWarps = 8;   // warps per block
constexpr int kBatch = 2;   // 16-byte loads a thread has in flight, staging
constexpr int kWords = 32;  // u32 words per staged row: 64 columns
static_assert(kTile % kRows == 0, "a tile is whole groups of rows");

// The running minima of a thread's R rows x 2 columns.
template <int R, bool kWide>
struct Acc;

// Packed: one u32 word per row, two u16 halves.
template <int R>
struct Acc<R, false> {
  uint32_t v[R];
  __device__ void set(int i, uint32_t w) { v[i] = w; }
  // acc = min(acc, min(lo, hi) + off^2), per half, in two DPX instructions
  __device__ void tap(int i, uint32_t lo, uint32_t hi, uint32_t off2) {
    v[i] = __viaddmin_u16x2(__vminu2(lo, hi), off2 * 0x00010001u, v[i]);
  }
  __device__ uint32_t largest() const {
    uint32_t m = v[0];
#pragma unroll
    for (int i = 1; i < R; ++i) m = __vmaxu2(m, v[i]);
    return max(m & 0xffffu, m >> 16);
  }
  __device__ uint32_t get(int i, int h) const {
    return h ? v[i] >> 16 : v[i] & 0xffffu;
  }
};

// 32-bit: for cap > 181, where min(lo, hi) + off^2 can pass 65535.
template <int R>
struct Acc<R, true> {
  uint32_t a[R], b[R];
  __device__ void set(int i, uint32_t w) {
    a[i] = w & 0xffffu;
    b[i] = w >> 16;
  }
  __device__ void tap(int i, uint32_t lo, uint32_t hi, uint32_t off2) {
    const uint32_t m = __vminu2(lo, hi);
    a[i] = min(a[i], (m & 0xffffu) + off2);
    b[i] = min(b[i], (m >> 16) + off2);
  }
  __device__ uint32_t largest() const {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) m = max(m, max(a[i], b[i]));
    return m;
  }
  __device__ uint32_t get(int i, int h) const { return h ? b[i] : a[i]; }
};

// Offsets off .. off + R - 1 of the taps of one thread.  At offset o the
// lower row of output i sits in lo[(i - o) mod R] and the upper row in
// hi[(i + o) mod R]; off = 1 (mod R), so each index is a constant here.
// After each offset the ring slot of the dropped row takes the row the next
// offset needs.  kGuard stops after offset top (the last chunk).
template <int R, bool kWide, bool kGuard>
__device__ __forceinline__ void chunk(const uint32_t* __restrict__ s, int off,
                                      int top, uint32_t (&lo)[R],
                                      uint32_t (&hi)[R], Acc<R, kWide>& acc) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int o = off + k;
    if (kGuard && o > top) break;
    const uint32_t o2 = (uint32_t)(o * o);
#pragma unroll
    for (int i = 0; i < R; ++i)
      acc.tap(i, lo[((i - 1 - k) % R + R) % R], hi[(i + 1 + k) % R], o2);
    // s points at the word of output 0's row: rows -(o + 1) and R + o
    lo[((-2 - k) % R + R) % R] = s[-(o + 1) * kWords];
    hi[(1 + k) % R] = s[(R + o) * kWords];
  }
}

// floor(sqrt(a)) for a < 2^22, off the conversion pipe: the float's
// mantissa carries a in and floor(sqrt) out, the approximate square root is
// within one of it, and the integer fix-up makes it exact.
__device__ __forceinline__ uint32_t isqrt(uint32_t a) {
  const float x = __uint_as_float(0x4b000000u | a) - 8388608.0f;
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  uint32_t d = __float_as_uint(__fadd_rd(r, 8388608.0f)) & 0x7fffffu;
  if (d * d > a) d -= 1;
  if ((d + 1) * (d + 1) <= a) d += 1;
  return d;
}

// Squares of min(d, cap) of the 4 bytes of w, as two u16x2 words.
__device__ __forceinline__ uint2 squares4(uint32_t w, uint32_t cap4) {
  w = __vminu4(w, cap4);
  const uint32_t b0 = w & 0xffu, b1 = (w >> 8) & 0xffu, b2 = (w >> 16) & 0xffu,
                 b3 = w >> 24;
  return make_uint2(b0 * b0 | (b1 * b1) << 16, b2 * b2 | (b3 * b3) << 16);
}

// Stage rows y0 - halo .. y0 - halo + rows - 1 of the strip at column x0 as
// clamped squares, cap^2 outside the volume, and count its near rows (a row
// is near where any of its 64 columns is below cap): near[r] is the number
// of near rows before row r.  Where the rows are 16-byte aligned each thread
// loads kBatch 16-byte chunks (64 columns are 4 chunks) before it converts
// any, so the loads' latencies overlap.  Every warp runs each loop to the
// same count, so the shuffles see all 32 lanes.
__device__ __forceinline__ void stage(uint32_t* strip, int* near,
                                      const uint8_t* __restrict__ vol, int n,
                                      long long inner, long long x0, int y0,
                                      int halo, int rows, int cap) {
  const uint32_t cap4 = (uint32_t)cap * 0x01010101u;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) near[0] = 0;
  if (inner % 16 == 0 && (uintptr_t)vol % 16 == 0) {
    const int items = rows * 4;
    for (int i0 = threadIdx.x; i0 - lane < items; i0 += kBatch * blockDim.x) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * blockDim.x;
        const int y = y0 - halo + (i >> 2);
        const long long x = x0 + 16 * (i & 3);
        v[j] = make_uint4(~0u, ~0u, ~0u, ~0u);  // 255 clamps to cap
        if (i < items && y >= 0 && y < n && x < inner)
          v[j] = *reinterpret_cast<const uint4*>(vol + (long long)y * inner +
                                                 x);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * blockDim.x;
        // the row's four chunks are four neighbouring lanes
        int f = (__vcmpltu4(v[j].x, cap4) | __vcmpltu4(v[j].y, cap4) |
                 __vcmpltu4(v[j].z, cap4) | __vcmpltu4(v[j].w, cap4)) != 0;
        f |= __shfl_xor_sync(0xffffffffu, f, 1);
        f |= __shfl_xor_sync(0xffffffffu, f, 2);
        if (i >= items) continue;
        if ((i & 3) == 0) near[(i >> 2) + 1] = f;
        const uint2 a = squares4(v[j].x, cap4), b = squares4(v[j].y, cap4),
                    c = squares4(v[j].z, cap4), d = squares4(v[j].w, cap4);
        uint4* q = reinterpret_cast<uint4*>(strip + (i >> 2) * kWords +
                                            8 * (i & 3));
        q[0] = make_uint4(a.x, a.y, b.x, b.y);
        q[1] = make_uint4(c.x, c.y, d.x, d.y);
      }
    }
  } else {
    // one warp a row, one word (two columns) a lane
    for (int i = threadIdx.x; i < rows * kWords; i += blockDim.x) {
      const int y = y0 - halo + i / kWords;
      const long long x = x0 + 2 * (i % kWords);
      uint32_t w = ~0u;
      if (y >= 0 && y < n && x < inner) {
        const uint8_t* p = vol + (long long)y * inner + x;
        w = 0xffffff00u | p[0];
        if (x + 1 < inner) w = 0xffff0000u | p[0] | (uint32_t)p[1] << 8;
      }
      strip[i] = squares4(w, cap4).x;
      const int f = __any_sync(0xffffffffu, __vcmpltu4(w, cap4) != 0);
      if (lane == 0) near[i / kWords + 1] = f;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // near[1..rows]: prefix sums of the flags
    const int per = (rows + 31) / 32;
    const int a = 1 + lane * per, b = min(a + per, rows + 1);
    int sum = 0;
    for (int r = a; r < b; ++r) sum += near[r];
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += t;
    }
    for (int r = a, run = inc - sum; r < b; ++r) near[r] = run += near[r];
  }
}

// The rings at the start of a chunk at offset off (= 1 mod R): the lower
// row of output i is row i - off, the upper row i + off.
template <int R>
__device__ __forceinline__ void rings(const uint32_t* __restrict__ s, int off,
                                      uint32_t (&lo)[R], uint32_t (&hi)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lo[(i + R - 1) % R] = s[(i - off) * kWords];
    hi[(i + 1) % R] = s[(i + off) * kWords];
  }
}

template <int R, bool kWide>
__global__ void __launch_bounds__(kWarps * 32)
    minconv_mid_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int n, long long inner,
                       int cap, int tile, int tiles) {
  // (tile + 2 halo) rows x 32 words, then the near-row counts
  extern __shared__ __align__(16) uint32_t strip[];
  // a tap at offset cap gives a candidate >= cap^2 >= acc, so offsets
  // 1 .. top = cap - 1 are all the loop runs, and cap rows of halo hold
  // them and the rows the rings load for offset top + 1
  const int top = cap - 1, halo = cap;
  const int rows = tile + 2 * halo;
  int* near = reinterpret_cast<int*>(strip + rows * kWords);
  const int t = blockIdx.x % tiles;
  const long long x0 = (long long)(blockIdx.x / tiles) * (2 * kWords);
  const int y0 = t * tile;
  const long long base = (long long)blockIdx.y * n * inner;
  stage(strip, near, in + base, n, inner, x0, y0, halo, rows, cap);
  __syncthreads();
  // rows a..b are all far: each of their candidates is >= cap^2 >= acc
  auto far = [near](int a, int b) { return near[b + 1] == near[a]; };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long x = x0 + 2 * lane;
  const bool pairs = inner % 2 == 0 && (uintptr_t)out % 2 == 0;
  const int live_rows = min(tile, n - y0);
  for (int g = warp * R; g < live_rows; g += kWarps * R) {
    const int r0 = halo + g;  // the strip row of output 0
    const uint32_t* s = strip + r0 * kWords + lane;
    Acc<R, kWide> acc;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // an output outside the volume starts at 0 so it holds no thread
      // in the loop; its taps read real rows and are never stored
      uint32_t m = 0xffffffffu;
      if (g + i >= live_rows || x >= inner) m = 0;
      else if (x + 1 >= inner) m = 0xffffu;
      acc.set(i, s[i * kWords] & m);
    }
    uint32_t lo[R], hi[R];
    bool stale = true;  // the rings hold another offset's rows
    for (int off = 1; off <= top; off += R) {
      // the same rows for every lane: the warp skips together
      if (far(r0 - top, r0 + R - 1 - off) && far(r0 + off, r0 + R - 1 + top))
        break;  // every tap left is far
      if ((uint32_t)(off * off) >= acc.largest()) break;
      const int last = min(off + R - 1, top);
      if (far(r0 - last, r0 + R - 1 - off) &&
          far(r0 + off, r0 + R - 1 + last)) {
        stale = true;  // this chunk's taps are far
        continue;
      }
      if (stale) rings<R>(s, off, lo, hi);
      stale = false;
      if (off + R - 1 <= top) {
        chunk<R, kWide, false>(s, off, top, lo, hi, acc);
      } else {
        chunk<R, kWide, true>(s, off, top, lo, hi, acc);
        break;
      }
    }
    // acc <= cap^2, so isqrt(acc) <= cap: the reference's clamp holds
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (g + i >= live_rows) break;
      uint8_t* q = out + base + (long long)(y0 + g + i) * inner + x;
      const uint32_t d0 = isqrt(acc.get(i, 0));
      if (x + 1 < inner && pairs) {
        const uint32_t d1 = isqrt(acc.get(i, 1));
        *reinterpret_cast<uint16_t*>(q) = (uint16_t)(d0 | d1 << 8);
      } else {
        if (x < inner) q[0] = (uint8_t)d0;
        if (x + 1 < inner) q[1] = (uint8_t)isqrt(acc.get(i, 1));
      }
    }
  }
}

template <bool kWide>
int launch(const void* in, void* out, int outer, int n, long long inner,
           int cap, cudaStream_t stream) {
  constexpr int R = kRows;
  const int tile = n < kTile ? (n + R - 1) / R * R : kTile;
  const int tiles = (n + tile - 1) / tile;
  const long long strips = (inner + 2 * kWords - 1) / (2 * kWords);
  const long long blocks = strips * tiles;
  if (blocks > 0x7fffffffLL || outer > 65535) return (int)cudaErrorInvalidValue;
  const int rows = tile + 2 * cap;
  const size_t smem = (size_t)rows * kWords * 4 + (size_t)(rows + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        minconv_mid_kernel<R, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)blocks, (unsigned)outer);
  minconv_mid_kernel<R, kWide><<<grid, kWarps * 32, smem, stream>>>(
      (const uint8_t*)in, (uint8_t*)out, n, inner, cap, tile, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rvgrt_minconv_mid(const void* in, void* out, int outer, int n,
                                 long long inner, int cap, void* stream) {
  if (cap < 1 || cap > 255 || n < 1 || inner < 1 || outer < 1)
    return (int)cudaErrorInvalidValue;
  // u16 holds min(lo, hi)^2 + off^2 <= cap^2 + (cap - 1)^2 while cap <= 181
  return 2 * cap * cap <= 65535
             ? launch<false>(in, out, outer, n, inner, cap, (cudaStream_t)stream)
             : launch<true>(in, out, outer, n, inner, cap, (cudaStream_t)stream);
}
