// K1: one superstep of the wavefront tracer, gather included.
//
// Replaces the Pallas kernel rvgrt_tpu/ops/superstep_kernel.py::fused_superstep
// (body _kernel, pl.pallas_call in fused_superstep), which ran
// wavefront._superstep_update after an XLA-side gather.  Here one thread per
// lane does the whole superstep: the pregather index
// (wavefront._superstep_pregather), the clamped gather of the combined table
// word, and the state update (wavefront._superstep_update, carry_tm=True):
// a sphere step on the SDF byte (OOB -> position -100, converged at
// dist <= 1, 100-step budget), an SDF probe/jump every sdf_probe_interval
// DDA steps (major budget 5), or up to dda_substeps DDA steps inside the
// 4x2x4 brick word.  The gather stayed outside the TPU kernel only because
// Mosaic could not lower it.
//
// The 11 state arrays are updated IN PLACE: each thread reads and writes
// only its own lane, so no other thread sees a half-updated state.  A lane
// in MISS or HIT is frozen and returns at once.  `live` (optional) is set to
// 1 by every lane still marching after the update; the tracer reads it for
// its convergence check instead of reducing the flags.
//
// What bounds it on the H100: bytes.  A live lane reads 10 state words and
// 9 direction words, gathers 1 table word and writes 11 state words (~124 B)
// for a few dozen ALU ops; at 1 024 000 primary lanes a superstep moves
// ~0.13 GB at most.  Design: structure-of-arrays state so every load and
// store is coalesced; retired lanes read only their flags word; the random
// table gather is the one uncoalesced access.  Built with -fmad=false: every
// multiply and add rounds separately, as in the reference's graphs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PHASE_SPHERE = 0;
constexpr int PHASE_DDA = 1;
constexpr int PHASE_MISS = 2;
constexpr int PHASE_HIT = 3;
constexpr int MASK_X = 0;
constexpr int MASK_Y = 1;
constexpr int MASK_Z = 2;
constexpr int MASK_NONE = 3;

// flags word layout (LSB first), as in trace/wavefront.py
constexpr int PH_SH = 0, PH_W = 3;
constexpr int MK_SH = 3, MK_W = 2;
constexpr int MJ_SH = 5, MJ_W = 3;
constexpr int SP_SH = 8, SP_W = 7;
constexpr int DD_SH = 15, DD_W = 8;
constexpr int PR_SH = 23;

__device__ __forceinline__ uint32_t get_field(uint32_t f, int sh, int w) {
  return (f >> sh) & ((1u << w) - 1u);
}

__device__ __forceinline__ uint32_t set_field(uint32_t f, int sh, int w,
                                              uint32_t v) {
  const uint32_t mask = ((1u << w) - 1u) << sh;
  return (f & ~mask) | ((v << sh) & mask);
}

}  // namespace

// Must match ops/_lib.py::TRACE_PARAMS field for field.
struct TraceParams {
  int size_x, size_y, size_z;
  int shift_x, shift_y;
  int sdf_shift;        // log2(sdf_coarseness): floor division by a shift
  int sdf_coarseness;
  int sdf_size_x, sdf_size_y, sdf_size_z;
  int bits_len;         // occupancy words before the SDF part of the table
  int sdf_quarter;      // sdf_num_cells / 4
  int qshift;           // log2(sdf_quarter)
  int table_len;
  int probe_mask;       // sdf_probe_interval - 1
  int max_sphere_steps, max_major_iterations, max_dda_steps;
  int jump_min_dist, dda_substeps;
};

namespace {

__device__ __forceinline__ int brick_word(const TraceParams& p, int x, int y,
                                          int z) {
  x &= p.size_x - 1;
  y &= p.size_y - 1;
  z &= p.size_z - 1;
  return (x >> 2) | ((y >> 1) << (p.shift_x - 2)) |
         ((z >> 2) << (p.shift_x - 2 + p.shift_y - 1));
}

__device__ __forceinline__ int brick_bit(const TraceParams& p, int x, int y,
                                         int z) {
  x &= p.size_x - 1;
  y &= p.size_y - 1;
  z &= p.size_z - 1;
  return (x & 3) | ((y & 1) << 2) | ((z & 3) << 3);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void superstep_kernel(
    TraceParams p, const uint32_t* __restrict__ table,
    const float* __restrict__ sky_y, float* __restrict__ px,
    float* __restrict__ py, float* __restrict__ pz, int* __restrict__ ix,
    int* __restrict__ iy, int* __restrict__ iz, int* __restrict__ flags,
    int* __restrict__ its, float* __restrict__ tmx, float* __restrict__ tmy,
    float* __restrict__ tmz, const float* __restrict__ dxa,
    const float* __restrict__ dya, const float* __restrict__ dza,
    const float* __restrict__ ddxa, const float* __restrict__ ddya,
    const float* __restrict__ ddza, const int* __restrict__ stxa,
    const int* __restrict__ stya, const int* __restrict__ stza,
    int* __restrict__ live, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t fl = (uint32_t)flags[i];
  const int phase = (int)get_field(fl, PH_SH, PH_W);
  if (phase >= PHASE_MISS) return;  // retired lanes are frozen

  float x = px[i], y = py[i], z = pz[i];
  const float dx = dxa[i], dy = dya[i], dz = dza[i];
  const bool in_sphere = phase == PHASE_SPHERE;
  if (in_sphere && sky_y != nullptr && dy >= 0.0f && y >= *sky_y) {
    // above every solid voxel and not descending: can never hit
    flags[i] = (int)set_field(fl, PH_SH, PH_W, PHASE_MISS);
    return;
  }
  const int dda_i = (int)get_field(fl, DD_SH, DD_W);
  const int probed = (int)((fl >> PR_SH) & 1u);
  const bool probe_turn = !in_sphere &&
                          ((dda_i & p.probe_mask) == p.probe_mask) &&
                          probed == 0;
  int cix = ix[i], ciy = iy[i], ciz = iz[i];
  const int widx_bit = brick_word(p, cix, ciy, ciz);

  // ---------- THE gather (one per superstep) ----------
  int widx, bytepos = 0;
  if (in_sphere || probe_turn) {
    int qx = cix, qy = ciy, qz = ciz;
    if (in_sphere) {
      qx = (int)floorf(x);
      qy = (int)floorf(y);
      qz = (int)floorf(z);
    }
    // arithmetic shift == floor division by the power-of-two coarseness
    const int cx = clampi(qx >> p.sdf_shift, 0, p.sdf_size_x - 1);
    const int cy = clampi(qy >> p.sdf_shift, 0, p.sdf_size_y - 1);
    const int cz = clampi(qz >> p.sdf_shift, 0, p.sdf_size_z - 1);
    const int cidx = cz * (p.sdf_size_x * p.sdf_size_y) + cy * p.sdf_size_x +
                     cx;
    widx = p.bits_len + (cidx & (p.sdf_quarter - 1));
    bytepos = (cidx >> p.qshift) << 3;
  } else {
    widx = widx_bit;
  }
  const uint32_t word = table[clampi(widx, 0, p.table_len - 1)];
  const int dist = (int)((word >> bytepos) & 0xFFu);

  int lits = its[i];
  if (in_sphere) {
    // ================= SPHERE phase (approximateCSDF) =================
    const int sphere_i = (int)get_field(fl, SP_SH, SP_W);
    const bool oob = x < 0.0f || y < 0.0f || z < 0.0f ||
                     x >= (float)p.size_x || y >= (float)p.size_y ||
                     z >= (float)p.size_z;
    const bool converged = !oob && dist <= 1;
    const bool march = !oob && !converged;
    const bool exhaust = march && sphere_i >= p.max_sphere_steps - 1;
    if (march) {
      const float df = (float)dist;
      x = x + dx * df;
      y = y + dy * df;
      z = z + dz * df;
      fl = set_field(fl, SP_SH, SP_W, (uint32_t)(sphere_i + 1));
    }
    if (oob) x = y = z = -100.0f;
    px[i] = x;
    py[i] = y;
    pz[i] = z;
    if (oob || converged || exhaust) {
      // SPHERE -> DDA: floor the position, init tMax
      const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
      ix[i] = (int)fx;
      iy[i] = (int)fy;
      iz[i] = (int)fz;
      tmx[i] = (stxa[i] > 0 ? (fx + 1.0f) - x : x - fx) * ddxa[i];
      tmy[i] = (stya[i] > 0 ? (fy + 1.0f) - y : y - fy) * ddya[i];
      tmz[i] = (stza[i] > 0 ? (fz + 1.0f) - z : z - fz) * ddza[i];
      fl = set_field(fl, PH_SH, PH_W, PHASE_DDA);
      fl = set_field(fl, MK_SH, MK_W, MASK_NONE);
      fl = set_field(fl, DD_SH, DD_W, 0);
      fl &= ~(1u << PR_SH);
    }
  } else if (probe_turn) {
    // ================= DDA probe superstep =================
    if (dist > p.jump_min_dist) {
      const float cx = (float)cix + 0.5f;
      const float cy = (float)ciy + 0.5f;
      const float cz = (float)ciz + 0.5f;
      const float t_proj = (cx - x) * dx + (cy - y) * dy + (cz - z) * dz;
      const float jump_len = t_proj + (float)dist * (float)p.sdf_coarseness;
      const int new_major = (int)get_field(fl, MJ_SH, MJ_W) + 1;
      px[i] = x + jump_len * dx;
      py[i] = y + jump_len * dy;
      pz[i] = z + jump_len * dz;
      fl = set_field(fl, MJ_SH, MJ_W, (uint32_t)new_major);
      if (new_major >= p.max_major_iterations) {
        fl = set_field(fl, PH_SH, PH_W, PHASE_MISS);
        lits += 1;
      } else {
        fl = set_field(set_field(fl, PH_SH, PH_W, PHASE_SPHERE), SP_SH, SP_W,
                       0);
        lits += 2;  // the jumping DDA iteration + the major-loop re-entry
      }
      its[i] = lits;
    } else {
      fl |= 1u << PR_SH;
    }
  } else {
    // ================= DDA action superstep =================
    const float ddx = ddxa[i], ddy = ddya[i], ddz = ddza[i];
    const int stx = stxa[i], sty = stya[i], stz = stza[i];
    float ltmx = tmx[i], ltmy = tmy[i], ltmz = tmz[i];
    int lmask = (int)get_field(fl, MK_SH, MK_W);
    int ldda = dda_i;
    bool hit = false, miss = false, stepped = false;
    const int nsub = p.dda_substeps > 1 ? p.dda_substeps : 1;
    for (int k = 0; k < nsub; ++k) {
      lits += 1;  // loop-top its++
      if (cix < 0 || ciy < 0 || ciz < 0 || cix >= p.size_x ||
          ciy >= p.size_y || ciz >= p.size_z) {
        miss = true;
        break;
      }
      if ((word >> brick_bit(p, cix, ciy, ciz)) & 1u) {
        hit = true;
        break;
      }
      // branchless axis step of the reference (lines 172-192)
      if (ltmx < ltmy && ltmx < ltmz) {
        ltmx = ltmx + ddx;
        cix += stx;
        lmask = MASK_X;
      } else if (ltmy < ltmz) {
        ltmy = ltmy + ddy;
        ciy += sty;
        lmask = MASK_Y;
      } else {
        ltmz = ltmz + ddz;
        ciz += stz;
        lmask = MASK_Z;
      }
      stepped = true;
      ldda += 1;
      if (ldda >= p.max_dda_steps) {
        miss = true;
        break;
      }
      if (k + 1 < p.dda_substeps) {
        const bool due = (ldda & p.probe_mask) == p.probe_mask;
        if (due || brick_word(p, cix, ciy, ciz) != widx_bit) break;
      }
    }
    ix[i] = cix;
    iy[i] = ciy;
    iz[i] = ciz;
    tmx[i] = ltmx;
    tmy[i] = ltmy;
    tmz[i] = ltmz;
    its[i] = lits;
    fl = set_field(set_field(fl, MK_SH, MK_W, (uint32_t)lmask), DD_SH, DD_W,
                   (uint32_t)ldda);
    if (stepped) fl &= ~(1u << PR_SH);
    if (hit) fl = set_field(fl, PH_SH, PH_W, PHASE_HIT);
    if (miss) fl = set_field(fl, PH_SH, PH_W, PHASE_MISS);
  }
  flags[i] = (int)fl;
  if (live != nullptr && (int)get_field(fl, PH_SH, PH_W) < PHASE_MISS)
    *live = 1;
}

}  // namespace

extern "C" int rvgrt_superstep(
    TraceParams p, const void* table, const void* sky_y, void* px, void* py,
    void* pz, void* ix, void* iy, void* iz, void* flags, void* its, void* tmx,
    void* tmy, void* tmz, const void* dx, const void* dy, const void* dz,
    const void* ddx, const void* ddy, const void* ddz, const void* stx,
    const void* sty, const void* stz, void* live, int n, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const int grid = (n + block - 1) / block;
  superstep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      p, (const uint32_t*)table, (const float*)sky_y, (float*)px, (float*)py,
      (float*)pz, (int*)ix, (int*)iy, (int*)iz, (int*)flags, (int*)its,
      (float*)tmx, (float*)tmy, (float*)tmz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)ddx,
      (const float*)ddy, (const float*)ddz, (const int*)stx, (const int*)sty,
      (const int*)stz, (int*)live, n);
  return (int)cudaGetLastError();
}
