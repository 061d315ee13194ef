// K1: the wavefront tracer's whole superstep loop, one launch per trace.
//
// Replaces the Pallas kernel rvgrt_tpu/ops/superstep_kernel.py::
// fused_superstep (body _kernel, pl.pallas_call in fused_superstep), which
// ran wavefront._superstep_update after an XLA-side gather, once per
// superstep, inside the JAX tracer's device-side lax.while_loop
// (rvgrt_tpu/trace/wavefront.py, `final = jax.lax.while_loop(...)`).  Here
// that loop runs inside one launch: each lane runs its ray's supersteps to
// retirement in registers, then takes the next ray from a device queue.
//
// One superstep (superstep() below, the body the per-superstep kernel had):
// the pregather index (wavefront._superstep_pregather), the clamped gather
// of the combined table word, and the state update
// (wavefront._superstep_update, carry_tm=True): a sphere step on the SDF
// byte (OOB -> position -100, converged at dist <= 1, 100-step budget), an
// SDF probe/jump every sdf_probe_interval DDA steps (major budget 5), or up
// to dda_substeps DDA steps inside the 4x2x4 brick word.  A ray in MISS or
// HIT is retired and frozen.
//
// The loop (trace_kernel): persistent threads after Aila and Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs" (HPG 2009).  The
// grid fills the card once; each warp takes ray indices from one global
// counter: __ballot_sync finds the lanes that need a ray, one atomicAdd per
// warp takes that many indices, __shfl_sync hands out the base, and each
// lane takes its rank in the ballot.  A lane whose ray retires takes the
// next one, so a warp never waits for its slowest ray.  All 32 lanes stay
// in the loop until the queue is empty and the warp's last ray has retired,
// so every ballot and shuffle sees the whole warp.  (A variant in which one
// atomic took a longer private run of rays per warp, to spare the counter,
// was tried; its times were not kept, so whether it helps is open.)
//
// A lane loads its ray's state words (the cell and tMax words only for a
// ray fetched in DDA: in SPHERE they are dead), 9 direction words and
// sky_y once, runs the supersteps in registers until the ray retires or
// has run `step_cap` supersteps, and writes back only the groups of state
// words its supersteps changed; a ray retired at start costs one flags
// read and writes nothing.  The only memory access per superstep is the
// table gather, through the read-only path.
//
// Semantics of the host loop it replaces (and of the JAX while loop): the
// trace runs in batches of k = check_every supersteps while any lane is
// live and fewer than max_supersteps ran.  So a lane stops at retirement or
// at step_cap = ceil(max_supersteps / k) * k, and the trace's `steps` is
// max over lanes of k * ceil(r / k) for a lane that retired at superstep r
// (0 for a ray retired at start) and step_cap for a lane still live there:
// each warp reduces its lanes' values with __reduce_max_sync and one lane
// folds it into scratch[1] with atomicMax.  scratch[0] is the ray counter;
// the entry point zeroes both with cudaMemsetAsync on the stream, so a
// CUDA-graph replay resets them too.
//
// What bounds it on the H100: bytes.  Over the 1 024 000-lane primary trace
// of the 1024^3 world the state and direction words each lane's path reads
// are read once and the changed words written once (~91 MB); the gathers
// touch well under a million distinct table words, which stay in the 50 MB
// L2.  Design: state in registers for the whole trace (the per-superstep
// launches reloaded and stored it every superstep), the dead cell and tMax
// words of a ray in SPHERE left unloaded, no host round trip between
// supersteps, and the gather through __ldg.  It runs about ten times above
// that bound; which of the candidates holds it there (each superstep's
// gather waits on the one before, the lanes of a warp take different
// branches, instruction rate) is not measured yet.  Built with -fmad=false: every multiply and add
// rounds separately, as in the reference's graphs.
//
// Slim carry (RenderConfig.slim_carry, the JAX tracer's carry_tm=False):
// the SLIM instantiation of superstep / trace_kernel keeps no tMax between
// supersteps.  Each DDA action superstep recomputes it from the frozen
// DDA-entry position and the current cell, as wavefront.recompute_tmax
// does, before its substeps; the turn to DDA sets none, and the tMax words
// are neither loaded nor stored.  A carried value differs from the
// recomputed one by rounding, so no register value is reused across
// supersteps.
//
// Volume-sharded tracing (wavefront.trace's z_edges, parallel/volume.py):
// the ZEDGES instantiation traces one z-slab of a larger world.  A ray that
// leaves the slab through an interior z face, with x and y inside, retires
// as PHASE_EXIT_LO / PHASE_EXIT_HI instead of missing: in SPHERE the test
// sits beside the sky test (the mask set to NONE, so the payload is the
// sphere position), in DDA inside the substeps' bounds test (the payload is
// the entry point of the first cell outside the slab).  is_first / is_last
// (launch arguments) make the world's own first / last face a miss.  Exit
// phases are >= PHASE_MISS, so the fetch and the retirement test treat an
// exit as retired like a hit or a miss, and `steps` counts it the same way.
// Lanes that start outside the slab are retired as exits by
// wavefront.start_state before the launch.  All four instantiations (SLIM x
// ZEDGES) share every other line.
//
// ptxas for sm_90a (RVGRT_PTXAS_VERBOSE=1): trace_kernel<false, false> uses
// 43 registers, no stack frame and no spills; the register file then holds
// at most 5 blocks of 256 threads (40 of 64 warps) per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PHASE_SPHERE = 0;
constexpr int PHASE_DDA = 1;
constexpr int PHASE_MISS = 2;
constexpr int PHASE_HIT = 3;
constexpr int PHASE_EXIT_LO = 4;
constexpr int PHASE_EXIT_HI = 5;
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

// groups of state words a superstep may change
constexpr unsigned DIRTY_POS = 1u;    // px, py, pz
constexpr unsigned DIRTY_CELL = 2u;   // ix, iy, iz
constexpr unsigned DIRTY_TM = 4u;     // tmx, tmy, tmz
constexpr unsigned DIRTY_ITS = 8u;    // its
constexpr unsigned DIRTY_FLAGS = 16u; // flags

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;

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

// One ray's carried state (trace/wavefront.py::STATE_KEYS) ...
struct Ray {
  float px, py, pz;
  int ix, iy, iz;
  uint32_t fl;
  int its;
  float tmx, tmy, tmz;
};

// ... and its direction invariants.
struct Dir {
  float dx, dy, dz, ddx, ddy, ddz;
  int stx, sty, stz;
};

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

// tMax of cell i on one axis from the DDA-entry coordinate p (slim carry):
// wavefront.recompute_tmax, in its order of operations; a zero-direction
// lane whose entry sits on a boundary is parked at 1e10.
__device__ __forceinline__ float recompute_tmax(float p, int i, int st,
                                                float dd) {
  const float fi = (float)i;
  const float tm = (st > 0 ? (fi + 1.0f) - p : p - fi) * dd;
  return (st == 0 && tm == 0.0f) ? 1e10f : tm;
}

// One superstep of a live ray (phase SPHERE or DDA), in place on `r`.
// Returns the DIRTY_* groups it wrote.  SLIM: slim carry (r.tm* unused).
// ZEDGES: a z-slab of a larger world; z_first / z_last say whether its low
// / high z face is the world's own.
template <bool SLIM, bool ZEDGES>
__device__ __forceinline__ unsigned superstep(
    const TraceParams& p, const uint32_t* __restrict__ table, bool has_sky,
    float sky, bool z_first, bool z_last, const Dir& d, Ray& r) {
  uint32_t fl = r.fl;
  const int phase = (int)get_field(fl, PH_SH, PH_W);
  const float x = r.px, y = r.py, z = r.pz;
  const float dx = d.dx, dy = d.dy, dz = d.dz;
  const bool in_sphere = phase == PHASE_SPHERE;
  if (in_sphere && has_sky && dy >= 0.0f && y >= sky) {
    // above every solid voxel and not descending: can never hit
    r.fl = set_field(fl, PH_SH, PH_W, PHASE_MISS);
    return DIRTY_FLAGS;
  }
  if (ZEDGES && in_sphere && x >= 0.0f && y >= 0.0f &&
      x < (float)p.size_x && y < (float)p.size_y) {
    // an interior slab face hands the ray on; it keeps its position
    const bool lo = z < 0.0f && !z_first;
    const bool hi = z >= (float)p.size_z && !z_last;
    if (lo || hi) {
      fl = set_field(fl, PH_SH, PH_W, lo ? PHASE_EXIT_LO : PHASE_EXIT_HI);
      r.fl = set_field(fl, MK_SH, MK_W, MASK_NONE);
      return DIRTY_FLAGS;
    }
  }
  const int dda_i = (int)get_field(fl, DD_SH, DD_W);
  const int probed = (int)((fl >> PR_SH) & 1u);
  const bool probe_turn = !in_sphere &&
                          ((dda_i & p.probe_mask) == p.probe_mask) &&
                          probed == 0;
  int cix = r.ix, ciy = r.iy, ciz = r.iz;
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
  const uint32_t word = __ldg(table + clampi(widx, 0, p.table_len - 1));
  const int dist = (int)((word >> bytepos) & 0xFFu);

  unsigned dirty = DIRTY_FLAGS;
  if (in_sphere) {
    // ================= SPHERE phase (approximateCSDF) =================
    const int sphere_i = (int)get_field(fl, SP_SH, SP_W);
    const bool oob = x < 0.0f || y < 0.0f || z < 0.0f ||
                     x >= (float)p.size_x || y >= (float)p.size_y ||
                     z >= (float)p.size_z;
    const bool converged = !oob && dist <= 1;
    const bool march = !oob && !converged;
    const bool exhaust = march && sphere_i >= p.max_sphere_steps - 1;
    float nx = x, ny = y, nz = z;
    if (march) {
      const float df = (float)dist;
      nx = x + dx * df;
      ny = y + dy * df;
      nz = z + dz * df;
      fl = set_field(fl, SP_SH, SP_W, (uint32_t)(sphere_i + 1));
    }
    if (oob) nx = ny = nz = -100.0f;
    if (march || oob) {
      r.px = nx;
      r.py = ny;
      r.pz = nz;
      dirty |= DIRTY_POS;
    }
    if (oob || converged || exhaust) {
      // SPHERE -> DDA: floor the position, init tMax
      const float fx = floorf(nx), fy = floorf(ny), fz = floorf(nz);
      r.ix = (int)fx;
      r.iy = (int)fy;
      r.iz = (int)fz;
      if (!SLIM) {
        r.tmx = (d.stx > 0 ? (fx + 1.0f) - nx : nx - fx) * d.ddx;
        r.tmy = (d.sty > 0 ? (fy + 1.0f) - ny : ny - fy) * d.ddy;
        r.tmz = (d.stz > 0 ? (fz + 1.0f) - nz : nz - fz) * d.ddz;
        dirty |= DIRTY_TM;
      }
      fl = set_field(fl, PH_SH, PH_W, PHASE_DDA);
      fl = set_field(fl, MK_SH, MK_W, MASK_NONE);
      fl = set_field(fl, DD_SH, DD_W, 0);
      fl &= ~(1u << PR_SH);
      dirty |= DIRTY_CELL;
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
      r.px = x + jump_len * dx;
      r.py = y + jump_len * dy;
      r.pz = z + jump_len * dz;
      fl = set_field(fl, MJ_SH, MJ_W, (uint32_t)new_major);
      if (new_major >= p.max_major_iterations) {
        fl = set_field(fl, PH_SH, PH_W, PHASE_MISS);
        r.its += 1;
      } else {
        fl = set_field(set_field(fl, PH_SH, PH_W, PHASE_SPHERE), SP_SH, SP_W,
                       0);
        r.its += 2;  // the jumping DDA iteration + the major-loop re-entry
      }
      dirty |= DIRTY_POS | DIRTY_ITS;
    } else {
      fl |= 1u << PR_SH;
    }
  } else {
    // ================= DDA action superstep =================
    const float ddx = d.ddx, ddy = d.ddy, ddz = d.ddz;
    const int stx = d.stx, sty = d.sty, stz = d.stz;
    float ltmx, ltmy, ltmz;
    if (SLIM) {
      ltmx = recompute_tmax(x, cix, stx, ddx);
      ltmy = recompute_tmax(y, ciy, sty, ddy);
      ltmz = recompute_tmax(z, ciz, stz, ddz);
    } else {
      ltmx = r.tmx;
      ltmy = r.tmy;
      ltmz = r.tmz;
    }
    int lmask = (int)get_field(fl, MK_SH, MK_W);
    int ldda = dda_i;
    int lits = r.its;
    bool hit = false, miss = false, stepped = false;
    int exit_phase = 0;  // ZEDGES: PHASE_EXIT_LO / HI when the ray left
    const int nsub = p.dda_substeps > 1 ? p.dda_substeps : 1;
    for (int k = 0; k < nsub; ++k) {
      lits += 1;  // loop-top its++
      if (cix < 0 || ciy < 0 || ciz < 0 || cix >= p.size_x ||
          ciy >= p.size_y || ciz >= p.size_z) {
        if (ZEDGES && cix >= 0 && ciy >= 0 && cix < p.size_x &&
            ciy < p.size_y) {
          // an interior slab face is a handoff, not a miss
          if (ciz < 0 && !z_first) exit_phase = PHASE_EXIT_LO;
          if (ciz >= p.size_z && !z_last) exit_phase = PHASE_EXIT_HI;
        }
        miss = exit_phase == 0;
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
    r.ix = cix;
    r.iy = ciy;
    r.iz = ciz;
    if (!SLIM) {
      r.tmx = ltmx;
      r.tmy = ltmy;
      r.tmz = ltmz;
      dirty |= DIRTY_TM;
    }
    r.its = lits;
    fl = set_field(set_field(fl, MK_SH, MK_W, (uint32_t)lmask), DD_SH, DD_W,
                   (uint32_t)ldda);
    if (stepped) fl &= ~(1u << PR_SH);
    if (hit) fl = set_field(fl, PH_SH, PH_W, PHASE_HIT);
    if (miss) fl = set_field(fl, PH_SH, PH_W, PHASE_MISS);
    if (ZEDGES && exit_phase != 0)
      fl = set_field(fl, PH_SH, PH_W, (uint32_t)exit_phase);
    dirty |= DIRTY_CELL | DIRTY_ITS;
  }
  r.fl = fl;
  return dirty;
}

template <bool SLIM, bool ZEDGES>
__global__ void __launch_bounds__(BLOCK) trace_kernel(
    TraceParams p, const uint32_t* __restrict__ table,
    const float* __restrict__ sky_y, float* __restrict__ px,
    float* __restrict__ py, float* __restrict__ pz, int* __restrict__ ix,
    int* __restrict__ iy, int* __restrict__ iz, int* __restrict__ flags,
    int* __restrict__ its, float* __restrict__ tmx, float* __restrict__ tmy,
    float* __restrict__ tmz, const float* __restrict__ dxa,
    const float* __restrict__ dya, const float* __restrict__ dza,
    const float* __restrict__ ddxa, const float* __restrict__ ddya,
    const float* __restrict__ ddza, const int* __restrict__ stxa,
    const int* __restrict__ stya, const int* __restrict__ stza, int n,
    int step_cap, int check_every, int z_first, int z_last,
    int* __restrict__ scratch) {
  const int lane = (int)(threadIdx.x & 31u);
  const unsigned below = (1u << lane) - 1u;  // the lanes ranked before this
  const bool has_sky = sky_y != nullptr;
  const float sky = has_sky ? __ldg(sky_y) : 0.0f;

  Ray r = {};
  Dir d = {};
  int ray = -1;       // this lane's ray, -1 while it has none
  int count = 0;      // supersteps the ray ran in this launch
  unsigned dirty = 0;
  int steps = 0;      // this lane's share of the trace's `steps`
  bool drained = false;  // the counter has passed n (warp-uniform)

  while (true) {
    // ---- hand the idle lanes the next rays: one atomic per warp ----
    const unsigned idle = __ballot_sync(FULL, ray < 0);
    if (idle != 0u && !drained) {
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(scratch, __popc(idle));
      base = __shfl_sync(FULL, base, leader);
      drained = base + __popc(idle) >= n;
      if (ray < 0) {
        const int idx = base + __popc(idle & below);
        if (idx < n) {
          const uint32_t fl = (uint32_t)flags[idx];
          if ((int)get_field(fl, PH_SH, PH_W) < PHASE_MISS) {
            ray = idx;
            count = 0;
            dirty = 0;
            r.px = px[idx];
            r.py = py[idx];
            r.pz = pz[idx];
            r.fl = fl;
            r.its = its[idx];
            // in SPHERE the cell and tMax words are dead: the turn to DDA
            // sets them before any superstep reads them
            if ((int)get_field(fl, PH_SH, PH_W) == PHASE_DDA) {
              r.ix = ix[idx];
              r.iy = iy[idx];
              r.iz = iz[idx];
              if (!SLIM) {
                r.tmx = tmx[idx];
                r.tmy = tmy[idx];
                r.tmz = tmz[idx];
              }
            }
            d.dx = dxa[idx];
            d.dy = dya[idx];
            d.dz = dza[idx];
            d.ddx = ddxa[idx];
            d.ddy = ddya[idx];
            d.ddz = ddza[idx];
            d.stx = stxa[idx];
            d.sty = stya[idx];
            d.stz = stza[idx];
          }
          // a ray retired at start: nothing to run, nothing to write
        }
      }
    }

    // ---- one superstep of every lane that has a ray ----
    if (__ballot_sync(FULL, ray >= 0) == 0u) {
      if (drained) break;
      continue;
    }
    if (ray >= 0) {
      dirty |= superstep<SLIM, ZEDGES>(p, table, has_sky, sky, z_first != 0,
                                       z_last != 0, d, r);
      ++count;
      const bool retired = (int)get_field(r.fl, PH_SH, PH_W) >= PHASE_MISS;
      if (retired || count >= step_cap) {
        const int i = ray;
        if (dirty & DIRTY_POS) {
          px[i] = r.px;
          py[i] = r.py;
          pz[i] = r.pz;
        }
        if (dirty & DIRTY_CELL) {
          ix[i] = r.ix;
          iy[i] = r.iy;
          iz[i] = r.iz;
        }
        if (dirty & DIRTY_TM) {
          tmx[i] = r.tmx;
          tmy[i] = r.tmy;
          tmz[i] = r.tmz;
        }
        if (dirty & DIRTY_ITS) its[i] = r.its;
        if (dirty & DIRTY_FLAGS) flags[i] = (int)r.fl;
        const int batches = (count + check_every - 1) / check_every;
        steps = max(steps, retired ? batches * check_every : step_cap);
        ray = -1;
      }
    }
  }
  const int warp_steps = __reduce_max_sync(FULL, steps);
  if (lane == 0 && warp_steps > 0) atomicMax(scratch + 1, warp_steps);
}

// The number of trace_kernel<SLIM, ZEDGES> blocks that fill the current
// device: resident blocks per SM times SMs (cached per device and variant).
template <bool SLIM, bool ZEDGES>
cudaError_t full_grid(int* grid) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cache = dev >= 0 && dev < 64;
  if (cache && cached[dev] > 0) {
    *grid = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, trace_kernel<SLIM, ZEDGES>, BLOCK, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || sms <= 0) return cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms;
  if (cache) cached[dev] = *grid;
  return cudaSuccess;
}

template <bool SLIM, bool ZEDGES>
cudaError_t launch_trace(
    TraceParams p, const void* table, const void* sky_y, void* px, void* py,
    void* pz, void* ix, void* iy, void* iz, void* flags, void* its, void* tmx,
    void* tmy, void* tmz, const void* dx, const void* dy, const void* dz,
    const void* ddx, const void* ddy, const void* ddz, const void* stx,
    const void* sty, const void* stz, int n, int step_cap, int check_every,
    int z_first, int z_last, void* scratch, cudaStream_t st) {
  int fill = 0;
  cudaError_t err = full_grid<SLIM, ZEDGES>(&fill);
  if (err != cudaSuccess) return err;
  const int needed = (n + BLOCK - 1) / BLOCK;
  const int grid = needed < fill ? needed : fill;
  trace_kernel<SLIM, ZEDGES><<<grid, BLOCK, 0, st>>>(
      p, (const uint32_t*)table, (const float*)sky_y, (float*)px, (float*)py,
      (float*)pz, (int*)ix, (int*)iy, (int*)iz, (int*)flags, (int*)its,
      (float*)tmx, (float*)tmy, (float*)tmz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)ddx,
      (const float*)ddy, (const float*)ddz, (const int*)stx, (const int*)sty,
      (const int*)stz, n, step_cap, check_every, z_first, z_last,
      (int*)scratch);
  return cudaGetLastError();
}

}  // namespace

// scratch: 2 int32 on the device, [ray counter, steps]; zeroed here.
// slim != 0 runs the slim-carry variant; zedges != 0 the volume-sharded
// one, with z_first / z_last != 0 when the slab's low / high face is the
// world's own.
extern "C" int rvgrt_trace(
    TraceParams p, const void* table, const void* sky_y, void* px, void* py,
    void* pz, void* ix, void* iy, void* iz, void* flags, void* its, void* tmx,
    void* tmy, void* tmz, const void* dx, const void* dy, const void* dz,
    const void* ddx, const void* ddy, const void* ddz, const void* stx,
    const void* sty, const void* stz, int n, int step_cap, int check_every,
    int slim, int zedges, int z_first, int z_last, void* scratch,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || step_cap <= 0) return 0;
  if (check_every < 1) check_every = 1;
  auto launch = zedges ? (slim ? &launch_trace<true, true>
                               : &launch_trace<false, true>)
                       : (slim ? &launch_trace<true, false>
                               : &launch_trace<false, false>);
  return (int)launch(p, table, sky_y, px, py, pz, ix, iy, iz, flags, its,
                     tmx, tmy, tmz, dx, dy, dz, ddx, ddy, ddz, stx, sty, stz,
                     n, step_cap, check_every, z_first, z_last, scratch, st);
}
