"""Wavefront hybrid tracer: sphere-trace the coarse SDF, then DDA.

The port of ``rvgrt_tpu/trace/wavefront.py``.  The whole ray buffer
advances in lockstep *supersteps*; every ray carries a phase (SPHERE / DDA /
DONE) and one superstep performs exactly one state transition per live ray.
Each superstep gathers ONE word from a combined table (4x2x4 occupancy
bricks, then the SDF four cells per word), so sphere-stepping, DDA-stepping
and SDF-probing lanes share one gather.

On a CUDA device a whole trace is ONE launch of kernel K1
(``ops/superstep_kernel.py``): persistent threads take rays from a
device-side queue and run each ray's supersteps (the gather index, the
gather and the state update) in registers until it retires or reaches its
superstep budget.  The host reads nothing back: no live flag, no ``steps``
(a 0-d device tensor).  On the CPU the same trace is the host loop of
``_superstep_pregather`` + the clamped gather + ``_superstep_update`` below,
the counterparts of the JAX functions of the same names.
``RenderConfig.fused_superstep`` chooses nothing here: there is one path.

Tiles: the JAX tracer cuts 2-D ray batches into ``lax.map`` row tiles so a
tile's loop stops when ITS rays retire.  Here all lanes form one flat
trace, run until every lane has retired (or ``max_supersteps``).  A retired
lane is frozen - no branch of the superstep touches a lane in MISS or HIT
- so every lane's ``hit/px/py/pz/nx/ny/nz/uv_u/uv_v/its/t`` is the same as
with tiles.  Only ``steps`` differs: it counts the supersteps of the whole
trace (in batches of ``steps_per_check``), not of the lane's TPU tile.

Semantics are the reference's (``raytracing_functions.cu:85-202``):
iteration budgets 5 x (100 sphere + 200 DDA), the exact ``its`` counter,
tMax/uv/normal construction, fp16 quantization of the start distance, OOB =>
miss; a first-cell hit returns normal 0, pos = entry point, uv = 0.

The two-phase straggler respite (``RenderConfig.straggler_budget`` > 0, at
``RESPITE_MIN_RAYS`` rays or more, as in JAX): phase 1 runs every lane for
at most ``straggler_budget`` supersteps and exports a resume point for each
lane still marching; those lanes are compacted, in ascending lane order,
into ``respite_slots(N)`` slots and finished by phase 2 at the full budget;
over-cap lanes read as misses flagged ``degraded``.  Each phase is one
trace (one K1 launch), and nothing is read back: the compaction is a
cumulative sum and a sorted search on the device, its size set by N on
the host.

Not ported yet: the volume-sharded ``z_edges`` mode and ``slim_carry``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rvgrt_tpu_torch.config import RenderConfig, WorldConfig
from rvgrt_tpu_torch.core import u32

_F32 = torch.float32
_I32 = torch.int32

PHASE_SPHERE = 0
PHASE_DDA = 1
PHASE_MISS = 2
PHASE_HIT = 3

MASK_X = 0
MASK_Y = 1
MASK_Z = 2
MASK_NONE = 3  # no DDA step taken yet (reference mask == -128)

MISS_POS = -500.0
OOB_POS = -100.0

# flags word layout (LSB first)
_PH_SH, _PH_W = 0, 3        # phase
_MK_SH, _MK_W = 3, 2        # mask
_MJ_SH, _MJ_W = 5, 3        # major iteration
_SP_SH, _SP_W = 8, 7        # sphere step counter
_DD_SH, _DD_W = 15, 8       # DDA step counter
_PR_SH = 23                 # probed flag

#: traces run since the last reset (one K1 launch each on a GPU; each
#: phase of a two-phase trace counts as one), the two-phase traces among
#: them (``respites``), and their supersteps: ``supersteps`` sums each
#: trace's 0-d ``steps`` tensor on its device, so keeping it costs no host
#: read.  Read it with ``read_stats``.
stats = {"traces": 0, "respites": 0, "supersteps": 0}

#: the two-phase respite engages at this many rays or more (the JAX rule)
RESPITE_MIN_RAYS = 4 * 4096


def reset_stats() -> None:
    stats.update(traces=0, respites=0, supersteps=0)


def read_stats() -> dict:
    """``stats`` as ints: one host read, which waits for the device."""
    return {"traces": stats["traces"], "respites": stats["respites"],
            "supersteps": int(stats["supersteps"])}

#: carried per-lane state, in kernel argument order
STATE_KEYS = ("px", "py", "pz", "ix", "iy", "iz", "flags", "its",
              "tmx", "tmy", "tmz")


def _get(flags, sh, w):
    return (flags >> sh) & ((1 << w) - 1)


def _set(flags, sh, w, val):
    mask = ((1 << w) - 1) << sh
    return (flags & ~mask) | ((val << sh) & mask)


class TraceResult(NamedTuple):
    hit: torch.Tensor   # bool
    px: torch.Tensor    # hit position (f32); (-500,...) on miss
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor    # face normal (+-1 on one axis; 0 for first-cell hits)
    ny: torch.Tensor
    nz: torch.Tensor
    uv_u: torch.Tensor  # in-face UV
    uv_v: torch.Tensor
    its: torch.Tensor   # iteration count (i32) - the Mrays/s work metric
    t: torch.Tensor     # ray parameter of the hit (f32; 0 on miss)
    # 0; 2/3 (resume point of a sphere/DDA lane) only inside the respite
    exit_dir: torch.Tensor | int = 0
    # supersteps the trace ran (i32; a two-phase lane adds its phases')
    steps: torch.Tensor | int = 0
    # an unfinished lane beyond the respite's slots, read as a miss
    degraded: torch.Tensor | int = 0


def make_trace_table(bits: torch.Tensor, sdf: torch.Tensor,
                     cfg: WorldConfig) -> torch.Tensor:
    """Combined gather table: [brick occupancy words | SDF 4 cells/word].

    Built once per world.  QUARTERED pack: byte k of SDF word w = cell
    ``w + k * (num_cells/4)``, the JAX package's layout, so the two tables
    compare word for word."""
    from rvgrt_tpu_torch.world import voxel_grid

    q = sdf.reshape(4, cfg.sdf_num_cells // 4).to(_I32)
    packed = q[0] | (q[1] << 8) | (q[2] << 16) | u32.shl(q[3], 24)
    return torch.cat([voxel_grid.to_brick_words(bits, cfg), packed])


def _sdf_word_index(cfg: WorldConfig, bits_len: int, vx, vy, vz):
    """Combined-table index + byte position for an SDF lookup at fine-voxel
    coords (the getDistance clamp semantics, raytracing_functions.cuh:35-67).
    Quartered layout: cell ``cidx`` lives in word ``cidx mod num_cells/4``
    at byte ``cidx div num_cells/4``."""
    c = cfg.sdf_coarseness
    cx = torch.clamp(vx // c, 0, cfg.sdf_size_x - 1)
    cy = torch.clamp(vy // c, 0, cfg.sdf_size_y - 1)
    cz = torch.clamp(vz // c, 0, cfg.sdf_size_z - 1)
    cidx = cz * (cfg.sdf_size_x * cfg.sdf_size_y) + cy * cfg.sdf_size_x + cx
    qshift = (cfg.sdf_num_cells // 4).bit_length() - 1  # log2(num_cells/4)
    return (bits_len + (cidx & (cfg.sdf_num_cells // 4 - 1)),
            (cidx >> qshift) << 3)


def _brick_word_index(cfg: WorldConfig, vx, vy, vz):
    """Combined-table index + bit position for an occupancy lookup in the
    4x2x4 brick layout (coords wrap at the power-of-two world dims, like
    IsSolid/toIndex, cumath.cuh:33-45)."""
    x = vx & (cfg.size_x - 1)
    y = vy & (cfg.size_y - 1)
    z = vz & (cfg.size_z - 1)
    wi = ((x >> 2)
          | ((y >> 1) << (cfg.shift_x - 2))
          | ((z >> 2) << (cfg.shift_x - 2 + cfg.shift_y - 1)))
    return wi, (x & 3) | ((y & 1) << 2) | ((z & 3) << 3)


def _superstep_pregather(cfg: WorldConfig, rcfg: RenderConfig, dirs, s,
                         sky_y=None):
    """Superstep front half: retirement masks + THE gather's table index
    over the state ``s`` and the direction invariants ``dirs`` = (dx, dy,
    dz, ddx, ddy, ddz, stx, sty, stz)."""
    dy = dirs[1]
    probe_mask = rcfg.sdf_probe_interval - 1  # power of two
    flags = s["flags"]
    phase = _get(flags, _PH_SH, _PH_W)
    dda_i = _get(flags, _DD_SH, _DD_W)
    probed = (flags >> _PR_SH) & 1

    in_sphere = phase == PHASE_SPHERE
    if sky_y is not None:
        # above every solid voxel and not descending -> can never hit
        sky_out = in_sphere & (dy >= 0) & (s["py"] >= sky_y)
        in_sphere = in_sphere & ~sky_out
        flags = torch.where(sky_out,
                            _set(flags, _PH_SH, _PH_W, PHASE_MISS), flags)
    in_dda = phase == PHASE_DDA
    # probe superstep: reference's (i & 7) == 7 SDF re-check (line 127)
    probe_turn = in_dda & ((dda_i & probe_mask) == probe_mask) \
        & (probed == 0)
    action_turn = in_dda & ~probe_turn

    bits_len = cfg.num_words
    table_len = bits_len + cfg.sdf_num_cells // 4
    sph_or_probe = in_sphere | probe_turn
    qvx = torch.where(in_sphere, torch.floor(s["px"]).to(_I32), s["ix"])
    qvy = torch.where(in_sphere, torch.floor(s["py"]).to(_I32), s["iy"])
    qvz = torch.where(in_sphere, torch.floor(s["pz"]).to(_I32), s["iz"])
    widx_sdf, bytepos = _sdf_word_index(cfg, bits_len, qvx, qvy, qvz)
    widx_bit, _ = _brick_word_index(cfg, s["ix"], s["iy"], s["iz"])
    widx = torch.where(sph_or_probe, widx_sdf, widx_bit)
    return dict(flags=flags, in_sphere=in_sphere, probe_turn=probe_turn,
                action_turn=action_turn, dda_i=dda_i,
                widx=torch.clamp(widx, 0, table_len - 1),
                bytepos=bytepos, widx_bit=widx_bit)


def _superstep_update(cfg: WorldConfig, rcfg: RenderConfig, dirs, s, pre,
                      word):
    """Superstep back half: the masked state machine over the gathered
    ``word`` (sphere march / SDF probe+jump / DDA brick substeps), the
    ``carry_tm=True`` form of the JAX function.  Returns the next state."""
    dx, dy, dz, ddx, ddy, ddz, stx, sty, stz = dirs
    size_x, size_y, size_z = cfg.size_x, cfg.size_y, cfg.size_z
    probe_mask = rcfg.sdf_probe_interval - 1
    flags = pre["flags"]
    in_sphere = pre["in_sphere"]
    probe_turn = pre["probe_turn"]
    action_turn = pre["action_turn"]
    dda_i = pre["dda_i"]
    widx_bit = pre["widx_bit"]
    dist = u32.lsr(word, pre["bytepos"]) & 0xFF

    def enter_dda(sd, lanes, fl):
        """SPHERE -> DDA for ``lanes``: floor pos, init tMax (lines 114-120)."""
        fx = torch.floor(sd["px"])
        fy = torch.floor(sd["py"])
        fz = torch.floor(sd["pz"])
        sd["ix"] = torch.where(lanes, fx.to(_I32), sd["ix"])
        sd["iy"] = torch.where(lanes, fy.to(_I32), sd["iy"])
        sd["iz"] = torch.where(lanes, fz.to(_I32), sd["iz"])
        ntmx = torch.where(stx > 0, fx + 1.0 - sd["px"], sd["px"] - fx) * ddx
        ntmy = torch.where(sty > 0, fy + 1.0 - sd["py"], sd["py"] - fy) * ddy
        ntmz = torch.where(stz > 0, fz + 1.0 - sd["pz"], sd["pz"] - fz) * ddz
        sd["tmx"] = torch.where(lanes, ntmx, sd["tmx"])
        sd["tmy"] = torch.where(lanes, ntmy, sd["tmy"])
        sd["tmz"] = torch.where(lanes, ntmz, sd["tmz"])
        nf = _set(fl, _PH_SH, _PH_W, PHASE_DDA)
        nf = _set(nf, _MK_SH, _MK_W, MASK_NONE)
        nf = _set(nf, _DD_SH, _DD_W, 0)
        nf = nf & ~(1 << _PR_SH)
        return torch.where(lanes, nf, fl)

    ns = dict(s)
    nflags = flags

    # ================= SPHERE phase (approximateCSDF, lines 65-83) ======
    sphere_i = _get(flags, _SP_SH, _SP_W)
    sp_oob = in_sphere & (
        (s["px"] < 0) | (s["py"] < 0) | (s["pz"] < 0)
        | (s["px"] >= size_x) | (s["py"] >= size_y) | (s["pz"] >= size_z))
    sp_converged = in_sphere & ~sp_oob & (dist <= 1)
    sp_march = in_sphere & ~sp_oob & ~sp_converged
    sp_exhaust = sp_march & (sphere_i >= rcfg.max_sphere_steps - 1)

    distf = dist.to(_F32)
    ns["px"] = torch.where(sp_march, s["px"] + dx * distf, s["px"])
    ns["py"] = torch.where(sp_march, s["py"] + dy * distf, s["py"])
    ns["pz"] = torch.where(sp_march, s["pz"] + dz * distf, s["pz"])
    nflags = torch.where(sp_march,
                         _set(nflags, _SP_SH, _SP_W, sphere_i + 1), nflags)
    ns["px"] = torch.where(sp_oob, OOB_POS, ns["px"])
    ns["py"] = torch.where(sp_oob, OOB_POS, ns["py"])
    ns["pz"] = torch.where(sp_oob, OOB_POS, ns["pz"])
    to_dda = sp_oob | sp_converged | sp_exhaust
    nflags = enter_dda(ns, to_dda, nflags)

    # ================= DDA probe superstep (lines 127-141) ==============
    do_jump = probe_turn & (dist > rcfg.jump_min_dist)
    no_jump = probe_turn & ~do_jump
    cx = s["ix"].to(_F32) + 0.5
    cy = s["iy"].to(_F32) + 0.5
    cz = s["iz"].to(_F32) + 0.5
    t_proj = (cx - s["px"]) * dx + (cy - s["py"]) * dy \
        + (cz - s["pz"]) * dz
    jump_len = t_proj + dist.to(_F32) * float(cfg.sdf_coarseness)
    major = _get(flags, _MJ_SH, _MJ_W)
    new_major = major + 1
    jump_miss = do_jump & (new_major >= rcfg.max_major_iterations)
    jump_resphere = do_jump & ~jump_miss
    ns["px"] = torch.where(do_jump, s["px"] + jump_len * dx, ns["px"])
    ns["py"] = torch.where(do_jump, s["py"] + jump_len * dy, ns["py"])
    ns["pz"] = torch.where(do_jump, s["pz"] + jump_len * dz, ns["pz"])
    nflags = torch.where(do_jump, _set(nflags, _MJ_SH, _MJ_W, new_major),
                         nflags)
    nflags = torch.where(jump_resphere,
                         _set(_set(nflags, _PH_SH, _PH_W, PHASE_SPHERE),
                              _SP_SH, _SP_W, 0), nflags)
    nflags = torch.where(jump_miss,
                         _set(nflags, _PH_SH, _PH_W, PHASE_MISS), nflags)
    # its: +1 for the DDA iteration that jumped (line 124), +1 more for
    # the major-loop re-entry (line 107)
    ns["its"] = torch.where(jump_miss, s["its"] + 1, s["its"])
    ns["its"] = torch.where(jump_resphere, s["its"] + 2, ns["its"])
    nflags = torch.where(no_jump, nflags | (1 << _PR_SH), nflags)

    # ================= DDA action superstep (lines 123-199) =============
    # up to dda_substeps reference loop iterations against the gathered
    # 4x2x4 brick; a lane stops on hit, OOB, budget, probe boundary or
    # leaving the brick
    l_ix, l_iy, l_iz = s["ix"], s["iy"], s["iz"]
    l_tmx, l_tmy, l_tmz = s["tmx"], s["tmy"], s["tmz"]
    l_mask = _get(flags, _MK_SH, _MK_W)
    l_dda = dda_i
    l_its = ns["its"]
    false = torch.zeros_like(action_turn)
    hit_acc, miss_acc, stepped = false, false, false
    act = action_turn
    for _k in range(max(rcfg.dda_substeps, 1)):
        l_its = torch.where(act, l_its + 1, l_its)  # loop-top its++
        oob_k = act & ((l_ix < 0) | (l_iy < 0) | (l_iz < 0)
                       | (l_ix >= size_x) | (l_iy >= size_y)
                       | (l_iz >= size_z))
        miss_acc = miss_acc | oob_k
        act = act & ~oob_k
        _, bitpos_k = _brick_word_index(cfg, l_ix, l_iy, l_iz)
        solid_k = (u32.lsr(word, bitpos_k) & 1) != 0
        hit_k = act & solid_k
        hit_acc = hit_acc | hit_k
        act = act & ~hit_k
        step_x = act & (l_tmx < l_tmy) & (l_tmx < l_tmz)
        step_y = act & ~step_x & (l_tmy < l_tmz)
        step_z = act & ~step_x & ~step_y
        l_tmx = torch.where(step_x, l_tmx + ddx, l_tmx)
        l_tmy = torch.where(step_y, l_tmy + ddy, l_tmy)
        l_tmz = torch.where(step_z, l_tmz + ddz, l_tmz)
        l_ix = torch.where(step_x, l_ix + stx, l_ix)
        l_iy = torch.where(step_y, l_iy + sty, l_iy)
        l_iz = torch.where(step_z, l_iz + stz, l_iz)
        l_mask = torch.where(step_x, MASK_X,
                             torch.where(step_y, MASK_Y,
                                         torch.where(step_z, MASK_Z, l_mask)))
        stepped = stepped | act
        l_dda = torch.where(act, l_dda + 1, l_dda)
        # budget exhausted without a jump -> miss (loop end, line 199)
        bud = act & (l_dda >= rcfg.max_dda_steps)
        miss_acc = miss_acc | bud
        act = act & ~bud
        if _k + 1 < rcfg.dda_substeps:
            due = (l_dda & probe_mask) == probe_mask
            nwi, _ = _brick_word_index(cfg, l_ix, l_iy, l_iz)
            act = act & ~due & (nwi == widx_bit)
    ns["ix"] = torch.where(action_turn, l_ix, ns["ix"])
    ns["iy"] = torch.where(action_turn, l_iy, ns["iy"])
    ns["iz"] = torch.where(action_turn, l_iz, ns["iz"])
    ns["tmx"] = torch.where(action_turn, l_tmx, ns["tmx"])
    ns["tmy"] = torch.where(action_turn, l_tmy, ns["tmy"])
    ns["tmz"] = torch.where(action_turn, l_tmz, ns["tmz"])
    ns["its"] = l_its
    nflags = torch.where(action_turn,
                         _set(_set(nflags, _MK_SH, _MK_W, l_mask),
                              _DD_SH, _DD_W, l_dda), nflags)
    nflags = torch.where(stepped, nflags & ~(1 << _PR_SH), nflags)
    nflags = torch.where(hit_acc, _set(nflags, _PH_SH, _PH_W, PHASE_HIT),
                         nflags)
    nflags = torch.where(miss_acc, _set(nflags, _PH_SH, _PH_W, PHASE_MISS),
                         nflags)
    ns["flags"] = nflags
    return ns


def any_live(flags: torch.Tensor) -> bool:
    return bool((_get(flags, _PH_SH, _PH_W) < PHASE_MISS).any())


def trace(bits, sdf, cfg: WorldConfig, rcfg: RenderConfig,
          ox, oy, oz, dx, dy, dz, t_start,
          quantize_start_fp16: bool = True, table=None,
          sky_y=None) -> TraceResult:
    """Trace rays (any common broadcast shape) through the world.

    ``t_start`` mirrors the reference's ``half distance`` parameter: the
    march origin is ``origin + t_start * dir`` (raytracing_functions.cu:90),
    quantized through fp16 like the implicit CUDA float->half conversion.
    ``sky_y``: 0-d tensor, 1 + the highest solid voxel's y; upward rays at
    or above it retire at once (image-identical, fewer ``its``).
    ``table``: the combined gather table (built from bits/sdf if None).
    With ``rcfg.straggler_budget > 0`` and at least ``RESPITE_MIN_RAYS``
    rays the trace runs in two phases (``_trace_two_phase``).
    """
    if table is None:
        table = make_trace_table(bits, sdf, cfg)
    dev = table.device
    ins = [torch.as_tensor(a, dtype=_F32).to(dev)
           for a in (ox, oy, oz, dx, dy, dz, t_start)]
    shape = torch.broadcast_shapes(*(a.shape for a in ins))
    flat = [a.broadcast_to(shape).reshape(-1).contiguous() for a in ins]
    if rcfg.straggler_budget > 0 and flat[0].numel() >= RESPITE_MIN_RAYS:
        res = _trace_two_phase(table, cfg, rcfg, flat, quantize_start_fp16,
                               sky_y)
    else:
        res = _trace_impl(table, cfg, rcfg, *flat,
                          quantize_start_fp16=quantize_start_fp16,
                          sky_y=sky_y)
    return TraceResult(*(r.reshape(shape) for r in res))


def _trace_impl(table, cfg: WorldConfig, rcfg: RenderConfig,
                ox, oy, oz, dx, dy, dz, t0,
                quantize_start_fp16: bool, sky_y=None,
                resume: bool = False) -> TraceResult:
    s, dirs = start_state(cfg, ox, oy, oz, dx, dy, dz, t0,
                          quantize_start_fp16, sky_y=sky_y)
    steps = run_supersteps(cfg, rcfg, table, dirs, s, sky_y=sky_y)
    return _payload(s, dirs, ox, oy, oz, steps, resume=resume)


def respite_slots(n: int, cap_frac: float) -> int:
    """Phase 2's lane count for an N-ray two-phase trace: ``cap_frac * N``
    rounded up to whole 4096-lane rows, at least one row and at most N
    rounded up (``rvgrt_tpu/trace/wavefront.py``'s rule).  A host int that
    depends only on N, so the compaction reads nothing back."""
    capn = -(-max(4096, int(n * cap_frac)) // 4096) * 4096
    return min(capn, -(-n // 4096) * 4096)


def _trace_two_phase(table, cfg: WorldConfig, rcfg: RenderConfig, rays,
                     quantize_start_fp16: bool, sky_y) -> TraceResult:
    """The straggler respite over flat rays (the JAX ``_trace_two_phase``).

    Phase 1 runs every lane for at most ``straggler_budget`` supersteps
    (rounded up to whole batches of ``steps_per_check``, where the JAX
    tiles stop it) and exports a resume point for each lane still marching
    (``exit_dir`` 2: sphere, at its position; 3: DDA, at its current
    cell's entry point).  The k-th unfinished lane, in ascending lane
    order, fills slot k of phase 2 (a sorted search of the unfinished
    lanes' running count; the JAX package's ``nonzero(size=capn)``);
    phase 2 resumes it without fp16 quantisation, a DDA lane 0.25 voxels
    behind its entry point (clamped at 0), and runs at the full budget.
    Padding slots start outside the world and retire at once.  The merge
    takes phase 2's fields for the slotted lanes, with ``its = max(its1 +
    its2 - corr, its1)`` (``corr`` 2 for DDA lanes, 1 for sphere lanes);
    unfinished lanes beyond the slots read as misses flagged
    ``degraded``."""
    n = rays[0].numel()
    dev = rays[0].device
    rcfg1 = dataclasses.replace(rcfg, max_supersteps=rcfg.straggler_budget)
    r1 = _trace_impl(table, cfg, rcfg1, *rays,
                     quantize_start_fp16=quantize_start_fp16, sky_y=sky_y,
                     resume=True)

    capn = respite_slots(n, rcfg.straggler_cap_frac)
    unfin = r1.exit_dir >= 2
    rank = torch.cumsum(unfin.to(torch.int64), 0)  # 1-based at unfinished
    want = torch.arange(1, capn + 1, dtype=torch.int64, device=dev)
    take = torch.searchsorted(rank, want)  # the lane of each slot, n if none
    ok = take < n
    gtake = torch.clamp_max(take, n - 1)

    code_t = r1.exit_dir[gtake]
    t2 = r1.t[gtake] - torch.where(code_t == 3, 0.25, 0.0)
    t2 = torch.where(ok, torch.clamp_min(t2, 0.0), 0.0)
    o2 = [torch.where(ok, a[gtake], -10.0) for a in rays[:3]]
    d2 = [a[gtake] for a in rays[3:6]]
    rcfg2 = dataclasses.replace(rcfg, straggler_budget=0)
    r2 = _trace_impl(table, cfg, rcfg2, *o2, *d2, t2,
                     quantize_start_fp16=False, sky_y=sky_y)
    stats["respites"] += 1

    taken = unfin & (rank <= capn)
    slot = torch.clamp(rank - 1, 0, capn - 1)

    def put(f1, f2):
        return torch.where(taken, f2[slot], f1)

    its1 = r1.its[gtake]
    corr = 1 + (code_t == 3).to(_I32)
    its2 = torch.maximum(its1 + r2.its - corr, its1)
    steps1 = r1.steps[gtake]
    leftover = unfin & ~taken
    return TraceResult(
        hit=put(r1.hit, r2.hit),
        px=torch.where(leftover, MISS_POS, put(r1.px, r2.px)),
        py=torch.where(leftover, MISS_POS, put(r1.py, r2.py)),
        pz=torch.where(leftover, MISS_POS, put(r1.pz, r2.pz)),
        nx=put(r1.nx, r2.nx), ny=put(r1.ny, r2.ny), nz=put(r1.nz, r2.nz),
        uv_u=put(r1.uv_u, r2.uv_u), uv_v=put(r1.uv_v, r2.uv_v),
        its=put(r1.its, its2),
        t=torch.where(leftover, 0.0, put(r1.t, r2.t)),
        exit_dir=torch.zeros_like(r1.exit_dir),
        steps=put(r1.steps, steps1 + r2.steps),
        degraded=leftover)


def start_state(cfg: WorldConfig, ox, oy, oz, dx, dy, dz, t0,
                quantize_start_fp16: bool = True, sky_y=None):
    """The tracer's initial per-lane state and direction invariants for
    flat (N,) rays: ``(state dict, dirs)``, with init-time retirement of
    sky-out and OOB starts (the phase/its the first supersteps would
    give)."""
    if quantize_start_fp16:
        t0 = t0.half().float()

    big = 1e10
    ddx = torch.where(dx != 0, torch.abs(1.0 / dx), big)
    ddy = torch.where(dy != 0, torch.abs(1.0 / dy), big)
    ddz = torch.where(dz != 0, torch.abs(1.0 / dz), big)
    stx = torch.sign(dx).to(_I32)
    sty = torch.sign(dy).to(_I32)
    stz = torch.sign(dz).to(_I32)
    dirs = (dx, dy, dz, ddx, ddy, ddz, stx, sty, stz)

    size_x, size_y, size_z = cfg.size_x, cfg.size_y, cfg.size_z
    zi = torch.zeros_like(dx, dtype=_I32)
    zf = torch.zeros_like(dx)

    px0 = ox + t0 * dx
    py0 = oy + t0 * dy
    pz0 = oz + t0 * dz

    # sky first, then OOB (the order of the superstep body)
    ph0 = zi + PHASE_SPHERE
    its0 = zi + 1  # major-loop entry counts one (line 107)
    live0 = torch.ones_like(px0, dtype=torch.bool)
    if sky_y is not None:
        sky0 = (dy >= 0) & (py0 >= sky_y)
        ph0 = torch.where(sky0, PHASE_MISS, ph0)
        live0 = live0 & ~sky0
    oob0 = live0 & (
        (px0 < 0) | (py0 < 0) | (pz0 < 0)
        | (px0 >= size_x) | (py0 >= size_y) | (pz0 >= size_z))
    ph0 = torch.where(oob0, PHASE_MISS, ph0)
    # OOB start: sphere returns (-100)^3, DDA's loop-top its++ then the
    # bounds check misses -> its == 2 (lines 124, 144-147)
    its0 = torch.where(oob0, its0 + 1, its0)

    s = dict(px=px0, py=py0, pz=pz0, ix=zi.clone(), iy=zi.clone(),
             iz=zi.clone(),
             flags=_set(_set(zi, _MK_SH, _MK_W, MASK_NONE), _PH_SH, _PH_W,
                        ph0),
             its=its0, tmx=zf.clone(), tmy=zf.clone(), tmz=zf.clone())
    return {k: v.contiguous() for k, v in s.items()}, dirs


def run_supersteps(cfg: WorldConfig, rcfg: RenderConfig, table, dirs, s,
                   sky_y=None) -> torch.Tensor:
    """Advance ``s`` in place until every lane has retired or
    ``max_supersteps`` ran, in batches of ``steps_per_check`` supersteps
    (``wavefront.py``'s while loop).  Returns the supersteps run, a 0-d
    int32 tensor on the table's device.

    One call of K1's wrapper, whatever ``rcfg.fused_superstep`` says: one
    kernel launch and no host read on a CUDA device, the plain loop on the
    CPU."""
    from rvgrt_tpu_torch.ops import superstep_kernel

    steps = superstep_kernel.trace_supersteps(cfg, rcfg, table, dirs, s,
                                              sky_y=sky_y)
    stats["traces"] += 1
    stats["supersteps"] = stats["supersteps"] + steps
    return steps


def _payload(s, dirs, ox, oy, oz, steps, resume: bool = False
             ) -> TraceResult:
    """The hit payload reconstructed from the final state.  ``resume``
    (phase 1 of the respite): a lane still in SPHERE or DDA keeps a
    position, its resume point - a sphere lane's current position, a DDA
    lane's current cell entry point - with ``exit_dir`` 2 or 3."""
    dx, dy, dz, ddx, ddy, ddz, stx, sty, stz = dirs
    # ---------------- post-loop hit payload ----------------
    flags = s["flags"]
    phase = _get(flags, _PH_SH, _PH_W)
    m = _get(flags, _MK_SH, _MK_W)
    hit = phase == PHASE_HIT
    stxf = stx.to(_F32)
    styf = sty.to(_F32)
    stzf = stz.to(_F32)
    t_hit = torch.where(
        m == MASK_X, s["tmx"] - ddx,
        torch.where(m == MASK_Y, s["tmy"] - ddy,
                    torch.where(m == MASK_Z, s["tmz"] - ddz, 0.0)))
    hx = s["px"] + t_hit * dx
    hy = s["py"] + t_hit * dy
    hz = s["pz"] + t_hit * dz
    first_cell = m == MASK_NONE
    hx = torch.where(first_cell, s["px"], hx)
    hy = torch.where(first_cell, s["py"], hy)
    hz = torch.where(first_cell, s["pz"], hz)
    nx = torch.where(hit & (m == MASK_X), -stxf, 0.0)
    ny = torch.where(hit & (m == MASK_Y), -styf, 0.0)
    nz = torch.where(hit & (m == MASK_Z), -stzf, 0.0)
    fx_ = s["ix"].to(_F32)
    fy_ = s["iy"].to(_F32)
    fz_ = s["iz"].to(_F32)
    # per-face UV with orientation flips (lines 156-166)
    uvu = torch.where(m == MASK_X, hy - fy_, hx - fx_)
    uvu_z = torch.where(stz == 1, 1.0 - uvu, uvu)
    uvu = torch.where(m == MASK_Z, uvu_z, uvu)
    uvu = torch.where(first_cell, 0.0, uvu)
    uvv_x = torch.where(stx == -1, 1.0 - (hz - fz_), hz - fz_)
    uvv = torch.where(m == MASK_X, uvv_x,
                      torch.where(m == MASK_Y, hz - fz_,
                                  torch.where(m == MASK_Z, hy - fy_, 0.0)))
    if resume:
        unf_sphere = phase == PHASE_SPHERE
        unf_dda = phase == PHASE_DDA
        hx = torch.where(unf_sphere, s["px"], hx)
        hy = torch.where(unf_sphere, s["py"], hy)
        hz = torch.where(unf_sphere, s["pz"], hz)
        keep = hit | unf_sphere | unf_dda
        exit_dir = torch.where(unf_sphere, 2, torch.where(unf_dda, 3, 0)
                               ).to(_I32)
    else:
        keep = hit
        exit_dir = torch.zeros_like(s["its"])
    out_px = torch.where(keep, hx, MISS_POS)
    out_py = torch.where(keep, hy, MISS_POS)
    out_pz = torch.where(keep, hz, MISS_POS)
    t_out = torch.where(
        keep, (out_px - ox) * dx + (out_py - oy) * dy + (out_pz - oz) * dz,
        0.0)
    return TraceResult(
        hit=hit, px=out_px, py=out_py, pz=out_pz,
        nx=nx, ny=ny, nz=nz,
        uv_u=torch.where(hit, uvu, 0.0), uv_v=torch.where(hit, uvv, 0.0),
        its=s["its"], t=t_out, exit_dir=exit_dir,
        steps=steps.expand_as(s["its"]),
        degraded=torch.zeros_like(hit))
