"""Volume sharding: z-slab world shards with a ray-handoff ring.

The port of ``rvgrt_tpu/parallel/volume.py`` on ``torch.distributed``.  For
worlds beyond one device's memory the voxel grid and SDF are sharded in
z-slabs: each rank holds only its slab's tracer gather table
(``build_shard_tables``).  A ray is traced by the rank that owns its
current slab; a ray crossing a slab face retires as ``PHASE_EXIT_LO`` /
``HI`` in the tracer (``wavefront.trace(z_edges=...)``, kernel K1's ZEDGES
variant on a GPU) and is handed to the z neighbour, one ppermute a
direction a round.  A ray's z progress is monotone (the DDA step's sign
never changes), so ``n + 2`` rounds resolve every ray; finished rays
scatter their payload into a per-rank result buffer, and the buffers are
summed over the ring at the end.

Differences from single-device tracing (as in the JAX package):

* a handed-off ray restarts its sphere phase and iteration budgets in the
  next slab (the traversal is memoryless given a position, so hits agree;
  ``its`` sums over the slabs visited);
* SDF values are read from the owning slab only, clamped at its faces
  (the stored distances are global, so they stay lower bounds).

Buffers hold the full ray set on every rank (camera rays can all start in
one slab).  ``handoff_cap`` bounds each packet, with overflow retried next
round.  A ray kept back re-exits at once from its resume start; it goes on
with the resume ``t`` and ``its`` of its first exit, so a bounded ring
gives the unbounded ring's result bit for bit.  (The JAX ring recomputes
that ``t`` from the re-exit position, an ulp of drift, and adds the
re-exit's ``its``, one a retry: on ``tests/test_torch_volume.py``'s rays
its bounded and unbounded rings differ in ``its`` on 202 of 1152 rays and
in ``px`` on 9.)  The JAX ring skips the trace on a rank whose buffer is empty
(``lax.cond``); that changes no result (parked lanes retire at init), and
here it would cost a host read of the buffer every round, so the port
always traces: an empty buffer's trace is one flags read a lane.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from rvgrt_tpu_torch.config import RenderConfig, WorldConfig
from rvgrt_tpu_torch.parallel.sharding import _index, _ppermute, _psum
from rvgrt_tpu_torch.trace import wavefront

_F32 = torch.float32
_I32 = torch.int32

#: the f32 fields of a ring buffer (id, ox, oy, oz, dx, dy, dz, t, its,
#: resumed), which travel in a packet as their bits; ``resumed`` is 1 for a
#: ray handed on, 2 for one kept back by a bounded packet
_FLOAT_FIELDS = frozenset(range(1, 8))
#: the merged result buffer's fields
OUT_FIELDS = ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
              "its", "t")


def local_config(cfg: WorldConfig, n_shards: int) -> WorldConfig:
    """WorldConfig of one z-slab (power-of-two shard counts only)."""
    lg = int(math.log2(n_shards))
    assert 1 << lg == n_shards, n_shards
    assert cfg.shift_z - lg >= 2, "slab must be >= one 4-deep brick"
    return dataclasses.replace(cfg, shift_z=cfg.shift_z - lg)


def slab_table(bits: torch.Tensor, sdf: torch.Tensor, cfg: WorldConfig,
               n_shards: int, index: int) -> torch.Tensor:
    """The gather table of z-slab ``index`` of ``n_shards``: the JAX
    package's stacked table's row ``index``."""
    lcfg = local_config(cfg, n_shards)
    zs = cfg.size_z // n_shards
    czs = cfg.sdf_size_z // n_shards
    vol = bits.reshape(cfg.size_z, cfg.size_y, cfg.size_x // 32)
    svol = sdf.reshape(cfg.sdf_size_z, cfg.sdf_size_y, cfg.sdf_size_x)
    return wavefront.make_trace_table(
        vol[index * zs:(index + 1) * zs].reshape(-1),
        svol[index * czs:(index + 1) * czs].reshape(-1), lcfg)


def build_shard_tables(bits: torch.Tensor, sdf: torch.Tensor,
                       cfg: WorldConfig, mesh: DeviceMesh,
                       axis: str = "z") -> torch.Tensor:
    """This rank's slab table only (the memory this module shards): the row
    of JAX's stacked ``(n, local_table_len)`` tables that its device
    holds."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return slab_table(bits, sdf, cfg, n, _index(mesh, axis))


def _pack(valid: torch.Tensor, fields, capacity: int, id_sentinel: int):
    """Stable-pack the ``valid`` lanes of ``fields`` into ``capacity``
    slots, valid lanes first (``jnp.argsort(~valid)``); overflow lanes are
    dropped, empty slots get ``id_sentinel`` (``fields[0]`` is the ray
    id)."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    take = order[:capacity]
    ok = valid[take]
    out = [torch.where(ok, fields[0][take], id_sentinel)]
    out += [f[take] for f in fields[1:]]
    return out


def _to_packet(fields) -> torch.Tensor:
    """A ring buffer's fields as one int32 (10, cap) packet."""
    return torch.stack([f.view(_I32) if i in _FLOAT_FIELDS else f
                        for i, f in enumerate(fields)])


def _from_packet(pkt: torch.Tensor) -> list:
    return [pkt[i].view(_F32) if i in _FLOAT_FIELDS else pkt[i]
            for i in range(pkt.shape[0])]


def trace_ring(tbl: torch.Tensor, cfg: WorldConfig, rcfg: RenderConfig,
               mesh: DeviceMesh, ox, oy, oz, dx, dy, dz, t0, sky_y=None,
               axis: str = "z", rounds: int | None = None,
               handoff_cap: int | None = None,
               report: dict | None = None) -> dict:
    """Every rank's body of the volume-sharded trace: claim the rays whose
    march start lies in this rank's z-slab, trace against the local table
    ``tbl``, hand slab-crossers to the z neighbours over the ``axis`` ring,
    repeat; returns the merged result arrays (length cap >= N), the same
    on every rank.  Ray inputs (flat, length N) must be the same on every
    rank.

    ``handoff_cap`` bounds each round's packet a direction (default: the
    whole buffer).  Exit rays that do not fit stay in the local buffer and
    retry next round (their out-of-slab start exits again at once); the
    default ``rounds``, ``n + 2``, grows by ``ceil(cap / handoff_cap)`` to
    absorb the retries.  ``report``: a dict that gets ``rounds`` and, per
    round, the rays this rank handed off, those it kept for a retry and the
    packet bytes it sent (a host read each round)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    lcfg = local_config(cfg, n)
    slab = float(cfg.size_z // n)
    dev = tbl.device
    N = ox.shape[0]
    cap = -(-N // 4096) * 4096  # whole 4096-lane rows, as in the JAX ring
    hcap = cap if handoff_cap is None else min(handoff_cap, cap)
    if rounds is None:
        rounds = n + 2 + (0 if hcap == cap else -(-cap // hcap))
    sentinel = cap  # an id out of range: the scatter drops it

    def pad(a, fill):
        a = torch.as_tensor(a, dtype=_F32).to(dev)
        return torch.cat([a, torch.full((cap - N,), fill, dtype=_F32,
                                        device=dev)])

    ids0 = torch.cat([torch.arange(N, dtype=_I32, device=dev),
                      torch.full((cap - N,), sentinel, dtype=_I32,
                                 device=dev)])
    rox, roy, roz = pad(ox, -10.0), pad(oy, -10.0), pad(oz, -10.0)
    rdx, rdy, rdz = pad(dx, 1.0), pad(dy, 0.0), pad(dz, 0.0)
    # the fp16 start quantization applies ONCE, to the caller's t0; resume
    # distances stay f32 (quantizing them again could round a resumed ray
    # back across the slab face forever)
    rt0 = pad(torch.as_tensor(t0, dtype=_F32).to(dev).half().float(), 0.0)

    zi = _index(mesh, axis)
    z0 = float(zi) * slab  # exact in f32
    is_first, is_last = zi == 0, zi == n - 1

    # claim the rays whose march START lies in my slab (clamped: a ray
    # starting outside the world goes to the nearest edge slab, whose
    # z_edges flags make it the reference's OOB-start miss)
    sz = roz + rt0 * rdz
    owner = torch.clamp(torch.floor(sz / slab).to(_I32), 0, n - 1)
    my0 = (ids0 < sentinel) & (owner == zi)
    zeros_i = torch.zeros_like(ids0)
    fields = _pack(my0, [ids0, rox, roy, roz, rdx, rdy, rdz, rt0,
                         zeros_i,   # accumulated its
                         zeros_i],  # resumed (crossed a slab face)
                   cap, sentinel)

    # zero-initialised, so the merge over the ring is a plain sum (each
    # finished ray is scattered by exactly one rank)
    out = {k: torch.zeros(cap, dtype=_I32 if k in ("hit", "its") else _F32,
                          device=dev) for k in OUT_FIELDS}
    f32 = lambda v: torch.tensor(v, dtype=_F32, device=dev)  # noqa: E731
    face_hi = f32(z0 + slab) + f32(1e-3)
    face_lo = f32(z0) - f32(1e-3)
    if report is not None:
        report.update(rounds=rounds, handoffs=[], stayed=[],
                      packet_bytes=[])

    for _ in range(rounds):
        rid, qox, qoy, qoz, qdx, qdy, qdz, qt, qits, qres = fields
        live = rid < sentinel
        # park empty slots at an OOB start (they retire at init); t must
        # be zeroed too, or a stale t * dir can re-enter the world
        pox = torch.where(live, qox, -10.0)
        poz = torch.where(live, qoz - z0, -10.0)
        pt = torch.where(live, qt, 0.0)
        res = wavefront.trace(None, None, lcfg, rcfg, pox, qoy, poz, qdx, qdy,
                              qdz, pt, table=tbl, sky_y=sky_y,
                              z_edges=(is_first, is_last),
                              quantize_start_fp16=False)

        term = live & (res.exit_dir == 0)
        tot_its = qits + res.its
        # a handed-off ray that hits in its FIRST DDA cell gets the
        # reference's undefined first-cell normal (zero); it entered this
        # slab through the z face, so the face normal is (0, 0, -sign(dz)),
        # and the matching z-face UV (the MASK_Z branch of the payload):
        # u = frac(x), flipped when stepping +z, v = frac(y)
        zero_n = (res.nx == 0) & (res.ny == 0) & (res.nz == 0)
        fix_n = res.hit & (qres != 0) & zero_n
        nz_fix = torch.where(fix_n, -torch.sign(qdz), res.nz)
        frac_x = res.px - torch.floor(res.px)
        frac_y = res.py - torch.floor(res.py)
        uvu_fix = torch.where(qdz > 0, 1.0 - frac_x, frac_x)
        upd = dict(
            hit=res.hit.to(_I32), px=res.px, py=res.py,
            pz=torch.where(res.hit, res.pz + z0, res.pz),
            nx=res.nx, ny=res.ny, nz=nz_fix,
            uv_u=torch.where(fix_n, uvu_fix, res.uv_u),
            uv_v=torch.where(fix_n, frac_y, res.uv_v),
            its=tot_its, t=res.t)
        # scatter the finished rays; the sentinel id is dropped
        # (mode="drop")
        sids = rid[term].long()
        for k in OUT_FIELDS:
            out[k][sids] = upd[k][term]

        # hand off the exits: the global exit position gives the resume
        # t just past the slab face (no f32 ping-pong across it)
        ex_lo = live & (res.exit_dir < 0)
        ex_hi = live & (res.exit_dir > 0)
        gz = res.pz + z0
        face = torch.where(ex_hi, face_hi, face_lo)
        t_face = torch.where(qdz != 0, (face - qoz) / qdz, 0.0)
        t_exit = ((res.px - qox) * qdx + (res.py - qoy) * qdy
                  + (gz - qoz) * qdz)
        # a ray kept back last round re-exits at init: it goes on with the
        # resume t and its of its first exit
        again = (qres == 2) & (ex_lo | ex_hi)
        t_new = torch.where(again, qt, torch.maximum(t_exit, t_face))
        send = [rid, qox, qoy, qoz, qdx, qdy, qdz, t_new,
                torch.where(again, qits, tot_its), torch.ones_like(rid)]
        stay = None
        if hcap < cap:
            # bounded packets: the first hcap exits a direction ship this
            # round; the rest stay and retry
            def bounded(valid):
                return valid & (torch.cumsum(valid.to(_I32), 0) - 1 < hcap)

            ship_lo, ship_hi = bounded(ex_lo), bounded(ex_hi)
            stay = (ex_lo & ~ship_lo) | (ex_hi & ~ship_hi)
        else:
            ship_lo, ship_hi = ex_lo, ex_hi
        lo_pkt = _to_packet(_pack(ship_lo, send, hcap, sentinel))
        hi_pkt = _to_packet(_pack(ship_hi, send, hcap, sentinel))
        if report is not None:
            report["handoffs"].append(int(ship_lo.sum()) + int(ship_hi.sum()))
            report["stayed"].append(0 if stay is None else int(stay.sum()))
            report["packet_bytes"].append(
                0 if n == 1 else 2 * lo_pkt.numel() * 4)
        # highs go up the ring, lows down; the wrap-around slots carry no
        # rays (edge slabs turn their boundary exits into misses)
        parts = [_from_packet(_ppermute(hi_pkt, mesh, axis, 1)),
                 _from_packet(_ppermute(lo_pkt, mesh, axis, -1))]
        if stay is not None:
            parts.append([torch.where(stay, rid, sentinel)] + send[1:-1]
                         + [torch.full_like(rid, 2)])
        merged_valid = torch.cat([p[0] < sentinel for p in parts])
        merged = [torch.cat(fs) for fs in zip(*parts)]
        fields = _pack(merged_valid, merged, cap, sentinel)

    return {k: _psum(v, mesh, axis) for k, v in out.items()}


def _ring_result(out: dict, N: int) -> wavefront.TraceResult:
    miss = out["hit"][:N] == 0
    dev = miss.device
    fix = lambda v: v[:N]  # noqa: E731
    return wavefront.TraceResult(
        hit=fix(out["hit"]) != 0,
        px=torch.where(miss, wavefront.MISS_POS, fix(out["px"])),
        py=torch.where(miss, wavefront.MISS_POS, fix(out["py"])),
        pz=torch.where(miss, wavefront.MISS_POS, fix(out["pz"])),
        nx=fix(out["nx"]), ny=fix(out["ny"]), nz=fix(out["nz"]),
        uv_u=fix(out["uv_u"]), uv_v=fix(out["uv_v"]),
        its=fix(out["its"]), t=fix(out["t"]),
        exit_dir=torch.zeros(N, dtype=_I32, device=dev),
        steps=torch.zeros(N, dtype=_I32, device=dev),
        degraded=torch.zeros(N, dtype=torch.bool, device=dev))


def trace_volume_sharded(tables: torch.Tensor, cfg: WorldConfig,
                         rcfg: RenderConfig, mesh: DeviceMesh,
                         ox, oy, oz, dx, dy, dz, t0, sky_y=None,
                         axis: str = "z", rounds: int | None = None,
                         handoff_cap: int | None = None,
                         report: dict | None = None
                         ) -> wavefront.TraceResult:
    """Trace flat ray arrays against the z-slab-sharded world.

    ``tables``: this rank's slab table (``build_shard_tables``).  Inputs
    are the same 1-D arrays of length N on every rank; returns a
    TraceResult of (N,) arrays (``exit_dir`` always 0), the same on every
    rank."""
    N = torch.as_tensor(ox).shape[0]
    return _ring_result(trace_ring(tables, cfg, rcfg, mesh, ox, oy, oz, dx,
                                   dy, dz, t0, sky_y=sky_y, axis=axis,
                                   rounds=rounds, handoff_cap=handoff_cap,
                                   report=report), N)


def ring_trace_fn(tables, cfg: WorldConfig, rcfg: RenderConfig,
                  mesh: DeviceMesh, axis: str, sky_y=None,
                  rounds: int | None = None, handoff_cap: int | None = None):
    """A ``render_slab`` ray-cast closure that runs every trace through the
    ring: ``trace_fn(ox, oy, oz, dx, dy, dz, t0)`` over broadcast shapes."""
    dev = tables.device

    def trace_fn(ox, oy, oz, dx, dy, dz, t0):
        ins = [torch.as_tensor(a, dtype=_F32).to(dev)
               for a in (ox, oy, oz, dx, dy, dz, t0)]
        shape = torch.broadcast_shapes(*(a.shape for a in ins))
        flat = [a.broadcast_to(shape).reshape(-1) for a in ins]
        res = _ring_result(trace_ring(tables, cfg, rcfg, mesh, *flat,
                                      sky_y=sky_y, axis=axis, rounds=rounds,
                                      handoff_cap=handoff_cap),
                           flat[0].shape[0])
        return wavefront.TraceResult(*(a.reshape(shape) for a in res))

    return trace_fn


def render_frame_volume(tables, sdf_replicated, gi, atlas, cam, ecfg,
                        mesh: DeviceMesh, include_gi: bool = True,
                        sky_y=None, axis: str = "z",
                        rounds: int | None = None,
                        handoff_cap: int | None = None):
    """The whole frame against the z-slab-sharded world.

    Every ray cast of the pipeline (cascade, prepass, shadows, primary,
    water pair) runs through the ring; shading and composition run on
    every rank from the merged trace results.  World memory is what this
    shards (the per-slab tables); the coarse SDF is replicated for the GI
    cone march.  Returns FrameOutputs, the same on every rank."""
    from rvgrt_tpu_torch.render import pipeline

    trace_fn = ring_trace_fn(tables, ecfg.world, ecfg.render, mesh, axis,
                             sky_y=sky_y, rounds=rounds,
                             handoff_cap=handoff_cap)
    return pipeline.render_slab(
        None, sdf_replicated, gi, atlas, cam, ecfg, y0=0,
        slab_h=ecfg.render.height, include_gi=include_gi, sky_y=sky_y,
        trace_fn=trace_fn)

