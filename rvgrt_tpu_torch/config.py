"""Engine configuration.

The CUDA reference hardcodes every tunable at compile time (world dims in
``cumath.cuh:19-31``, resolutions in ``State.hpp:28-32``, SDF/GI coarseness in
``CoarseArray.cuh:9-21``, cone constants in ``raytracing_functions.cuh:9-12``,
terrain constants in ``TerrainGeneration.cuh:286-310``, sun direction in
``StateRender.cu:299``).  Here all of that is collected into frozen dataclasses
so a single config object defines a world + render pipeline.

Field for field the same dataclasses and ``config_*`` presets as
``rvgrt_tpu/config.py`` (one config means the same thing in both packages);
the only addition is the power-of-two check on the SDF cell count in
``WorldConfig.validate``.  Comments that name XLA, Pallas or the TPU describe
what a knob does in the JAX package; the PyTorch port reads the same fields.
Every time quoted in a comment here was measured on a TPU v5e for the JAX
package (its rounds 1-5): history that chose the defaults, not a time of
the port.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def _normalize3(v: tuple[float, float, float]) -> tuple[float, float, float]:
    n = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] / n, v[1] / n, v[2] / n)


@dataclass(frozen=True)
class WorldConfig:
    """Voxel world dimensions and derived coarse-grid shapes.

    Mirrors the constants in the reference's ``cumath.cuh`` (SHIX/Y/Z = 12/9/12
    for the 4096x512x4096 world) and ``CoarseArray.cuh`` (COARSENESSSDF=2,
    COARSENESSGI=4, SDF_MAX_DIST=64).  The linear voxel index is
    ``x | y << shift_x | z << (shift_x + shift_y)`` - x fastest - matching
    ``toIndex`` (``cumath.cuh:33-45``).
    """

    shift_x: int = 12
    shift_y: int = 9
    shift_z: int = 12

    sdf_coarseness: int = 2
    gi_coarseness: int = 4
    sdf_max_dist: int = 64

    # Far-field SDF mip (TPU addition, no reference counterpart): the base
    # SDF caps at sdf_max_dist=64 coarse cells, so empty-space jumps top
    # out at 128 fine voxels even when geometry is 1000+ voxels away.  A
    # second distance transform at this fine-voxel coarseness (cheap: the
    # grid is (level/coarseness)^3 smaller) synthesizes conservative far
    # values that saturate the uint8 at 255 (510-voxel jumps) - see
    # sdf.extend_sdf_far.  0 disables (reference-exact `its` counts).
    sdf_far_level: int = 8

    # fillKernel: solid <=> Evaluate(x,y,z) > 0.7 (CArray.cu:27)
    solid_threshold: float = 0.7

    # --- derived sizes ---
    @property
    def size_x(self) -> int:
        return 1 << self.shift_x

    @property
    def size_y(self) -> int:
        return 1 << self.shift_y

    @property
    def size_z(self) -> int:
        return 1 << self.shift_z

    @property
    def num_voxels(self) -> int:
        return self.size_x * self.size_y * self.size_z

    @property
    def num_words(self) -> int:
        """Number of uint32 words in the bit-packed occupancy grid."""
        return self.num_voxels // 32

    @property
    def sdf_size_x(self) -> int:
        return self.size_x // self.sdf_coarseness

    @property
    def sdf_size_y(self) -> int:
        return self.size_y // self.sdf_coarseness

    @property
    def sdf_size_z(self) -> int:
        return self.size_z // self.sdf_coarseness

    @property
    def sdf_num_cells(self) -> int:
        return self.sdf_size_x * self.sdf_size_y * self.sdf_size_z

    @property
    def gi_size_x(self) -> int:
        return self.size_x // self.gi_coarseness

    @property
    def gi_size_y(self) -> int:
        return self.size_y // self.gi_coarseness

    @property
    def gi_size_z(self) -> int:
        return self.size_z // self.gi_coarseness

    @property
    def gi_num_cells(self) -> int:
        return self.gi_size_x * self.gi_size_y * self.gi_size_z

    def validate(self) -> None:
        assert self.size_x % 32 == 0 and 32 % self.sdf_coarseness == 0
        assert self.size_y % self.sdf_coarseness == 0
        assert self.size_z % self.sdf_coarseness == 0
        assert self.size_x % self.gi_coarseness == 0
        assert self.size_y % self.gi_coarseness == 0
        assert self.size_z % self.gi_coarseness == 0
        # the quartered SDF pack of the trace table indexes cells with a
        # mask and a shift by log2(num_cells / 4) (trace.wavefront.
        # _sdf_word_index), which is right only for a power of two
        n = self.sdf_num_cells
        assert n >= 4 and n & (n - 1) == 0, n

    def with_cube(self, shift: int) -> "WorldConfig":
        return dataclasses.replace(self, shift_x=shift, shift_y=shift, shift_z=shift)


@dataclass(frozen=True)
class TerrainConfig:
    """Procedural terrain constants (``TerrainGeneration.cuh:286-310``,
    header version - the ``.cu`` twin with GROUND_LEVEL=140 is dead code)."""

    ground_level: float = 10.0
    plains_amplitude: float = 60.0
    mountain_amplitude: float = 400.0
    biome_frequency: float = 0.005

    surface_octaves: int = 7
    surface_frequency: float = 0.002
    surface_lacunarity: float = 2.1
    surface_persistence: float = 0.45

    cave_octaves: int = 3
    cave_frequency: float = 0.009
    cave_carve_value: float = 2.0
    spaghetti_threshold: float = 0.025
    cavern_region_freq: float = 0.006
    cavern_threshold: float = 0.3

    water_floor_y: float = 30.0  # solid below this (TerrainGeneration.cuh:312)


@dataclass(frozen=True)
class LightingConfig:
    """Sun / sky / water / fog / GI constants.

    sun_dir = normalize(10,5,-4) (``StateRender.cu:299``); sun color (10,9,2)
    HDR (``cumath.cuh:17``); water color/reflectivity (``StateRender.cu:19-20``);
    cone constants (``raytracing_functions.cuh:9-12``); fog
    (``StateRender.cu:140-145``); GI EMA rate (``CoarseArray.cu:339``).
    """

    sun_dir: tuple[float, float, float] = _normalize3((10.0, 5.0, -4.0))
    sun_color: tuple[float, float, float] = (10.0, 9.0, 2.0)
    sky_horizon: tuple[float, float, float] = (0.2, 0.4, 0.8)
    sky_zenith: tuple[float, float, float] = (0.6, 0.8, 1.0)
    sun_disc_cos: float = 0.999

    water_level: float = 31.001
    water_color: tuple[float, float, float] = (0.0, 0.1, 0.3)
    water_reflectivity: float = 0.08

    fog_density: float = 0.0004
    fog_color: tuple[float, float, float] = (0.95, 0.95, 1.0)

    num_cones: int = 6
    cone_angle: float = 0.4
    gi_max_distance: float = 64.0
    gi_step_size: float = 1.5
    gi_strength: float = 0.6
    gi_learning_rate: float = 0.04
    ambient_strength: float = 0.05
    shadow_factor: float = 0.2  # dist-prepass shadow (StateRender.cu:282)

    # SDF-marched soft shadows (BASELINE config-4 feature; an upgrade over
    # the reference's hard 0.2/1.0 shadow trace, and cheaper: ~1 gather per
    # march step vs the hybrid trace's full superstep machine).  Off by
    # default - the reference's shadows are hard.
    soft_shadows: bool = False
    sun_softness: float = 8.0       # penumbra sharpness k in min(k*h/t)
    soft_shadow_steps: int = 16     # fixed unrolled march length
    soft_shadow_max_t: float = 192.0  # voxels; beyond -> lit
    # march every Nth prepass pixel per axis and interpolate (penumbras
    # are low-frequency): stride 2 = 4x fewer shadow gathers
    soft_shadow_stride: int = 1


@dataclass(frozen=True)
class RenderConfig:
    """Per-frame pipeline shapes and tracer iteration budgets.

    Render 1280x800, display (upscaled) 3840x2400 (``State.hpp:28-32``); the
    distance/shadow prepass runs at half render res (``StateRender.cu:310-321``).
    Tracer budgets: 5 major iterations x (<=100 sphere steps, <=200 DDA steps),
    SDF re-probe every 8 DDA steps (``raytracing_functions.cu:105-141``).
    """

    width: int = 1280
    height: int = 800
    display_width: int = 3840
    display_height: int = 2400

    fov_degrees: float = 60.0
    near_plane: float = 0.1
    far_plane: float = 50000.0

    # tracer budgets
    max_major_iterations: int = 5
    max_sphere_steps: int = 100
    max_dda_steps: int = 200
    sdf_probe_interval: int = 8
    # DDA iterations executed per gathered 4x2x4 occupancy brick (VPU bit
    # tests against the cached word); 1 = one gather per DDA step
    dda_substeps: int = 4
    sphere_stop_dist: float = 1.0
    jump_min_dist: int = 2

    # supersteps per convergence check in the wavefront loop (2 measured
    # best: a retired tile stops ~2 supersteps sooner, and every superstep
    # costs the full lane budget)
    steps_per_check: int = 2

    # slim superstep carry: drop the 3 tMax arrays from the while-loop
    # carry (recompute them each superstep from the frozen DDA-entry
    # position and the current cell - algebraically the same value) and
    # re-derive the 6 direction invariants (1/|d|, sign) in-body behind an
    # optimization barrier instead of re-reading them from HBM.  The
    # superstep cost is HBM-bound (PERF.md: ~20 ns/lane-step vs 7.5 ns
    # for the gather alone), so carry bytes are the tax.  Deviation class:
    # recomputed tMax differs from the incremental value by float
    # rounding, which can flip the axis pick at exact voxel-corner ties -
    # same class as the fast-trace cadence (hits/normals gated at the
    # image level).  Default off: golden tests keep the reference
    # bit-exact incremental carry.
    slim_carry: bool = False

    # start-distance cascade: trace 1/(2*prepass_cascade) of full res from
    # scratch, feed a conservative min-neighborhood start to the half-res
    # prepass (the same idea as the reference's minDist, one level deeper);
    # 0/1 disables
    prepass_cascade: int = 4

    # target retirement-tile size (rows x cols) for the wavefront tracer:
    # the image is cut into tiles (lax.map) and each tile's superstep loop
    # exits when ITS rays converge, so stragglers only stall their own
    # tile.  128 cols = one TPU vreg lane span (zero padding waste);
    # 20x128 measured best at 720p (531 -> 264 ms primary trace).
    trace_tile_rows: int = 20
    trace_tile_cols: int = 128

    # wavefront tracer: hard cap on supersteps (worst case in the reference
    # is 5 * (100 + 200 * 9/8) with probe supersteps; real rays converge in
    # tens of steps)
    max_supersteps: int = 2048

    # Fused Pallas superstep (ops/superstep_kernel.py): run the tracer's
    # per-superstep masked state machine (sphere march + SDF probe/jump +
    # DDA substeps) as ONE Mosaic kernel with the whole tile state in
    # VMEM; only the combined-table gather stays in XLA (the Mosaic
    # dynamic-gather census, PERF.md round-3: arbitrary HBM gathers
    # cannot lower).  Bit-exact vs the XLA body by construction (same
    # jnp ops, gated in tests/test_trace.py).  Probe A/B:
    # scripts/probe_r29_superstep.py; default per PERF.md round-5.
    # Unsupported combinations (volume z_edges, slim_carry) fall back
    # to the XLA body.
    # In this port the field has no effect and is kept only so that the
    # two packages' configs match field for field: every superstep goes
    # through K1's wrapper (ops/superstep_kernel.py), the CUDA kernel on a
    # GPU and its plain version on the CPU.
    fused_superstep: bool = False

    # straggler respite (wavefront._trace_two_phase): > 0 = run every lane
    # for at most this many supersteps, then compact the unfinished rays
    # into dense tiles and finish them at full budget.  Tile retirement
    # pays the tile's WORST lane, and silhouette-grazing stragglers run
    # 100+ supersteps while the tile mean needs ~10 (a measured 4-5x tax
    # at 1280x800/1024^3).  Hit flags/normals match single-phase exactly,
    # positions/UVs to fp tolerance; ``its`` drifts by the documented
    # resume re-entry accounting, so the default is off wherever
    # reference-exact its matters (golden tests).  straggler_cap_frac
    # bounds the phase-2 buffer (2.5x margin over observed straggler
    # fractions).
    straggler_budget: int = 0
    straggler_cap_frac: float = 0.25

    miss_distance: float = 300.0  # distApproximationKernel miss (StateRender.cu:276)
    dist_bias: float = 8.0        # conservative bias (StateRender.cu:284)

    # --- GI gather quality/speed knobs (deliberate TPU improvements over
    # the reference's per-pixel full-res cone marching; GI is low-frequency,
    # so a strided gather + geometry-aware upsample is visually equivalent
    # at a fraction of the gather cost) ---
    # cone-march every Nth pixel per axis, then joint (depth+normal)
    # upsample; 1 = the reference's per-pixel behavior.  Measured at 720p
    # (512^3): d=4 keeps 38.9 dB PSNR vs the exact path at ~1/16 the
    # cone-gather cost.
    gi_res_divisor: int = 4
    # fuse radiance + occlusion into one gather table (halves cone
    # gathers).  Off by default: quantizing the occlusion sample to GI
    # cells costs ~19 dB near surfaces, and at gi_res_divisor=4 the cone
    # gathers are no longer dominant (53 ms saved at 720p).
    gi_fused_cone: bool = False
    # relative hit-distance tolerance for upsample sample reuse
    gi_depth_threshold: float = 0.08
    # dispatch the GI frame as three small jits (GI update / base frame +
    # G-buffer / GI composite) instead of one fused graph: XLA's TPU
    # scheduler is bimodal on the big graph (~2x slow mode); the small
    # graphs reliably land the fast schedule (832 -> ~500 ms measured at
    # 720p/512^3, PERF.md).  Outputs match to float addition-order.
    gi_split_dispatch: bool = True

    # distance/shadow prepass resolution divisor.  2 = the reference's
    # half-res distApproximationKernel (StateRender.cu:310-321, bit-exact
    # upsample semantics preserved).  4 = quarter-res prepass, a TPU perf
    # tier (probe_r9: the prepass trace is ~165 ms at 1280x800/1024^3
    # while primary supersteps are nearly insensitive to start tightness -
    # 17.4 with half-res minDist starts vs 19.9 with 8x-coarser cascade
    # starts); start/shadow upsamples switch to the conservative
    # {-1,0,1,2}-window min / even-anchored linear expand, image-gated in
    # tests/test_render.py.
    prepass_divisor: int = 2

    # Soft-shadow sites decoupled from the prepass grid (0 = coupled,
    # the reference shape: shadows estimated at the prepass pixels,
    # StateRender.cu:276-283).  s > 0: the prepass skips its shadow work
    # entirely and the SDF penumbra march runs from every s-th FULL-RES
    # primary hit instead (true hit points - no prepass/primary
    # silhouette mismatch), linearly expanded between sites.  Unlocks
    # prepass_divisor 8: the prepass then only provides conservative
    # start distances, whose quality the primary is nearly insensitive
    # to (probe_r9), without halving the shadow site density.  Only
    # meaningful with LightingConfig.soft_shadows.
    shadow_site_divisor: int = 0

    @property
    def half_width(self) -> int:
        return self.width // self.prepass_divisor

    @property
    def half_height(self) -> int:
        return self.height // self.prepass_divisor


@dataclass(frozen=True)
class EngineConfig:
    world: WorldConfig = WorldConfig()
    terrain: TerrainConfig = TerrainConfig()
    lighting: LightingConfig = LightingConfig()
    render: RenderConfig = RenderConfig()

    # GI cells progressively updated per frame.  The reference updates a
    # fixed RAYPS = 64^3 window of its 1024x128x1024-cell grid, i.e. a
    # full sweep every 512 frames (CoarseArray.cu:372-394).  The
    # user-visible behavior is the sweep PERIOD (radiance refresh
    # latency in frames), not the absolute ray count - so the default
    # (-1) derives the window as ceil(gi_num_cells / 512), matching the
    # reference's convergence rate at every world size instead of
    # overspending 16x on smaller grids (measured 728 ms/frame at 1024^3
    # with the absolute window vs ~100 ms reference-relative).  Set a
    # positive value to pin the absolute count.
    gi_rays_per_frame: int = -1

    # full-sweep period in frames for the derived window (reference: 512)
    gi_sweep_frames: int = 512

    # straggler respite for the GI update's rays (wavefront two-phase,
    # RenderConfig.straggler_budget semantics, applied to the GI traces
    # only).  Random-direction bounce rays are the engine's most
    # tile-divergent population - exactly the heavy tail the two-phase
    # machinery was kept for: measured 689 -> 334 ms per 262K-cell window
    # at 2048^3 (PERF.md).  Camera rays keep their own (default-off)
    # knob: the same mechanism measured NEGATIVE there.  Hit flags match
    # single-phase exactly; positions/UVs to fp tolerance - which is why
    # the DEFAULT is 0 (reference cadence everywhere, incl. stages 1-4);
    # the perf tiers (config_stage5, bench) opt in at 12.
    gi_straggler_budget: int = 0

    # GI init lattice stride (x, z): trace one sun ray per (sx*sz)-cell
    # block and replicate (gi/update.init_gi_strided), instead of the
    # reference's one ray per cell (InitialGlobalIlluminate,
    # CoarseArray.cu:211-245).  Sunlit-ness is spatially smooth and the
    # progressive sweep re-traces every cell within gi_sweep_frames, so
    # this is a startup-latency lever (VERDICT r2 #8), image-gated in
    # tests/test_world.py.  (1, 1) = reference-exact.
    gi_init_stride: tuple = (1, 1)

    # GI init algorithm: "traced" = one sun-shadow ray per lattice cell
    # (InitialGlobalIlluminate, CoarseArray.cu:211-245; honors
    # gi_init_stride); "heightfield" = ray-free horizon-mapping init
    # (gi/update.init_gi_heightfield): O(log height) shifted-max passes
    # over the 2-D column-height map instead of 134M traces at the
    # reference world - the startup-latency lever for seconds-scale world
    # builds.  Differences vs traced are confined to sun-facing cave
    # mouths/overhangs (mismatch fraction gated in tests/test_world.py);
    # the progressive sweep re-traces every cell within gi_sweep_frames.
    gi_init_mode: str = "traced"

    @property
    def gi_window(self) -> int:
        """Resolved GI cells-per-frame window."""
        cells = self.world.gi_num_cells
        n = self.gi_rays_per_frame
        if n < 0:
            n = -(-cells // self.gi_sweep_frames)
        return min(n, cells)


# The five staged benchmark configs from BASELINE.json.
def config_stage1() -> EngineConfig:
    """256^3 world, 320x240 primary-rays-only DDA."""
    return EngineConfig(
        world=WorldConfig().with_cube(8),
        render=dataclasses.replace(RenderConfig(), width=320, height=240),
    )


def config_stage2() -> EngineConfig:
    """512^3 world, texturepack + hard shadows, 720p."""
    return EngineConfig(
        world=WorldConfig().with_cube(9),
        render=dataclasses.replace(RenderConfig(), width=1280, height=720),
    )


def config_stage3() -> EngineConfig:
    """1024^3 world, hybrid SDF+DDA, 1080p - the headline config."""
    return EngineConfig(
        world=WorldConfig().with_cube(10),
        render=dataclasses.replace(RenderConfig(), width=1920, height=1080),
        gi_rays_per_frame=64 * 64 * 64,
    )


def config_stage4() -> EngineConfig:
    """1024^3 + VCT GI, soft shadows, reflections at 1080p
    (BASELINE config 4 names soft shadows; SDF-penumbra march)."""
    base = config_stage3()
    return dataclasses.replace(
        base, lighting=dataclasses.replace(base.lighting,
                                           soft_shadows=True,
                                           soft_shadow_stride=2))


def config_stage5() -> EngineConfig:
    """2048^3 streaming world, low-res primary + temporal upscale to 4K.

    The perf-first tier: carries the TPU-tuned cadence the bench headline
    runs (tuned on a TPU v5e, rounds 1-5) - SDF-marched soft shadows at
    stride 2 (25x cheaper than the hard-shadow trace on the TPU; BASELINE
    config-4's shadow
    model), 6 DDA substeps per brick gather (bit-exact), SDF probe every
    16 steps + 4-voxel start bias (delta 1/1M hit flags + 274/1M normals
    vs reference cadence), stride-8 cone sites.  Stages 1-4 keep the
    reference cadence.
    """
    return EngineConfig(
        world=WorldConfig().with_cube(11),
        render=dataclasses.replace(
            RenderConfig(), width=1280, height=800,
            display_width=3840, display_height=2400,
            dda_substeps=6, sdf_probe_interval=16, dist_bias=4.0,
            gi_res_divisor=8,
        ),
        lighting=dataclasses.replace(LightingConfig(), soft_shadows=True,
                                     soft_shadow_stride=2),
        gi_straggler_budget=12,
        # ray-free horizon-mapping GI init (gated vs traced in
        # tests/test_world.py): the traced init costs 51 s of the 87 s
        # 2048^3 build and the progressive sweep re-traces every cell
        # within gi_sweep_frames anyway (round-5 build census, PERF.md)
        gi_init_mode="heightfield",
    )


def config_reference() -> EngineConfig:
    """The reference's own 4096x512x4096 world at 1280x800."""
    return EngineConfig()
