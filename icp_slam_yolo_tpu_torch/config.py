"""Static configuration for the SLAM pipeline (PyTorch port).

A verbatim copy of the JAX package's ``config.py`` dataclasses, presets and
constants: the port imports nothing of ``icp_slam_yolo_tpu``, and
``tests/test_torch_ops.py`` asserts that every preset of the two copies is
equal field for field, so they cannot drift.  Comments below that speak of
``lax.cond``, ``vmap`` or Pallas describe the JAX package's behaviour; in the
port ``backend="auto"`` means the CUDA kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor.

Units are millimetres (like the reference) at the API surface; the registration
core rescales to metres internally for float32 precision.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GateConfig:
    """Polar-scan gating rules (reference `process.py:38-52` and variants).

    A raw scan row is ``[quality, angle_deg, distance_mm]``.  A point is kept iff
    ``min_dist < d < max_dist``, ``quality > min_quality`` and (when
    ``front_arc_only``) the angle lies in the front 270-degree arc
    (``angle <= 135 or angle >= 225``).  Cartesian conversion is
    ``x = d*cos(a)``, ``y = -d*sin(a)`` (`process.py:47-50`).
    """

    min_dist_mm: float = 0.0
    max_dist_mm: float = 10000.0
    min_quality: float = 13.0
    front_arc_only: bool = True
    front_arc_lo_deg: float = 135.0
    front_arc_hi_deg: float = 225.0
    y_sign: float = -1.0  # `process.py:49` uses y = -d sin(a); `b.py:176` uses +


# Realtime gates (`process.py:44-46`): 1000 < d < 9000, q > 10.
REALTIME_GATE = GateConfig(min_dist_mm=1000.0, max_dist_mm=9000.0, min_quality=10.0)
# Offline gates (`slam_offline.py:70-71`): 0 < d < 10000, q > 13.
OFFLINE_GATE = GateConfig(min_dist_mm=0.0, max_dist_mm=10000.0, min_quality=13.0)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Map geometry (reference `Config.py:7-9,22-23`): 30 m x 25 m @ 30 mm/px.

    Pixel convention (`process.py:131-132`): ``px = cx + x/res``,
    ``py = cy - y/res`` with the centre at ``(W//2, H//2)``.
    """

    width_mm: float = 30000.0
    height_mm: float = 25000.0
    resolution_mm_per_px: float = 30.0

    @property
    def width_px(self) -> int:
        return int(self.width_mm / self.resolution_mm_per_px)

    @property
    def height_px(self) -> int:
        return int(self.height_mm / self.resolution_mm_per_px)

    @property
    def center_px(self) -> tuple[int, int]:
        return (self.width_px // 2, self.height_px // 2)


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Registration parameters (reference `Config.py:10-12`, `slam_offline.py:22-24`).

    The reference runs Open3D GICP with a correspondence threshold, a voxel
    pre-downsample and ``max_iteration=50`` (`gicp_lidar.py:12-36`).  Ours is a
    masked point-to-point ICP (closed-form 2-D Kabsch) with correspondence
    gating at ``threshold_mm``, which plays the same role; `estimator` selects
    "point_to_point" or "point_to_plane".
    """

    voxel_size_mm: float = 20.0
    threshold_mm: float = 200.0
    max_iterations: int = 50
    max_rmse: float = 50.0          # accept gate (`Config.py:12`, `mainn.py:316`)
    min_points: int = 10            # `gicp_lidar.py:13`
    tolerance: float = 1e-5         # convergence on mean-error delta (`icp.py:50`)
    estimator: str = "point_to_point"  # | "point_to_plane" | "gicp"
    gicp_k: int = 20                # covariance neighbourhood (`gicp_lidar.py:23-27` max_nn)
    gicp_epsilon: float = 1e-3      # Segal plane-to-plane eigenvalue floor
    rescue_estimator: str = ""      # "" = off.  When set (e.g. "gicp"), a scan
    # the primary estimator REJECTS is re-registered with this estimator under
    # `lax.cond` — in the sequential replay the taken-branch semantics mean the
    # expensive rescue only ever runs on the ~1-5% rejected scans.  (Under
    # vmap, cond lowers to select and both branches run: leave off for fleets.)
    huber_delta_mm: float = 0.0     # 0 disables robust weighting
    anderson: bool = False          # Anderson(1) acceleration of the pose
    # fixed-point iteration (AA-ICP, arxiv 1709.05479): extrapolate through
    # the last two plain iterates with the residual-minimising coefficient.
    # Same fixpoint (the convergence criterion is unchanged), ~2x fewer
    # iterations on the replay workload.  Default off = reference-faithful
    # plain iteration.
    backend: str = "auto"           # "auto" | "xla" | "fused" (single Pallas kernel)
    early_exit: bool = True         # stop fused kernel at convergence.  Safe
    # (and fast) under vmap too: `icp_fused_pallas` is custom_vmap-batched
    # into ONE kernel instance whose internal per-robot loops branch
    # independently (scalar branches never lower to select inside the
    # kernel) — only XLA-level lax.cond (e.g. rescue_estimator) lowers to
    # select under vmap.


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    """Occupancy-grid update rules (reference `process.py:114-179`).

    Probabilities start at 0.5; along each robot->point ray the body cells decay
    ``p *= p_free_decay`` and the endpoint gets ``p = min(1, p + p_occ_inc)``;
    a ray stops early at the first body cell with ``p >= block_threshold``.
    Updates are restricted to a ``(2*window_px)``-wide window around the robot.
    ``free_threshold`` drives point filtering/pruning (`process.py:203-249`).

    ``max_ray_px`` is the static sample budget per ray: the window bound means a
    Bresenham line has at most ``window_px + 1`` cells, so 144 covers the
    default 140-px window (sample count feeds the one-hot raster matmuls
    directly, so slack is pure cost).  ``skip_dead_rays`` compacts the rays and
    guards 128-ray blocks behind scalar branches — keep True for sequential
    replay, set False under vmap (cond lowers to select there and both
    branches execute; see `parallel/fleet.py`).
    """

    p_occ_inc: float = 0.2
    p_free_decay: float = 0.9
    block_threshold: float = 0.65
    free_threshold: float = 0.2
    window_px: int = 140
    max_ray_px: int = 144
    skip_dead_rays: bool = True
    prune_window_margin_px: int = -1  # -1 = prune checks every map point
    # against the full grid (exact reference semantics).  >= 0 restricts the
    # prune lookup to the raster window expanded by this margin: cells outside
    # it cannot have changed since the point's last check (occupancy only
    # mutates inside the per-step window, and the margin covers the robot's
    # travel between prunes), so the previous keep-decision stands.  Offline
    # prunes every accepted step (margin >= a few px suffices); realtime
    # prunes every MAP_MAINTENANCE_INTERVAL steps (margin must cover 10 steps
    # of travel: 64 px = 1.92 m at 30 mm/px).  Known 1-px edge case: a
    # downsample-merged point can shift into an already-free cell outside the
    # window and survive one extra interval (self-heals on the next pass).
    backend: str = "auto"  # "auto" | "xla" | "fused": auto uses the fused
    # Pallas raster (`ops/pallas/raster_fused.py`) on TPU when the window fits
    # the kernel's 128-aligned layout, the pure-XLA one-hot path otherwise

    def __post_init__(self):
        # A Bresenham line clipped to the window has at most window_px + 1
        # cells; a smaller sample budget silently truncates rays and drops
        # endpoint updates, corrupting the occupancy map.
        if self.max_ray_px <= self.window_px:
            raise ValueError(
                f"max_ray_px ({self.max_ray_px}) must exceed window_px "
                f"({self.window_px}): rays need window_px + 1 samples"
            )


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Full pipeline configuration.

    ``realtime_semantics`` selects the realtime gate behaviour (`mainn.py:316-340`:
    on reject keep pose but still update occupancy) vs the offline behaviour
    (`slam_offline.py:386-391`: on reject skip the whole scan).  The offline
    semantics are the replay target.
    """

    gate: GateConfig = OFFLINE_GATE
    map: MapConfig = MapConfig()
    icp: IcpConfig = IcpConfig()
    occupancy: OccupancyConfig = OccupancyConfig()

    local_map_radius_mm: float = 10000.0   # `slam_offline.py:34`; realtime 9000 (`Config.py:17`)
    min_local_map_points: int = 50         # `Config.py:18`
    dynamic_distance_mm: float = 250.0     # `slam_offline.py:27`; realtime 300 (`Config.py:16`)
    duplicate_voxel_mm: float = 30.0       # `Config.py:15`
    map_downsample_voxel_mm: float = 20.0  # `slam_offline.py:411` uses ICP_VOXEL_SIZE
    map_downsample_trigger: int = 1000     # `slam_offline.py:410`
    outlier_nb_neighbors: int = 30         # `Config.py:13`
    outlier_std_ratio: float = 1.5         # `Config.py:14`
    use_outlier_filter: bool = False       # offline comments it out (`slam_offline.py:357-359`)
    use_duplicate_filter: bool = False     # offline comments it out (`slam_offline.py:394`)
    realtime_semantics: bool = False
    motion_model: bool = False  # constant-velocity ICP init (extrapolate the
    # last inter-scan motion instead of the reference's static current-pose
    # init, `gicp_lidar.py:29`) — fewer ICP iterations and a head start in
    # fast turns; OFF by default for init-parity with the reference
    localization_only: bool = False        # `update_mode=0` (`mainn.py:679-695`):
    # track the pose against a loaded map without inserting points or
    # updating occupancy (the reference flags this mode but never wires it
    # into its loop — here it works)
    reseed_after_rejects: int = 0  # recovery extension beyond the reference:
    # after this many CONSECUTIVE rejected registrations the map is assumed
    # lost (bad seed scan / kidnapped robot) and is rebuilt from the current
    # scan at the held pose, occupancy included.  0 disables (reference
    # behaviour: a poisoned seed map rejects forever — scan_data_3's stale
    # scan_0 costs 368 scans before the trajectory happens to loop back).
    # Sequential replay pays only on the reseed step (lax.cond); leave 0 for
    # vmapped fleets (cond lowers to select there).

    n_max: int = 512          # max points per scan (observed max 405)
    map_capacity: int = 24576  # the reference's saved map has 18908 points
    local_map_capacity: int = 24576  # ICP target buffer size.  Equal to
    # map_capacity = no compaction (default).  Setting it lower speeds up the
    # kernel sweep but silently drops local points once the radius crop
    # outgrows it — only safe when sized generously for the arena.

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


# Offline replay: fused p2p fast path + GICP second-chance registration for
# rejected scans (full-1800 A/B: acceptance 99.33% -> 99.39%, median RMSE
# 20.92 -> 20.68 mm; the rescue only executes on the ~0.7% rejected scans).
# eps=0.1 outperformed Segal's 1e-3 here: 2-D corridor tangents need more
# isotropic anchoring than 3-D planes.
# prune_window_margin_px=32: offline prunes every accepted step, so 32 px
# (~1 m) over one step's travel is airtight; the full-1800 quality gate
# replays identically with it on, and it removes the step's biggest op
# (the full-grid prune lookup over a 24k-point map).
OFFLINE_CONFIG = SlamConfig(
    icp=IcpConfig(rescue_estimator="gicp", gicp_epsilon=0.1),
    occupancy=OccupancyConfig(prune_window_margin_px=32),
)

# Realtime: same GICP second-chance as offline (full-1800 A/B: acceptance
# 95.66% -> 99.61%, median RMSE 18.35 -> 18.29 mm; GICP as the *primary*
# estimator measured worse on both axes — 94.55% and 6.7x slower), plus the
# constant-velocity ICP init (99.61% -> 99.72%, median 18.29 -> 17.80 mm).
# The motion model stays OFF for offline replay: there it measured 99.06%
# vs 99.50% static — the offline dataset's stop-and-turn motion defeats
# linear extrapolation, and static init preserves reference parity.
REALTIME_CONFIG = SlamConfig(
    gate=REALTIME_GATE,
    icp=IcpConfig(threshold_mm=180.0, voxel_size_mm=20.0,   # `Config.py:11,24`
                  rescue_estimator="gicp", gicp_epsilon=0.1),
    # realtime prunes every MAP_MAINTENANCE_INTERVAL (10) steps: the 64 px
    # margin (1.92 m) covers 10 steps of travel at ~190 mm/step
    occupancy=OccupancyConfig(prune_window_margin_px=64),
    motion_model=True,
    # Self-healing safety net: Scan_data_1 scans ~1150-1290 see 5.2 m median
    # range (2x the rest of the run), which doubles per-point tangential noise
    # and runs the segment at median 32 / max 48 mm against the 50 mm gate.
    # A reject cascade there (realtime keeps the pose, so consecutive rejects
    # compound while the robot moves) is one rounding realization away — an
    # insert-path refactor measurably re-rolled 99.7% -> 88.3% acceptance
    # (docs/PERF.md "negative results").  Reseed bounds that tail: it never
    # fires on the healthy realization (6 rejects total, quality identical at
    # 99.67% / 17.5 mm) and caps any cascade at 10 scans.
    reseed_after_rejects=10,
    local_map_radius_mm=9000.0,
    dynamic_distance_mm=300.0,
    map_downsample_voxel_mm=25.0,   # `Config.py:10` ICP_VOXEL_SIZE
    use_outlier_filter=True,        # `mainn.py:291`
    use_duplicate_filter=True,      # `mainn.py:320`
    realtime_semantics=True,
)

# Hardened tracking preset for noisy recordings, calibrated on the reference's
# second dataset (`scan_data_3`, 2,043 scans — whose stale first scan poisons a
# reference-faithful replay: seeded at scan_0 the stock realtime preset tracks
# 67.6%, while scans 1+ chain at ~30 mm pairwise RMSE).  Deltas vs REALTIME,
# each A/B-measured on the full scan_data_3 replay: min_quality 10 -> 13
# (67.6% -> 78.3% acceptance), max_iterations 50 -> 100 (-> 81.6%), and
# reseed-after-10-rejects recovery, which discards a poisoned seed map
# (seeded from a good scan the same config reaches 98.1% @ 18.1 mm median).
ROBUST_CONFIG = REALTIME_CONFIG.replace(
    gate=GateConfig(min_dist_mm=1000.0, max_dist_mm=9000.0, min_quality=13.0),
    icp=dataclasses.replace(REALTIME_CONFIG.icp, max_iterations=100),
    # scan_data_3 moves up to ~204 mm/step, so 10 maintenance steps can
    # exceed the realtime preset's 64 px margin (1.92 m): stale junk then
    # survives the windowed prune, seeds reject clusters, and the reseed
    # recovery fires spuriously (measured: acceptance 99.1% -> 96.2%, final
    # map 21.5k -> 3.3k points).  128 px (3.84 m) restores the invariant.
    occupancy=OccupancyConfig(prune_window_margin_px=128),
    reseed_after_rejects=10,
)

# Fleet preset (BASELINE config 5: "batched multi-robot SLAM over 64 scan
# streams"): REALTIME semantics/filters with every vmap-hostile feature off —
# the GICP rescue's XLA-level lax.cond lowers to select under vmap, so every
# robot would pay the rescue on every scan (sequential replay pays it only on
# the ~0.3% rejected scans).  Realtime keep-pose-on-reject semantics also make
# the motion model safe WITHOUT the rescue: on this dataset it tracks 99.6%
# where offline skip-on-reject semantics collapse to 67% (a rejected
# extrapolation cascades when the map stops updating).  Deltas vs REALTIME,
# each measured on the full 1800-scan replay (docs/PERF.md "Fleet"):
#   * tolerance 1e-2 (10 um of pose delta; the reference's 1e-5 is 10 nm):
#     acceptance 99.67% -> 99.56%, median 17.48 -> 17.40 mm, fleet +13%.
#   * fused raster + tile-shaped grid (1024 x 864 px covering the same
#     arena): enables the DMA-window grid kernel — the XLA window
#     extract/write-back serializes per robot under vmap.
#   * skip_dead_rays off (its lax.cond lowers to select under vmap).
FLEET_CONFIG = REALTIME_CONFIG.replace(
    icp=dataclasses.replace(REALTIME_CONFIG.icp, rescue_estimator="", tolerance=1e-2),
    map=MapConfig(width_mm=30720.0, height_mm=25920.0),
    occupancy=OccupancyConfig(
        skip_dead_rays=False, backend="fused", prune_window_margin_px=64
    ),
    # reseed's lax.cond lowers to select under vmap: every lane would pay the
    # full map + occupancy rebuild every step.  Fleets keep recovery OFF.
    reseed_after_rejects=0,
)

# Per-script realtime variants (the reference tunes constants per file,
# SURVEY.md section 2.3): presets capture each script's gates and map geometry.
REALTIME_B_CONFIG = REALTIME_CONFIG.replace(
    # `duc/code python/b.py:164-179`: q > 5, y = +d sin(a); 20 m map @ 20 mm
    gate=GateConfig(min_dist_mm=1000.0, max_dist_mm=9000.0, min_quality=5.0, y_sign=1.0),
    map=MapConfig(width_mm=20000.0, height_mm=20000.0, resolution_mm_per_px=20.0),
)
REALTIME_1_CONFIG = REALTIME_CONFIG.replace(
    # `realtime_1.py:157-169`: no front-arc filter, d < 5000; 5 m map @ 5 mm
    gate=GateConfig(min_dist_mm=0.0, max_dist_mm=5000.0, min_quality=10.0, front_arc_only=False),
    map=MapConfig(width_mm=5000.0, height_mm=5000.0, resolution_mm_per_px=5.0),
    # at 5 mm/px the inherited 64 px margin is only 0.32 m — NOT enough to
    # cover 10 steps of travel, so this preset keeps the exact full-grid prune
    occupancy=OccupancyConfig(prune_window_margin_px=-1),
)
REALTIME_2_CONFIG = REALTIME_CONFIG  # `realtime_2.py` uses the 30 m @ 30 mm geometry

# Named preset registry (the reference's per-script constant blocks;
# SURVEY.md section 2.3) — `cli replay/serve --preset` look configs up here.
PRESETS = {
    "offline": OFFLINE_CONFIG,
    "realtime": REALTIME_CONFIG,
    "robust": ROBUST_CONFIG,              # hardened tracking (see above)
    "fleet": FLEET_CONFIG,                # vmap-safe multi-robot preset
    "realtime_b": REALTIME_B_CONFIG,      # `duc/code python/b.py`
    "realtime_1": REALTIME_1_CONFIG,      # `realtime_1.py`
    "realtime_2": REALTIME_2_CONFIG,      # `realtime_2.py`
}

# Stereo camera intrinsics (reference `Config.py:27-30`).
STEREO_F = 381.0
STEREO_CX = 320.0
STEREO_CY = 240.0
STEREO_BASELINE = 26.0

CAMERA_TRIGGER_DISTANCE_MM = 1000.0  # `Config.py:25`
MAP_MAINTENANCE_INTERVAL = 10        # `Config.py:26`
ROBOT_AXIS_LENGTH_MM = 300.0         # `Config.py:19`
