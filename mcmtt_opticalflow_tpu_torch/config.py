"""Runtime configuration for the tracking engine.

Replaces the reference's two-tier config (compile-time #defines in
psn_where/PSNWhere_Defines.h:7-86 plus the partially-consumed parameters.txt,
psn_where/helpers/ParameterParser.cpp:19-67) with one set of runtime
dataclasses.  Most numeric defaults mirror the reference's tuning constants
(cited per field); crucially, the camera count is a *runtime* value here,
whereas the reference bakes NUM_CAM in at compile time
(psn_where/PSNWhere_Defines.h:36-59).

All length units are millimetres, matching the reference.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Tracker2DConfig:
    """Per-camera 2D tracklet generation (ref psn_where/PSNWhere_Tracker2D.cpp:10-42)."""

    # capacities (TPU static shapes; the reference uses unbounded containers)
    max_detections: int = 32          # per camera per frame
    max_trackers: int = 64            # live 2D trackers per camera
    max_features: int = 64            # ref caps at 100 (PSN_2D_FEATURE_MAX_NUM_TRACK,
    #                                   Tracker2D.cpp:13); 64 keeps lanes aligned
    min_features: int = 4             # PSN_2D_FEATURE_MIN_NUM_TRACK Tracker2D.cpp:12
    backtrack_interval: int = 4       # PSN_2D_BACKTRACKING_INTERVAL Tracker2D.cpp:16
    max_tracklet_length: int = 3      # PSN_2D_MAX_TRACKLET_LENGTH Tracker2D.cpp:10

    # Lucas-Kanade
    lk_window: int = 16               # fixed LK window (TPU-friendly; ref scales the
    #                                   window with box width, Tracker2D.cpp:776-782)
    lk_pyramid_levels: int = 3
    lk_iterations: int = 10           # ref TermCriteria 20 iters + 0.03 eps
    #                                   early-out, Tracker2D.cpp:145.  The
    #                                   TPU path runs a FIXED Newton count
    #                                   (compile-once, no data-dependent
    #                                   loop exit), so there is no eps knob.
    feature_quality_level: float = 0.01

    # validation gates
    min_height_mm: float = 1400.0     # PSN_2D_MIN_HEIGHT Tracker2D.cpp:21
    max_height_mm: float = 2300.0     # PSN_2D_MAX_HEIGHT Tracker2D.cpp:20
    max_box_distance: float = 1.0     # PSN_2D_BOX_MAX_DISTANCE Tracker2D.cpp:22
    max_detection_distance_mm: float = 600.0   # Tracker2D.cpp:23
    max_height_difference_mm: float = 400.0    # Tracker2D.cpp:24
    max_box_center_diff_ratio: float = 0.5     # Tracker2D.cpp:25
    min_overlap_ratio: float = 0.3             # Tracker2D.cpp:26
    min_flow_majority_ratio: float = 0.5       # Tracker2D.cpp:28

    # LocalSearchKLT disparity voting (Tracker2D.cpp:452-454)
    klt_min_movement: float = 0.1
    klt_neighbor_window_ratio: float = 0.2


@dataclasses.dataclass(frozen=True)
class Associator3DConfig:
    """3D MHT association (ref psn_where/PSNWhere_Associator3D.cpp:18-99)."""

    # optimisation window
    proc_window_size: int = 10        # PROC_WINDOW_SIZE Associator3D.cpp:21
    k_best_size: int = 50             # K_BEST_SIZE Associator3D.cpp:22
    max_track_in_optimization: int = 2000   # Associator3D.cpp:23
    max_track_in_unconfirmed_tree: int = 2  # Associator3D.cpp:24
    num_frames_for_confirmation: int = 3    # Associator3D.cpp:25

    # reconstruction
    min_tracklet_length: int = 1      # Associator3D.cpp:29; a deactivated
    #                                   tracklet shorter than this kills its
    #                                   track's whole branch (ref :1399-1404)
    max_tracklet_distance: float = 2000.0  # MAX_TRACKLET_DISTANCE Associator3D.cpp:31
    max_body_width: float = 2000.0    # MAX_BODY_WIDHT Associator3D.cpp:41
    min_target_proximity: float = 200.0    # Associator3D.cpp:44
    default_height: float = 1700.0    # DEFAULT_HEIGHT Associator3D.cpp:46;
    #                                   body-height pad of the visibility
    #                                   test feeding the FP/FN likelihood
    #                                   ratios (ref CheckVisibility :718-733)
    detection_mode: str = "full_body"  # "full_body" (PETS) or "head"; ref
    #                                    PSN_DETECTION_TYPE, Defines.h:37
    consider_sensitivity: bool = False     # CONSIDER_SENSITIVITY Associator3D.cpp:48
    max_sensitivity_error: float = 20.0    # Associator3D.cpp:32

    # linking
    min_linking_probability: float = 1.0e-6  # Associator3D.cpp:51
    max_time_jump: int = 9            # MAX_TIME_JUMP Associator3D.cpp:52
    max_moving_speed: float = 900.0   # mm/frame, Associator3D.cpp:90
    min_moving_speed: float = 100.0   # Associator3D.cpp:91
    # NOTE: the reference also #defines MAX_TRACKLET_LENGTH (:30),
    # MIN_CONSTRUCT_PROBABILITY (:62), DATASET_FRAME_RATE (:88) and
    # COST_TRACKLET_LINK_COEF (:59, consumed only by the never-called
    # ComputeTrackletLinkCost :2330) — all dead constants there, so they
    # are intentionally NOT config fields here.

    # appearance
    num_rgb_bins: int = 16            # NUM_BINS_RGB_HISTOGRAM Associator3D.cpp:95
    cost_rgb_min_dist: float = 0.2    # Associator3D.cpp:55
    cost_rgb_coef: float = 100.0      # Associator3D.cpp:56
    cost_rgb_decay: float = 0.1       # Associator3D.cpp:57

    # tracklet linking
    cost_tracklet_link_min_dist: float = 1500.0  # Associator3D.cpp:58
    e_det: float = 4.0                # E_DET Associator3D.cpp:79
    e_cal: float = 500.0              # E_CAL Associator3D.cpp:80

    # detection likelihood
    fp_rate: float = 0.05             # FP_RATE Associator3D.cpp:63
    fn_rate: float = 0.1              # FN_RATE Associator3D.cpp:64

    # enter/exit
    enter_penalty_free_length: int = 2      # Associator3D.cpp:67
    boundary_distance: float = 700.0        # Associator3D.cpp:68
    p_en_max: float = 1.0e-3                # Associator3D.cpp:69
    p_ex_max: float = 1.0e-6                # Associator3D.cpp:70
    p_en_decay: float = 1.0e-3              # Associator3D.cpp:71
    p_ex_decay_dist: float = 1.0e-3         # Associator3D.cpp:72
    p_ex_decay_length: float = 1.0e-2       # Associator3D.cpp:73
    cost_enter_max: float = 200.0           # Associator3D.cpp:74
    cost_exit_max: float = 200.0            # Associator3D.cpp:75
    max_outpoint: int = 3                   # Associator3D.cpp:76

    # smoothing (ref PSNWhere_SGSmooth.h:15-16)
    sg_span: int = 9
    sg_degree: int = 1

    # combination-enumeration ceiling (seeds): the reference enumerates
    # EVERY gated combination with no cap (ref GenerateTrackletCombinations
    # Associator3D.cpp:1283-1336); the distance gating keeps the true
    # space small, so this only guards pathological frames.  Truncation
    # is counted (Associator3D.seed_combos_truncated).
    max_seed_combinations: int = 8192

    # branch-candidate budget per frame, spent in (-gt_prob, cost) order.
    # New this engine: the solver pool is capped at SolverConfig.
    # max_vertices anyway, so generating more candidates than can ever
    # enter a hypothesis burns host time cloning tracks that the next
    # prune deletes (the reference enumerates unboundedly and relies on
    # pruning, ref Associator3D.cpp:1832-2242 + 2959-2994)
    max_branches_per_frame: int = 256

    # ---- candidate-population containment (new this engine) --------------
    # The reference births every feasible seed/branch and only prunes
    # after the fact (GTP prune, ref Associator3D.cpp:2959-2994) — viable
    # on CPU with ~8 PETS targets, but at 20+ targets with synchronized
    # tracklet rotations the unconfirmed-tree population multiplies every
    # host sweep and starves the per-frame branch budget.  Containment
    # happens at ADMISSION instead:
    #
    # seeds_per_cluster: among same-frame seed candidates whose
    # reconstruction points lie within min_target_proximity of each other
    # (mutually incompatible in the solver anyway, ref :2470-2489), only
    # the best-birth-cost few are admitted.  The camera-subset combos of
    # one target collapse onto its position cluster, so this keeps the
    # best one or two interpretations per spatial location.
    seeds_per_cluster: int = 2
    # global new-tree cap per frame, spent in birth-cost order
    max_new_tracks_per_frame: int = 256
    # per-paused-track cap on temporal resume branches (closest seeds
    # first): spreads the global branch budget across ALL paused tracks
    # instead of letting the best-ranked few consume it on every feasible
    # seed pairing (identity continuity at density needs every real
    # target's pause to get its resume candidate).  3 (round-5 sweep on
    # the driver bench scene): resumes SPAN the pause seam, so deferred
    # windows keep past coverage of re-identified targets — at 2 the
    # driver-measured MOTA DECREASED with window depth
    # (0.8206/0.817/0.8108 at w0/3/6); at 3 it increases strictly
    # (0.8317/0.8452/0.8477) at ~5% throughput cost; 4 adds +0.004 w6
    # MOTA for another ~6% throughput
    temporal_branches_per_track: int = 3
    # per-track cap on same-frame spatial branch alternatives (best
    # reconstruction/link first), same budget-spreading rationale
    spatial_branches_per_track: int = 8
    # hard cap on concurrently alive unconfirmed trees (rank-pruned by
    # their best track's (-gt_prob, cost)); bounds the registry at
    # pathological densities — the admission gates above keep it slack
    # in normal operation
    max_unconfirmed_trees: int = 512


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched-replica BLS maximum-weight-clique solver
    (ref psn_where/GraphSolver.cpp:526-553 + 986-1184)."""

    num_replicas: int = 8             # parallel restarts (ref is one serial chain)
    max_vertices: int = 256           # padded graph capacity per solve
    max_iterations: int = 2000        # BLS_MAX_ITERATION GraphSolver.cpp:531.
    #                                   The ref's edge-count-scaled budget
    #                                   min(max(200, 10|E|), 2000)
    #                                   (GraphSolver.cpp:548-553) is a
    #                                   dynamic loop bound — TPU programs
    #                                   use this FIXED budget instead
    #                                   (iteration count is a static jit
    #                                   argument; replica warm starts make
    #                                   far fewer moves sufficient)
    t_nonimprove: int = 10            # BLS_T GraphSolver.cpp:528
    p0: float = 0.75                  # BLS_P0 GraphSolver.cpp:527
    phi: int = 7                      # BLS_PHI (tabu tenure base) GraphSolver.cpp:529
    l0_ratio: float = 0.01            # L0 = 0.01|V|, GraphSolver.cpp:542
    lmax_ratio: float = 0.10          # Lmax = 0.10|V|, GraphSolver.cpp:543
    alpha_r: float = 0.8              # GraphSolver.cpp:545
    alpha_s: float = 0.8              # GraphSolver.cpp:544
    solutions_per_replica: int = 16   # local-optima ring buffer per replica
    unroll: int = 1                   # BLS moves per while-loop trip.
    #                                   Measured on v5e (scripts/
    #                                   tpu_solver_prof2.py): the 150-move
    #                                   solve is ~12 ms at unroll 1 AND 8 —
    #                                   the loop is not latency-bound — so
    #                                   the default avoids the ~8x bigger
    #                                   loop body at compile time
    solve_batch: int = 16             # instances per vmapped solve_mwcp_batch
    #                                   call (microbench/ad-hoc batching; the
    #                                   engine's fused per-frame path instead
    #                                   solves ONE instance whose replica
    #                                   count is num_replicas + k_best_size —
    #                                   every carried hypothesis warm-starts
    #                                   a replica)
    seed: int = 0                     # deterministic (ref uses rand())


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """CLEAR-MOT evaluation (ref psn_where/Evaluator.cpp + Defines.h:82-86)."""

    crop_zone: Tuple[float, float, float, float] = (
        -14069.6, -14274.0, 4981.3, 1733.5)   # (xmin, ymin, xmax, ymax), Defines.h:82-85
    crop_margin: float = 1000.0       # CROP_ZONE_MARGIN Defines.h:86; also the
    #                                   CLEAR-MOT match radius (Evaluator.cpp:9,530)
    deferred_windows: int = 11        # evaluators for deferred output 0..10
    #                                   (Associator3D.cpp:282-286)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration."""

    num_cameras: int = 4              # RUNTIME value (ref: compile-time NUM_CAM)
    cam_ids: Optional[Tuple[int, ...]] = None   # dataset camera ids, e.g. (1, 5, 7)
    image_width: int = 768            # PETS2009 frame size
    image_height: int = 576
    start_frame: int = 0
    end_frame: int = 794

    tracker2d: Tracker2DConfig = dataclasses.field(default_factory=Tracker2DConfig)
    assoc3d: Associator3DConfig = dataclasses.field(default_factory=Associator3DConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    def resolved_cam_ids(self) -> Tuple[int, ...]:
        if self.cam_ids is not None:
            return tuple(self.cam_ids)
        return tuple(range(self.num_cameras))

    # ---- (de)serialisation -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "EngineConfig":
        raw = json.loads(text)

        def build(cls, d):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in d.items() if k in names})

        sub = {
            "tracker2d": build(Tracker2DConfig, raw.pop("tracker2d", {})),
            "assoc3d": build(Associator3DConfig, raw.pop("assoc3d", {})),
            "solver": build(SolverConfig, raw.pop("solver", {})),
            "eval": build(EvalConfig, raw.pop("eval", {})),
        }
        raw.pop("cam_ids", None) if raw.get("cam_ids") is None else None
        names = {f.name for f in dataclasses.fields(EngineConfig)}
        top = {k: v for k, v in raw.items() if k in names and k not in sub}
        if isinstance(top.get("cam_ids"), list):
            top["cam_ids"] = tuple(top["cam_ids"])
        if isinstance(top.get("eval"), dict):
            top.pop("eval")
        return EngineConfig(**{**top, **sub})


def parse_parameters_txt(text: str) -> dict:
    """Parse the reference's key=value parameters.txt format
    ('%' comment lines, comma-separated int arrays)
    (ref psn_where/helpers/ParameterParser.cpp:19-67)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("%"):
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if "," in value:
            try:
                out[key] = [int(v) for v in value.split(",") if v]
                continue
            except ValueError:
                pass
        for cast in (int, float):
            try:
                out[key] = cast(value)
                break
            except ValueError:
                continue
        else:
            out[key] = value
    return out
