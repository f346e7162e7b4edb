"""The bench configuration and scene of the repository's bench.py (4
cameras, 768x576, 22 people, K=30, 1024 solver vertices, 150 BLS
iterations), built with the port's modules: the size the port is driven
at on the card (chip_smoke.py, parallel/multihost_sim.py --bench)."""

from __future__ import annotations

import numpy as np

from mcmtt_opticalflow_tpu_torch.config import (Associator3DConfig,
                                                EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario

# bench.py's scene length: 7 warm-up and 30 measured frames.  A scenario
# depends on its length, so a shorter run takes the first frames of this
# scene rather than a shorter scene.
SCENE_FRAMES = 37


def bench_config() -> EngineConfig:
    """bench.py's EngineConfig (without its override hook)."""
    return EngineConfig(
        num_cameras=4, image_width=768, image_height=576,
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                  max_detections=48, max_trackers=64,
                                  max_features=36),
        assoc3d=Associator3DConfig(k_best_size=30),
        solver=SolverConfig(num_replicas=8, max_vertices=1024,
                            max_iterations=150))


def bench_scene(num_frames: int = SCENE_FRAMES):
    """bench.py's scene over `num_frames` frames: (scenario, frames as
    [C, H, W, 3] uint8 per frame)."""
    sc = make_scenario(num_cameras=4, num_frames=num_frames, num_people=22,
                       image_size=(768, 576), arena=9000.0, noise_px=1.0,
                       fp_rate=0.10, fn_rate=0.05, seed=0)
    frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
              .astype(np.uint8) for t in range(num_frames)]
    return sc, frames
