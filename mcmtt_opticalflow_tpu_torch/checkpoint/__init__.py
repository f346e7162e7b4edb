"""Checkpoint / resume of a TrackingEngine (port of
mcmtt_opticalflow_tpu/checkpoint)."""

from mcmtt_opticalflow_tpu_torch.checkpoint.snapshot import (  # noqa: F401
    save_snapshot,
    load_snapshot,
)
