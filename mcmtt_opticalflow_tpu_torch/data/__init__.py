"""Synthetic scenarios (port of mcmtt_opticalflow_tpu/data)."""

from mcmtt_opticalflow_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticScenario,
    make_scenario,
    ring_cameras,
)
