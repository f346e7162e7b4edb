"""CLEAR-MOT scoring and the K-sweep experiment runner (carried copies of
mcmtt_opticalflow_tpu/eval)."""

from mcmtt_opticalflow_tpu_torch.eval.clearmot import (  # noqa: F401
    ClearMotAccumulator,
    EvaluationResult,
    evaluate_clear_mot,
)
