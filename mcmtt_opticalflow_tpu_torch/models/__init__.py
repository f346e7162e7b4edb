from mcmtt_opticalflow_tpu_torch.models.tracker2d import (  # noqa: F401
    Tracker2DState,
    Track2DOutput,
    init_tracker2d_state,
    tracker2d_step,
    make_tracker2d_step,
)
