from mcmtt_opticalflow_tpu_torch.ops.sgsmooth import (  # noqa: F401
    sg_smoothing_matrix,
    sg_smooth,
    sg_smooth_masked,
)
from mcmtt_opticalflow_tpu_torch.ops.hungarian import (  # noqa: F401
    solve_assignment,
    solve_assignment_batch,
    hungarian_host,
)
from mcmtt_opticalflow_tpu_torch.ops.histogram import rgb_histogram  # noqa: F401
from mcmtt_opticalflow_tpu_torch.ops.pyramid import build_pyramid, gaussian_blur_3x3  # noqa: F401
from mcmtt_opticalflow_tpu_torch.ops.lk import (  # noqa: F401
    lk_track_points,
    lk_track_pyramid,
)
from mcmtt_opticalflow_tpu_torch.ops.features import detect_grid_features  # noqa: F401
