from mcmtt_opticalflow_tpu_torch.utils.timing import StageTimer, profile_trace  # noqa: F401
from mcmtt_opticalflow_tpu_torch.utils.logging import get_logger, FrameLog  # noqa: F401
from mcmtt_opticalflow_tpu_torch.utils.colors import generate_colors  # noqa: F401
