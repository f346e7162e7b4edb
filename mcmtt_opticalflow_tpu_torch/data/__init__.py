"""Synthetic scenarios and the reference's dataset formats (port of
mcmtt_opticalflow_tpu/data; `images` and `pets` are carried copies)."""

from mcmtt_opticalflow_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticScenario,
    make_scenario,
    ring_cameras,
)
from mcmtt_opticalflow_tpu_torch.data.images import (  # noqa: F401
    FrameSource,
    find_frame,
    frame_path,
    read_image,
    write_image,
)
from mcmtt_opticalflow_tpu_torch.data.pets import (  # noqa: F401
    read_detection_file,
    write_detection_file,
    read_ground_truth,
    write_ground_truth,
    read_tsai_xml,
    read_tsai_dat,
)
