from mcmtt_opticalflow_tpu_torch.geometry.tsai import (  # noqa: F401
    TsaiCamera,
    stack_cameras,
    world_to_image,
    image_to_world,
    back_projection_line,
    check_visibility,
    camera_position,
)
from mcmtt_opticalflow_tpu_torch.geometry.triangulation import (  # noqa: F401
    triangulate_two_lines,
    nview_point_reconstruction,
    nview_ground_reconstruction,
    segments_intersect,
)
from mcmtt_opticalflow_tpu_torch.geometry.sidemaps import (  # noqa: F401
    projection_sensitivity_map,
    distance_from_boundary_map,
    sample_map,
)
