from mcmtt_opticalflow_tpu_torch.viz.overlay import (  # noqa: F401
    draw_box,
    draw_overlay,
    draw_top_view,
    tile_frames,
    save_ppm,
)
