"""tracker2d_dispatch_ms: the 2D program's enqueue, ms a frame: the
detections' upload and the CUDA graph's replay (stage `tracker2d`)."""

from stages import stage_ms


def read(ctx):
    return stage_ms(ctx["stages"], ctx["frames"], ["tracker2d"])
