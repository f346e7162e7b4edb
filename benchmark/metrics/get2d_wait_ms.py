"""get2d_wait_ms: the host blocked on the 2D program's download, ms a
frame: what the pipeline did not hide (stage `get2d`)."""

from stages import stage_ms


def read(ctx):
    return stage_ms(ctx["stages"], ctx["frames"], ["get2d"])
