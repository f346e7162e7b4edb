"""solve_wait_ms: the host blocked on the 3D program's download, ms a
frame (stage `hyp.solve`)."""

from stages import stage_ms


def read(ctx):
    return stage_ms(ctx["stages"], ctx["frames"], ["hyp.solve"])
