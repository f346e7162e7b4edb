"""hyp_dispatch_ms: the 3D device program's enqueue, ms a frame: the
uploads into its buffers and the replays of its graphs (stage
`hyp.dispatch`)."""

from stages import stage_ms


def read(ctx):
    return stage_ms(ctx["stages"], ctx["frames"], ["hyp.dispatch"])
