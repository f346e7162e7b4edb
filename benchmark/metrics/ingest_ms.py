"""ingest_ms: the engine frame loop's host intake, ms a frame: the gray
conversion and the upload of the gray frames (stages `gray`, `upload`)."""

from stages import stage_ms


def read(ctx):
    return stage_ms(ctx["stages"], ctx["frames"], ["gray", "upload"])
