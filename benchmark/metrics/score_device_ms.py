"""score_device_ms: the device time of the 3D program's head (window
scores, compatibility, weights and the BLS start), ms a solve, over the
solves of the traced slice: the program's device part `head`, timed by
CUDA events between its replays only while the profiler records."""

import spantree


def read(ctx):
    exp = spantree.exported()
    if exp is None:
        return None
    head = exp["parts"].get("head")
    if not head or not head["count"]:
        return None
    return 1e3 * head["seconds"] / head["count"]
