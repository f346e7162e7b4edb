"""branch_host_ms: the host's track branching, ms a frame: the
`assoc.branch` subtree of the program's span tree (`branch.enum`,
`branch.spawn`, `branch.temporal` and its own time; spantree.py)."""

import spantree


def read(ctx):
    exp = spantree.exported()
    if exp is None:
        return None
    return spantree.self_ms(exp, spantree.named("assoc.branch"))
