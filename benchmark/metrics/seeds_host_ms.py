"""seeds_host_ms: the host's seed enumeration, ms a frame: the
`assoc.seed_enum` and `assoc.seeds` subtrees of the program's span tree
(spantree.py)."""

import spantree


def read(ctx):
    exp = spantree.exported()
    if exp is None:
        return None
    return spantree.self_ms(exp, spantree.named("assoc.seed_enum",
                                                "assoc.seeds"))
