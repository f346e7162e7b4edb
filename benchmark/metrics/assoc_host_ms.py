"""assoc_host_ms: the self time of the host association, ms a frame: the
`assoc.*` stages with `hyp.apply` and `hyp.collect`, less the device
stages nested in them (`hyp.dispatch` inside `assoc.hypotheses`, and
`rescore.dispatch` and `rescore.device` of a frame with no hypothesis
pool)."""

from stages import self_ms, with_prefix


def read(ctx):
    st = ctx["stages"]
    outer = with_prefix(st, "assoc.") + ["hyp.apply", "hyp.collect"]
    nested = ["hyp.dispatch", "rescore.dispatch", "rescore.device"]
    return self_ms(st, ctx["frames"], outer, nested)
