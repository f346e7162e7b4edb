"""hyp_host_ms: the host's hypothesis formation and collection, ms a
frame: the `assoc.hypotheses`, `hyp.apply` and `hyp.collect` subtrees of
the program's span tree, less the device-boundary spans inside them
(`hyp.dispatch`, `rescore.dispatch`, `rescore.device`; spantree.py).

Standard error gets two more readings.  The cross-check: every
`assoc.*` subtree with `hyp.apply` and `hyp.collect`, less the same
spans, by parent links, beside assoc_host_ms's sums by name.  The tail:
the spans' self time in the frames over the p95 of the kept frames'
times, a frame, against each span's median over all of them."""

import statistics
import sys

import spantree
from stages import self_ms, with_prefix


def read(ctx):
    exp = spantree.exported()
    if exp is None:
        return None
    value = spantree.self_ms(exp, spantree.named(
        "assoc.hypotheses", "hyp.apply", "hyp.collect"))
    if value is None:
        return None
    tree = spantree.self_ms(exp, lambda n: n.startswith("assoc.")
                            or n in ("hyp.apply", "hyp.collect"))
    st = ctx["stages"]
    sums = self_ms(st, ctx["frames"],
                   with_prefix(st, "assoc.") + ["hyp.apply", "hyp.collect"],
                   list(spantree.DEVICE_SPANS))
    print(f"hyp_host_ms: cross-check: the tree's association self time "
          f"{tree:.4f} ms a frame over {exp['roots']} roots, the stage "
          f"sums' {sums:.4f} ms over {ctx['frames']} frames",
          file=sys.stderr)
    _tail(exp["frames"])
    return value


def _tail(frames, top=8):
    if len(frames) < 20:
        return
    walls = [f["wall_s"] for f in frames]
    p95 = statistics.quantiles(walls, n=20)[-1]
    per = []
    for f in frames:
        own = {}
        for s in f["spans"]:
            own[s["name"]] = own.get(s["name"], 0.0) + s["self_s"]
        per.append(own)
    tail = [own for own, w in zip(per, walls) if w > p95]
    names = {n for own in per for n in own}
    rows = sorted(((1e3 * sum(own.get(n, 0.0) for own in tail) / len(tail),
                    1e3 * statistics.median(own.get(n, 0.0) for own in per),
                    n) for n in names), key=lambda r: r[1] - r[0])
    print(f"hyp_host_ms: tail: {len(tail)} of {len(frames)} kept frames over "
          f"p95 {1e3 * p95:.3f} ms (median "
          f"{1e3 * statistics.median(walls):.3f} ms); self ms a tail frame "
          f"against the median frame: " + ", ".join(
              f"{n} {t:.3f}/{m:.3f}" for t, m, n in rows[:top]),
          file=sys.stderr)
