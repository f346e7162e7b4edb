"""solve_vertex_fill: the share of the BLS's vertex slots that the frames'
hypothesis pools fill: the program's counters `solve.vertices` (the pool
size n of each solve) over `solve.slots` (max_vertices a solve, the width
every launch runs at), summed over the window.  The solves by bucket,
the pool's dropped tracks, the captures inside frames and the graph
parts replayed go to standard error, a frame each where so stated."""

import sys

import spantree


def read(ctx):
    exp = spantree.exported()
    if exp is None:
        return None
    c = exp["counters"]
    if not c.get("solve.slots"):
        return None
    roots = max(exp["roots"], 1)
    buckets = {k[len("solve.bucket."):]: int(v) for k, v in sorted(c.items())
               if k.startswith("solve.bucket.")}
    print(f"solve_vertex_fill: {int(c['solve.frames'])} solves over "
          f"{exp['roots']} frames, by bucket (rows x graph rows) {buckets}; "
          f"pool dropped {c.get('solve.pool_dropped', 0) / roots:.4f} "
          f"tracks a frame; captures in frames "
          f"{int(c.get('graph.captures', 0))} "
          f"({c.get('graph.capture_s', 0.0):.3f} s); graph parts replayed "
          f"{c.get('graph.replays', 0) / roots:.3f} a frame",
          file=sys.stderr)
    return c["solve.vertices"] / c["solve.slots"]
