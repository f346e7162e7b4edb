"""bls_roofline: the BLS kernel's share of its roofline, %.

The least time of the traced `bls_steps_kernel` launches over their device
time.  Each launch runs a block of iterations of one solve (the program
launches its iterations in blocks, roofline.bls_launches) on R = replicas
+ K warm starts, V = max_vertices, S = ring slots; its bytes are
roofline.bls_bytes.  The operations depend on the cliques the search
visits: they are counted at the mean size of the K-best cliques the
checked frames returned, and the larger of the two terms is the least
time.  Which term binds goes to standard error."""

import sys

import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    names = [n for n in tr["kernel_s"] if "bls_steps_kernel" in n]
    launches = sum(tr["kernel_n"][n] for n in names)
    busy = sum(tr["kernel_s"][n] for n in names)
    if not launches or busy <= 0:
        return None
    cfg = ctx["cfg"]
    r = cfg.solver.num_replicas + cfg.assoc3d.k_best_size
    v, s = cfg.solver.max_vertices, cfg.solver.solutions_per_replica
    unroll = max(int(cfg.solver.unroll), 1)
    ip = -(-cfg.solver.max_iterations // unroll) * unroll
    per_solve = roofline.bls_launches(ip)
    nbytes = sum(roofline.bls_bytes(r, v, s, n) for n in per_solve)
    t_bytes = nbytes / roofline.HBM_BYTES_PER_S * launches / len(per_solve)
    clique = ctx.get("mean_clique")
    t_ops = 0.0
    if clique is not None:
        ops = roofline.bls_ops(r, v, ip, int(clique * ip * r))
        t_ops = ops / roofline.FP32_OPS_PER_S * launches / len(per_solve)
    print(f"bls_roofline: {launches} launches, {busy * 1e3:.3f} ms on the "
          f"card; bytes term {t_bytes * 1e3:.4f} ms, operations term "
          f"{t_ops * 1e3:.4f} ms at a mean clique of {clique}: the "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} term binds",
          file=sys.stderr)
    return 100.0 * max(t_bytes, t_ops) / busy
