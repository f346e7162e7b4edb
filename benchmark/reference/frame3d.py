"""The fused 3D device program of one frame, eagerly in plain PyTorch.

A frozen copy of the parts of mcmtt_opticalflow_tpu_torch/models/
associator3d.py at commit 052b569610a6 that the program's `FrameProgram`
runs without a mesh (`incompat_rows`, `_compat_from`, `_score_rows`,
`_score_joined`, `_pack_k_best` and `_rescore_and_solve`), written as
functions of the host arrays the program uploads: window scores,
compatibility, the solver's draw, greedy start, clique weights, BLS and
K-best, on the kernels' plain versions (the copies beside this file).
"""

from __future__ import annotations

import dataclasses

import torch

from reference.config import EngineConfig
from reference.costs import score_track_windows
from reference.mwcp import (bls_result, bls_start, bls_steps, device_k_best,
                            iters_padded, threefry_fields)
from reference.triangulation import segments_intersect


def fused_solver(cfg: EngineConfig):
    """The solver's config with the K warm-start replicas added."""
    return dataclasses.replace(
        cfg.solver,
        num_replicas=cfg.solver.num_replicas + cfg.assoc3d.k_best_size)


def incompat_rows(tree_ids, pos_grid, have, cols, acfg):
    col_ids, col_pos, col_have = cols
    same_tree = tree_ids[:, None] == col_ids[None, :]
    use = have[:, None, :] & col_have[None, :, :]
    pi = pos_grid[:, None]
    pj = col_pos[None, :]
    diff = pi - pj
    dist = torch.sqrt(torch.sum(diff * diff, -1))
    near = dist <= 2.0 * acfg.max_moving_speed
    too_close = torch.any(use & (dist < acfg.min_target_proximity), -1)
    cross = segments_intersect(pi[..., :-1, :2], pi[..., 1:, :2],
                               pj[..., :-1, :2], pj[..., 1:, :2])
    crossing = torch.any(cross & near[..., :-1]
                         & use[..., :-1] & use[..., 1:], -1)
    return same_tree | too_close | crossing


def compat_from(incompat, valid):
    n = incompat.shape[0]
    compat = ~incompat & valid[:, None] & valid[None, :]
    return compat & ~torch.eye(n, dtype=torch.bool, device=compat.device)


def rounded(x: torch.Tensor, low=None) -> torch.Tensor:
    """x, or x rounded to the lower precision `low` (a control)."""
    return x if low is None else x.to(low).to(x.dtype)


def score_graph(host, cams, cfg: EngineConfig, low=None):
    """The scoring half: pack_a, and the solver's graph (weights [vmax],
    adjacency [vmax, vmax], validity [vmax]), from the 13 uploaded arrays
    as tensors on one device.  With `low` (a control) the window scores
    and the weights are rounded to that precision."""
    acfg = cfg.assoc3d
    (pts, raws, rmask, merr, lens, row_map, host_base, tree_ids, shared,
     pos_grid, have, pvalid, _) = host
    s = score_track_windows(pts.float(), raws.float(), rmask, merr.float(),
                            lens, cams, acfg)
    s = s._replace(**{k: rounded(getattr(s, k), low) for k in (
        "smoothed", "cost_recon", "cost_link", "window_cost")})
    g = pos_grid.float()
    incompat = incompat_rows(tree_ids, g, have, (tree_ids, g, have), acfg)
    nb = incompat.shape[0]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=shared.device)
    bits = (shared[:, :, None] >> shifts) & 1
    shared_b = bits.reshape(nb, -1)[:, :nb].bool()
    vmax = cfg.solver.max_vertices
    rm = torch.clamp(row_map, min=0).long()
    has_row = row_map >= 0
    short_row = lens[rm] < (acfg.sg_span // 2)
    wcost = torch.where(has_row & ~short_row, s.window_cost[rm], 0.0)
    row_ok = torch.where(has_row, s.valid[rm], True)
    weights = rounded(-(host_base + wcost), low)
    vert_ok = row_ok & (weights > 0.0)
    compat = compat_from(shared_b | incompat, pvalid & vert_ok[:nb])
    dev = weights.device
    adj = torch.zeros((vmax, vmax), dtype=torch.bool, device=dev)
    adj[:nb, :nb] = compat
    in_graph = torch.zeros((vmax,), dtype=torch.bool, device=dev)
    in_graph[:nb] = pvalid
    valid = vert_ok & in_graph
    nr = s.smoothed.shape[0]
    pack_a = torch.cat([
        s.smoothed.half().reshape(nr, -1), s.cost_recon.half(),
        s.cost_link.half(), s.window_cost.half()[:, None],
        s.valid.half()[:, None]], dim=1)
    return pack_a, weights, adj, valid


def pack_k_best(masks, scores):
    """pack_b: the K-best masks bit-packed, then each score's 4 bytes."""
    k = masks.shape[0]
    weights8 = (1 << torch.arange(7, -1, -1, device=masks.device)
                ).to(torch.uint8)
    packed = torch.sum(masks.reshape(k, -1, 8).to(torch.uint8) * weights8,
                       -1, dtype=torch.uint8)
    return torch.cat([
        packed, scores.float().contiguous().view(torch.uint8).reshape(k, 4)],
        dim=1)


def solve_frame(host, key, cams, cfg: EngineConfig, low=None):
    """One frame of the fused program: (pack_a, pack_b, graph) from the
    13 uploaded arrays and the solve's subkey, all on one device; graph is
    (weights, adj, valid) for the judge.  `low`: see score_graph."""
    scfg = fused_solver(cfg)
    ip = iters_padded(scfg, cfg.solver.max_iterations)
    f = threefry_fields(key, scfg.num_replicas, scfg.max_vertices, ip,
                        key.device)
    pack_a, weights, adj, valid = score_graph(host, cams, cfg, low)
    st = bls_start(weights, adj, valid, host[12], f, scfg,
                   host[7].shape[0])
    bls_steps(st, f, scfg, ip)
    masks, scores = device_k_best(bls_result(st), cfg.assoc3d.k_best_size)
    return pack_a, pack_k_best(masks, scores), (weights, adj, valid)
