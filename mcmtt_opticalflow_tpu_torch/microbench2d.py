"""Microbenchmark of the 2D stage's building blocks at the bench's shapes
(scripts/microbench2d.py) on the port.

    python -m mcmtt_opticalflow_tpu_torch.microbench2d [--device cuda|cpu]

On 4 random 576x768 gray frames and the same frames shifted 2 px:

  - pyramidal LK (2 levels, window 16, 8 iterations) over all 4 cameras'
    points at once, at the tracker's shapes: 2048 points a camera (the
    backward pass) and 4096 (the forward pass), by two routes, each
    called by name: `kernel`, ops/lk.py::lk_track_prebuilt over both
    pyramids, which sends each level to the LK level kernel for all
    cameras' points in one launch (on the CPU, the kernel's plain
    version, or the gather path under MCMTT_LK_BACKEND=xla), and
    `gather`, ops/lk.py::lk_track_points, the plain PyTorch gather LK,
    per level and camera (`gather_track`);
  - detect_grid_features on 32 boxes a camera;
  - solve_assignment_batch on [4, 32, 64] random costs.

Each line is the median and the minimum of 10 timed calls after one
untimed call, each call waited for (torch.cuda.synchronize on the card).
The card is the default; the CPU only runs when asked for."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

H, W = 576, 768
LK_SHAPES = ((2048, "backward"), (4096, "forward"))
LK_KW = dict(window=16, iterations=8)
LEVELS = 2
MAX_RESIDUAL = 0.08         # lk_track_prebuilt's default status gate
REPS = 10


def bench(name, fn, *args, n=REPS, device="cpu", out=print):
    """Times fn(*args): n calls after a warm-up one, each waited for.
    Prints the median and the minimum; returns (median ms, min ms)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    fn(*args)
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    med, low = float(np.median(ts)) * 1e3, min(ts) * 1e3
    out(f"{name:34s} med={med:8.2f}ms min={low:8.2f}ms")
    return med, low


def inputs(device) -> dict:
    """The JAX script's seeded inputs on `device`: frames, points a
    camera for each LK shape, boxes, costs."""
    rng = np.random.RandomState(0)
    img = rng.rand(4, H, W).astype(np.float32)
    dev = torch.device(device)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    out = {"prev": put(img), "next": put(np.roll(img, 2, axis=2))}
    for npts, tag in LK_SHAPES:
        out[tag] = put(rng.rand(4, npts, 2).astype(np.float32)
                       * [W - 64, H - 64] + 32)
    out["boxes"] = put(rng.rand(4, 32, 4).astype(np.float32)
                       * [600, 400, 60, 120] + [20, 20, 20, 40])
    out["cost"] = put(rng.rand(4, 32, 64).astype(np.float32))
    return out


def kernel_track(prev, nxt, pts, act):
    """All cameras' points through both pyramids, each level one LK
    level kernel launch over [C * N] points (ops/lk.py)."""
    from mcmtt_opticalflow_tpu_torch.ops.lk import lk_track_prebuilt
    from mcmtt_opticalflow_tpu_torch.ops.pyramid import build_pyramid
    return lk_track_prebuilt(build_pyramid(prev, LEVELS),
                             build_pyramid(nxt, LEVELS), pts, active=act,
                             **LK_KW)


def gather_track(prev, nxt, pts, act):
    """The same pyramidal LK on the gather path at every level and
    camera: ops/lk.py::lk_track_points, the plain PyTorch version, on
    whatever device the tensors are."""
    from mcmtt_opticalflow_tpu_torch.ops.lk import lk_track_points
    from mcmtt_opticalflow_tpu_torch.ops.pyramid import (build_pyramid,
                                                         image_gradients)
    prev_pyr = build_pyramid(prev, LEVELS)
    next_pyr = build_pyramid(nxt, LEVELS)
    cur = pts / 2.0 ** (LEVELS - 1)
    valid = act
    for lvl in range(LEVELS - 1, -1, -1):
        src = pts / 2.0 ** lvl
        outs = []
        for c in range(prev.shape[0]):
            ix, iy = image_gradients(prev_pyr[lvl][c])
            outs.append(lk_track_points(prev_pyr[lvl][c], next_pyr[lvl][c],
                                        ix, iy, src[c], cur[c], **LK_KW))
        cur, v, resid = (torch.stack(o) for o in zip(*outs))
        valid = valid & v
        if lvl > 0:
            cur = cur * 2.0
    return cur, valid & (resid < MAX_RESIDUAL), resid


def run(device, out=print) -> dict:
    """Every line of the benchmark; returns {name: (median ms, min ms)}."""
    from mcmtt_opticalflow_tpu_torch.ops.features import detect_grid_features
    from mcmtt_opticalflow_tpu_torch.ops.hungarian import \
        solve_assignment_batch

    x = inputs(device)
    times = {}
    for npts, tag in LK_SHAPES:
        act = torch.ones((4, npts), dtype=torch.bool, device=x[tag].device)
        for route, fn in (("kernel", kernel_track), ("gather", gather_track)):
            name = f"lk[{tag} {npts}x4cam {route}]"
            times[name] = bench(name, fn, x["prev"], x["next"], x[tag], act,
                                device=device, out=out)
    bmask = torch.ones((4, 32), dtype=torch.bool, device=x["prev"].device)
    name = "detect_grid_features[32x4cam]"
    times[name] = bench(
        name, lambda g, b, m: detect_grid_features(g, b, m, grid=8, sub=2,
                                                   quality=0.01),
        x["prev"], x["boxes"], bmask, device=device, out=out)
    rv = torch.ones((4, 32), dtype=torch.bool, device=x["cost"].device)
    cv = torch.ones((4, 64), dtype=torch.bool, device=x["cost"].device)
    name = "solve_assignment[32x64 x4cam]"
    times[name] = bench(name, solve_assignment_batch, x["cost"], rv, cv,
                        device=device, out=out)
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mcmtt_opticalflow_tpu_torch.microbench2d",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    from mcmtt_opticalflow_tpu_torch.utils.device import card_or_exit
    run(card_or_exit(args.device), out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
