"""Whether what the timed path produced is correct.

The window drives `TrackingEngine.process_frame`.  On frames drawn from
the seed (`chosen_frames`), probes around the engine's programs record
what each produced, and what it was given beyond the benchmark's own
inputs (the program's state):

- the 2D program (`Tracker2DProgram`, one CUDA graph a frame): its state
  before and after the frame, less the ring of past gray frames, and the
  packed [C, T, 6] tracklet ids, mask and boxes it hands the host;
- the fused 3D program (`FrameProgram`): the 13 host arrays the
  association uploads, the solve's subkey, and its two outputs, the
  window scores (pack_a) and the bit-packed K-best cliques with their
  scores (pack_b);
- the tracks out: the ids and 3D points the engine reports for the frame.

Once the window has closed and the program is freed, the plain reference
(benchmark/reference, plain PyTorch, none of the program's code) works
each chosen frame out again and the judge compares:

- 2D: the reference rebuilds the ring of the last gray frames and its
  pyramids from the benchmark's images, takes the program's tracker state
  from before the frame, and runs the 2D step on the benchmark's images
  and detections; the program's boxes, features, ids and flags must
  match (`box2d_err_px`, `state2d_mismatch`).
- 3D: from the uploaded arrays and the subkey the reference scores the
  windows, builds the compatibility graph, draws the solver's fields and
  runs the greedy start, the BLS and the K-best selection; the program's
  window scores must match (`window_err`), each of its K-best entries must
  be a clique of the reference's graph scoring the reference's weight sum
  (`kbest_nonclique`, `kbest_score_err`), and its K-best list must be the
  reference's (`kbest_differ_share`, the share of frames where it is not).
- tracks out: a chosen frame the engine never reported counts in
  `frames_unreported`.  On the frames whose best clique is the
  reference's, every id the engine reports must be the tree of a track in
  that clique (`ids_out_extra`), every track of that clique with a
  position at the frame must be reported (`ids_out_missing`), and each
  reported point of a track rescored that frame must be the reference's
  smoothed position (`points_out_err_mm`).
- the association as a whole: the share of the ground truth's person-
  frames over the window that the engine's results miss (`miss_share`,
  CLEAR-MOT's misses over its ground truth, worked out by run.py with the
  frozen scorer).  The host enumeration that turns the downloads into the
  uploads is judged by this outcome only: the 3D reference starts from
  the uploads (see PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

NEG = -1e30
RING_LEAVES = ("frames", "frames_lo")


def chosen_frames(seed: int, first: int, every: int, count: int) -> List[int]:
    """`count` frame indices from `first` on, one every `every` frames on
    average, with gaps drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    out, t = [], first
    for _ in range(count):
        t += int(rng.integers(max(every // 2, 1), every + every // 2 + 1))
        out.append(t)
    return out


@dataclasses.dataclass
class Record2D:
    before: Dict[str, torch.Tensor]
    after: Dict[str, torch.Tensor] = None
    pack: torch.Tensor = None


@dataclasses.dataclass
class Record3D:
    host: List[np.ndarray]
    key: torch.Tensor
    pack_a: torch.Tensor = None
    pack_b: torch.Tensor = None


def _small_state(state) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in state._asdict().items()
            if k not in RING_LEAVES}


class Prog2DProbe:
    """Stands in for a Tracker2DProgram; records the chosen frames."""

    def __init__(self, prog, recorder: "Recorder"):
        self._prog = prog
        self._rec = recorder

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def __call__(self, boxes, mask, frame_idx):
        rec = None
        if frame_idx in self._rec.frames and frame_idx not in self._rec.r2d:
            rec = Record2D(_small_state(self._prog.state))
        out = self._prog(boxes, mask, frame_idx)
        if rec is not None:
            rec.after = _small_state(self._prog.state)
            rec.pack = out.clone()
            self._rec.r2d[frame_idx] = rec
        return out


class Prog3DProbe:
    """Stands in for a FrameProgram; records the chosen frames."""

    def __init__(self, prog, assoc, recorder: "Recorder"):
        self._prog = prog
        self._assoc = assoc
        self._rec = recorder

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def __call__(self, host, key, field_source=None):
        t = self._assoc.frame_idx
        rec = None
        if t in self._rec.frames and t not in self._rec.r3d:
            rec = Record3D([np.array(x, copy=True) for x in host],
                           key.detach().clone())
        out = self._prog(host, key, field_source)
        if rec is not None:
            rec.pack_a, rec.pack_b = out[0].clone(), out[1].clone()
            self._rec.r3d[t] = rec
        return out


class Recorder:
    """Installs the probes on an engine (after its precompile: a probe is
    a Python wrapper, outside any captured graph) and keeps what they
    record."""

    def __init__(self, engine, frames: List[int]):
        self.frames = set(frames)
        self.r2d: Dict[int, Record2D] = {}
        self.r3d: Dict[int, Record3D] = {}
        engine._progs2d = [None if p is None else Prog2DProbe(p, self)
                           for p in engine._progs2d]
        assoc = engine.assoc
        make = assoc._program

        def program(nr, nb, iters):
            return Prog3DProbe(make(nr, nb, iters), assoc, self)
        assoc._program = program

    def to_host(self) -> None:
        """Move every recording off the card."""
        for r in self.r2d.values():
            r.before = {k: v.cpu() for k, v in r.before.items()}
            r.after = {k: v.cpu() for k, v in r.after.items()}
            r.pack = r.pack.cpu()
        for r in self.r3d.values():
            r.key, r.pack_a, r.pack_b = (r.key.cpu(), r.pack_a.cpu(),
                                         r.pack_b.cpu())


def results_at(engine, frames) -> Dict[int, tuple]:
    """The engine's reported (ids, points) of each frame in `frames`."""
    want = set(frames)
    return {r.frame_idx: (list(r.ids), np.asarray(r.points, np.float64))
            for r in engine.results if r.frame_idx in want}


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def gray_u8(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 -> uint8 gray, the channels' mean rounded down."""
    return ((rgb[..., 0].astype(np.uint16) + rgb[..., 1] + rgb[..., 2])
            // 3).astype(np.uint8)


def pad_detections(dets, cameras: int, slots: int):
    boxes = np.zeros((cameras, slots, 4), np.float32)
    mask = np.zeros((cameras, slots), bool)
    for c in range(cameras):
        d = np.asarray(dets[c], np.float32).reshape(-1, 4)[:slots]
        boxes[c, :len(d)] = d
        mask[c, :len(d)] = True
    return boxes, mask


def reference_2d(rec: Record2D, t: int, scene, cfg, cams, device,
                 low=None):
    """(pack [C, T, 6], new state as a dict) of the reference's 2D step at
    frame t, from the benchmark's images and detections and the program's
    tracker state before the frame.  With `low` (a control) the gray
    frames are rounded to that precision."""
    from reference.frame3d import rounded
    from reference.pyramid import build_pyramid
    from reference.tracker2d import Tracker2DState, tracker2d_step
    t2 = cfg.tracker2d
    b = t2.backtrack_interval

    def gray(i):
        g = gray_u8(scene.frame(i)[0])
        return rounded(torch.from_numpy(g).to(device).float() * (1.0 / 255.0),
                       low)

    past = [gray(t - b + j) for j in range(b)]
    pyrs = [build_pyramid(g, t2.lk_pyramid_levels) for g in past]
    frames = torch.stack(past, 1)
    frames_lo = tuple(torch.stack([p[lvl] for p in pyrs], 1)
                      for lvl in range(1, t2.lk_pyramid_levels))
    state = Tracker2DState(frames=frames, frames_lo=frames_lo,
                           **{k: v.to(device) for k, v in rec.before.items()})
    imgs, dets = scene.frame(t)
    boxes, mask = pad_detections(dets, cfg.num_cameras, t2.max_detections)
    new, out = tracker2d_step(
        state, gray(t), torch.from_numpy(boxes).to(device),
        torch.from_numpy(mask).to(device), cams,
        torch.tensor(t, dtype=torch.int32, device=device), t2)
    pack = torch.cat([out.ids.float()[..., None], out.mask.float()[..., None],
                      out.boxes], -1)
    return pack.cpu(), {k: v.cpu() for k, v in new._asdict().items()
                        if k not in RING_LEAVES}


def reference_3d(rec: Record3D, cfg, cams, device, low=None):
    from reference.frame3d import solve_frame
    host = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in rec.host]
    pack_a, pack_b, graph = solve_frame(host, rec.key.to(device), cams, cfg,
                                        low)
    return pack_a.cpu(), pack_b.cpu(), tuple(g.cpu() for g in graph)


def unpack_k_best(pack_b: torch.Tensor, vmax: int):
    """(masks [K, vmax] bool, scores [K]) of the entries that hold a
    clique."""
    b = pack_b.numpy()
    masks = np.unpackbits(b[:, :-4], axis=1)[:, :vmax].astype(bool)
    scores = b[:, -4:].copy().view(np.float32).ravel()
    keep = scores > NEG / 2
    return masks[keep], scores[keep]


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------

def _f16_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    err = torch.abs(a - b) / (torch.abs(b) + 1.0)
    err = torch.where(same, torch.zeros_like(err), err)
    err = torch.nan_to_num(err, nan=float("inf"))
    return float(err.max()) if err.numel() else 0.0


def judge_2d(prog: Record2D, ref_pack, ref_state) -> dict:
    pp = prog.pack
    ids_p, ids_r = pp[..., 0], ref_pack[..., 0]
    m_p, m_r = pp[..., 1] > 0.5, ref_pack[..., 1] > 0.5
    mismatch = int((m_p != m_r).sum()) + int(((ids_p != ids_r) & m_r).sum())
    both = m_p & m_r
    err = [float(torch.abs(pp[..., 2:] - ref_pack[..., 2:])[both].max())
           if both.any() else 0.0]
    act = prog.after["trk_active"] & ref_state["trk_active"]
    for k in ("trk_active", "trk_id", "trk_time_start", "trk_time_end",
              "next_id", "frame_count"):
        mismatch += int((prog.after[k] != ref_state[k]).sum())
    fv = prog.after["trk_feat_valid"] & ref_state["trk_feat_valid"]
    mismatch += int(((prog.after["trk_feat_valid"]
                      != ref_state["trk_feat_valid"]) & act[..., None]).sum())
    for k, sel in (("trk_boxes", act), ("trk_feats", fv)):
        d = torch.abs(prog.after[k] - ref_state[k])[sel]
        if d.numel():
            err.append(float(d.max()))
    return {"box2d_err_px": max(err), "state2d_mismatch": mismatch}


def judge_3d(prog: Record3D, ref, vmax: int, reported):
    ref_a, ref_b, (weights, adj, valid) = ref
    out = {"window_err": _f16_rel_err(prog.pack_a, ref_a)}
    pm, ps = unpack_k_best(prog.pack_b, vmax)
    rm, _ = unpack_k_best(ref_b, vmax)
    w = weights.double().numpy()
    a, v = adj.numpy(), valid.numpy()
    nonclique, score_err = 0, 0.0
    for m, s in zip(pm, ps):
        idx = np.nonzero(m)[0]
        sub = a[np.ix_(idx, idx)] | np.eye(len(idx), dtype=bool)
        if not (v[idx].all() and sub.all()):
            nonclique += 1
            continue
        total = float(w[idx].sum())
        score_err = max(score_err, abs(float(s) - total) / max(abs(total),
                                                               1.0))
    out["kbest_nonclique"] = nonclique
    out["kbest_score_err"] = score_err
    same = (len(pm) == len(rm) and bool(np.array_equal(pm, rm)))
    out["kbest_differs"] = 0 if same else 1
    # tracks out, on the frames whose best clique is the reference's (a
    # frame whose K-best list parts is kbest_differ_share's)
    out["frames_unreported"] = int(reported is None)
    out["ids_out_extra"] = 0
    out["ids_out_missing"] = 0
    out["points_out_err_mm"] = 0.0
    same_best = (len(pm) and len(rm)
                 and bool(np.array_equal(pm[0], rm[0])))
    if reported is not None and same_best:
        ids, points = reported
        tree_ids, row_map, lens = prog.host[7], prog.host[5], prog.host[4]
        have, pvalid = prog.host[10], prog.host[11]
        ref_ids = {int(tree_ids[i]): i for i in np.nonzero(rm[0])[0]}
        w_len = (ref_a.shape[1] - 2) // 5
        smoothed = ref_a[:, :3 * w_len].double().reshape(-1, w_len, 3)
        # a clique track with a position at the frame (the last column of
        # the common time grid) is one the engine has to report
        due = {int(tree_ids[i]) for i in ref_ids.values()
               if i < len(pvalid) and pvalid[i] and have[i, -1]}
        out["ids_out_missing"] = len(due - {int(t) for t in ids})
        for tid, p in zip(ids, points):
            vtx = ref_ids.get(int(tid))
            if vtx is None:
                out["ids_out_extra"] += 1
                continue
            r = int(row_map[vtx])
            if r < 0 or int(lens[r]) < 1:
                continue
            q = smoothed[r, int(lens[r]) - 1].numpy()
            out["points_out_err_mm"] = max(out["points_out_err_mm"],
                                           float(np.abs(q - p).max()))
    return out


NUMBERS = ("box2d_err_px", "state2d_mismatch", "window_err",
           "kbest_nonclique", "kbest_score_err", "kbest_differ_share",
           "frames_unreported", "ids_out_extra", "ids_out_missing",
           "points_out_err_mm", "miss_share")
COUNTS = ("state2d_mismatch", "kbest_nonclique", "frames_unreported",
          "ids_out_extra", "ids_out_missing")


def combine(per_frame: List[dict]) -> dict:
    """The run's numbers from the chosen frames' readings: the largest of
    each, summed counts, and the share of frames whose K-best differs."""
    out = {k: 0.0 for k in NUMBERS if k != "miss_share"}
    n3 = 0
    for r in per_frame:
        for k in ("box2d_err_px", "window_err", "kbest_score_err",
                  "points_out_err_mm"):
            if k in r:
                out[k] = max(out[k], r[k])
        for k in COUNTS:
            out[k] += r.get(k, 0)
        if "kbest_differs" in r:
            n3 += 1
            out["kbest_differ_share"] += r["kbest_differs"]
    if n3:
        out["kbest_differ_share"] /= n3
    return out


def readings(recorder: Recorder, reported, scene, cfg, device,
             control: Optional[str] = None, outcome: dict = None) -> dict:
    """The run's numbers (see the module docstring), and how many frames
    each side checked; `outcome` holds the numbers of the run as a whole
    (`miss_share`), which a control leaves as they are: it stands in for
    the device programs, not for the association.  With a control the reference computed in a lower
    precision stands in the program's place, and its outputs are judged
    against the float32 reference's: "tf32", TF32 matmuls; "bf16", the
    gray frames, the window scores and the weights rounded to bfloat16."""
    from reference.tsai import TsaiCamera, stack_cameras
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cams = stack_cameras([TsaiCamera.create(**p)
                          for p in scene.camera_params], device)
    vmax = cfg.solver.max_vertices
    per_frame = []
    for t in sorted(recorder.r2d):
        rec = recorder.r2d[t]
        ref_pack, ref_state = reference_2d(rec, t, scene, cfg, cams, device)
        if control is not None:
            with _Lower(control) as low:
                c_pack, c_state = reference_2d(rec, t, scene, cfg, cams,
                                               device, low)
            rec = Record2D(rec.before, c_state, c_pack)
        per_frame.append(judge_2d(rec, ref_pack, ref_state))
    for t in sorted(recorder.r3d):
        rec = recorder.r3d[t]
        ref = reference_3d(rec, cfg, cams, device)
        got = reported.get(t)
        if control is not None:
            with _Lower(control) as low:
                c_a, c_b, _ = reference_3d(rec, cfg, cams, device, low)
            rec = Record3D(rec.host, rec.key, c_a, c_b)
            got = _reported_from(rec, vmax)
        per_frame.append(judge_3d(rec, ref, vmax, got))
    out = combine(per_frame)
    out.update(outcome or {})
    out["frames_2d"] = len(recorder.r2d)
    out["frames_3d"] = len(recorder.r3d)
    return out


def _reported_from(rec: Record3D, vmax: int):
    """The tracks a stand-in's outputs would report: the tree ids of its
    best clique's tracks with a position at the frame, each with its
    row's newest smoothed position (its newest raw one without a row)."""
    masks, _ = unpack_k_best(rec.pack_b, vmax)
    if not len(masks):
        return [], np.zeros((0, 3))
    tree_ids, row_map, lens = rec.host[7], rec.host[5], rec.host[4]
    grid, have, pvalid = rec.host[9], rec.host[10], rec.host[11]
    w = (rec.pack_a.shape[1] - 2) // 5
    sm = rec.pack_a[:, :3 * w].double().reshape(-1, w, 3).numpy()
    ids, pts = [], []
    for i in np.nonzero(masks[0])[0]:
        if i >= len(pvalid) or not (pvalid[i] and have[i, -1]):
            continue
        r = int(row_map[i])
        ids.append(int(tree_ids[i]))
        pts.append(sm[r, int(lens[r]) - 1] if r >= 0 and lens[r] >= 1
                   else grid[i, -1].astype(np.float64))
    return ids, np.asarray(pts).reshape(-1, 3)


class _Lower:
    """A control's precision inside the block: "tf32" turns on TF32
    matmuls (the card's tensor cores) and gives None; "bf16" gives
    torch.bfloat16 for the reference to round to."""

    def __init__(self, control: str):
        if control not in ("tf32", "bf16"):
            raise ValueError(f"no control {control!r}")
        self.control = control

    def __enter__(self):
        if self.control == "bf16":
            return torch.bfloat16
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return None

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): correct when every number with a
    limit is at or below it and both programs were checked on some
    frame."""
    rows = [(k, numbers.get(k), limits[k]) for k in NUMBERS if k in limits]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    ok = ok and numbers.get("frames_2d", 0) > 0 \
        and numbers.get("frames_3d", 0) > 0
    return ok, rows
