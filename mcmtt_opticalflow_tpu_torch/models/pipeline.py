"""Top-level tracking engine (port of
mcmtt_opticalflow_tpu/models/pipeline.py; the redesign of the reference
orchestrator CPSNWhere, psn_where/PSNWhere.cpp:243-283).

Per frame:
  1. the 2D tracklet step over all cameras (models/tracker2d.py)
  2. the 3D MHT association step (models/associator3d.py)
  3. optional deferred CLEAR-MOT evaluation by the caller

The whole 8-bit gray frame goes up from pinned memory with a non-blocking
copy; the 2D result comes down as one packed f32 tensor per camera group
through parallel/mesh.py's `AsyncFetch` (non-blocking copies behind CUDA
events).  The 2D step of a camera group and the packing of its outputs
are one program on static buffers (`Tracker2DProgram`): on the card one
CUDA graph, captured at the first frame, replayed once a frame and read
by the host only through that download, as the JAX package dispatches
its jitted step2d.  Without a mesh there is one group, every camera.
With a mesh the cameras split into one group per 'cam' row, each with
its own program on that row's first device (one graph pool per device);
on a mesh over several processes each process builds and replays only
the groups it owns, and every frame's packed 2D outputs reach every
process with one all-gather, in camera order, so that the host 3D stage
runs alike in every process.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from mcmtt_opticalflow_tpu_torch.config import EngineConfig
from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera, stack_cameras
from mcmtt_opticalflow_tpu_torch.models.associator3d import (Associator3D,
                                                             Track3DResult)
from mcmtt_opticalflow_tpu_torch.models.tracker2d import (
    Tracker2DState, init_tracker2d_state, tracker2d_step)
from mcmtt_opticalflow_tpu_torch.parallel.mesh import (AsyncFetch, Shards,
                                                       cam_sharding,
                                                       shard_leaves)
from mcmtt_opticalflow_tpu_torch.utils.device import resolve_device
from mcmtt_opticalflow_tpu_torch.utils import spans
from mcmtt_opticalflow_tpu_torch.utils.graphs import Graphed, device_pool
from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves, tree_map


def _unpack2d(a):
    """Host inverse of `_pack2d`, over every camera."""
    return (a[..., 0].astype(np.int64), a[..., 2:6], a[..., 1] > 0.5)


def _pack2d(out2d):
    """(ids, boxes, mask) -> one [C, T, 6] f32 tensor: a single download
    (ids are exact in f32 below 2^24)."""
    return torch.cat([out2d.ids.float()[..., None],
                      out2d.mask.float()[..., None], out2d.boxes], -1)


def _staged(x: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor to copy to `device` from: pinned for the
    card (the caching host allocator keeps the block until the copy has
    run), the array itself for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if device.type == "cuda" else t


class Tracker2DProgram:
    """The 2D step of one camera group and the packing of its outputs
    (`_pack2d`) on static buffers: the counterpart of the JAX package's
    jitted, vmapped step2d (models/tracker2d.py:459-472), built once per
    group (the shapes are static, so there are no buckets).

    `cams` are the group's stacked cameras, on `device`; their count is
    the group's.  The buffers are the group's 2D state (`state`), this
    frame's 8-bit gray frames, detection boxes and mask, and the frame
    number as a 0-dim int32 tensor.  The program's function reads them,
    runs `tracker2d_step`, copies the new state into the state buffers
    and returns the packed [C, T, 6] outputs.  On the card it is one CUDA
    graph (`Graphed`, into `pool`, which the device's 2D programs share),
    captured at the first call or by `capture()`; the capture's eager
    warm-up would advance the state, so the state is saved around it and
    put back.  Elsewhere the function runs eagerly from the same
    buffers."""

    def __init__(self, cfg: EngineConfig, cams: TsaiCamera, device,
                 pool=None):
        t2 = cfg.tracker2d
        c, h, w = cams.width.shape[0], cfg.image_height, cfg.image_width
        self.device = torch.device(device)
        self.state = init_tracker2d_state(t2, h, w, num_cameras=c,
                                          device=device)
        self.gray_u8 = torch.zeros((c, h, w), dtype=torch.uint8,
                                   device=device)
        self.boxes = torch.zeros((c, t2.max_detections, 4), device=device)
        self.mask = torch.zeros((c, t2.max_detections), dtype=torch.bool,
                                device=device)
        self.frame_idx = torch.zeros((), dtype=torch.int32, device=device)
        self._leaves = tree_leaves(self.state)

        def step():
            gray = self.gray_u8.float() * (1.0 / 255.0)
            new_state, out2d = tracker2d_step(
                self.state, gray, self.boxes, self.mask, cams,
                self.frame_idx, t2)
            self._load_leaves(tree_leaves(new_state))
            return _pack2d(out2d)
        self.graph = Graphed(step, device, pool)

    def capture(self) -> None:
        """Capture the graph (nothing off the card or when captured),
        leaving the state as it was."""
        if not self.graph.on_card or self.graph.graph is not None:
            return
        saved = [x.clone() for x in self._leaves]
        self.graph.capture()
        self._load_leaves(saved)

    def _load_leaves(self, leaves) -> None:
        for dst, src in zip(self._leaves, leaves):
            dst.copy_(src)

    def load(self, state: Tracker2DState) -> None:
        """Copy a 2D state into the state buffers."""
        self._load_leaves(tree_leaves(state))

    def put_gray(self, gray_u8: np.ndarray) -> None:
        """Enqueue this frame's [C, H, W] u8 gray into its buffer."""
        self.gray_u8.copy_(_staged(gray_u8, self.device), non_blocking=True)

    def __call__(self, boxes: np.ndarray, mask: np.ndarray,
                 frame_idx: int) -> torch.Tensor:
        """One frame on the gray last put: returns the packed outputs, the
        program's own output tensor on the card (the next run overwrites
        it, so a download is enqueued before that; `DeviceFetch` does, on
        the same stream)."""
        self.capture()
        self.boxes.copy_(_staged(boxes, self.device), non_blocking=True)
        self.mask.copy_(_staged(mask, self.device), non_blocking=True)
        self.frame_idx.fill_(frame_idx)
        return self.graph()


class TrackingEngine:
    def __init__(self, cfg: EngineConfig, cameras: Sequence[TsaiCamera],
                 pipelined: bool = False, sidemaps=None, mesh=None,
                 device=None):
        """pipelined=True pipelines the engine three frames deep: the 2D
        stage runs TWO frames ahead of the host-side 3D association, and
        the 3D hypothesis solve of frame t runs while the host enumerates
        frame t+1 (the associator's deferred_solve).  Results then trail
        the input by THREE frames: process_frame(t) returns the frame t-3
        result (None for the first three); call flush() until it returns
        None to drain the tail.  Results are identical to the sequential
        mode, only delayed.

        cameras: host (CPU) TsaiCameras; the engine keeps a stacked copy
        on `device` (default: the CUDA card; without one, None raises and
        the CPU must be asked for with device="cpu").

        sidemaps: optional per-camera (sensitivity, boundary, stride)
        triples (see Associator3D).

        mesh: optional ('cam', 'block') Mesh (parallel/mesh.py).  The
        camera axis of the 2D stage splits into mesh.shape["cam"] groups,
        each with its own 2D program on its 'cam' row's first device
        (`state2d_groups` are their states); the 3D stage runs on the
        mesh (see Associator3D), its replicated part on the process's
        first mesh device, which is also the engine's `device`.  On a
        mesh over several processes, every process makes the same calls
        with the same frames: each builds and steps the groups it owns
        (None in `state2d_groups` for the others) and all return the same
        results.  Results equal the run without a mesh."""
        assert len(cameras) == cfg.num_cameras
        self.mesh = mesh
        self._cam_split = None
        if mesh is not None:
            if cfg.num_cameras % mesh.shape["cam"]:
                raise ValueError(f"{cfg.num_cameras} cameras do not split "
                                 f"over the mesh's {mesh.shape}")
            if device is not None:
                raise ValueError("pass a mesh or a device, not both: with "
                                 "a mesh the engine's device is its first")
            device = mesh.home
            self._cam_split = cam_sharding(mesh)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cameras = list(cameras)
        self.cams = stack_cameras(cameras, self.device)
        devices = ([self.device] if mesh is None
                   else self._cam_split.devices)
        # one 2D program per camera group of this process (None for the
        # groups of other processes), one graph pool a card
        pools = {}
        self._progs2d = [
            None if cams is None else Tracker2DProgram(
                cfg, cams, dev, device_pool(pools, dev))
            for cams, dev in zip(self._split(self.cams), devices)]
        self.assoc = Associator3D(cfg, cameras, sidemaps=sidemaps,
                                  mesh=mesh, deferred_solve=pipelined,
                                  device=self.device)
        from mcmtt_opticalflow_tpu_torch import native
        self._native_gray = native.available()
        self.frame_idx = -1
        self.results: List[Track3DResult] = []
        self.timing: List[float] = []
        self.pipelined = pipelined
        # queue of up to 2 in-flight 2D frames:
        # (frame_idx, AsyncFetch of the packed 2D outputs, host rgb u8)
        self._pending: List[tuple] = []

    def _split(self, tree) -> list:
        """A [C, ...] tree as one tree per camera group."""
        if self.mesh is None:
            return [tree]
        return shard_leaves(tree, self._cam_split)

    @property
    def state2d_groups(self) -> list:
        """Each camera group's 2D state: its program's state buffers (None
        for the groups of other processes)."""
        return [None if p is None else p.state for p in self._progs2d]

    @property
    def state2d(self) -> Tracker2DState:
        """The 2D state of every camera: a copy of the programs' state
        buffers, the groups' joined on the engine's device (the next
        frame overwrites the buffers).  Raises on a mesh over several
        processes, where no process holds every group."""
        if any(p is None for p in self._progs2d):
            raise RuntimeError("the 2D state of a mesh over several "
                               "processes is split between them")
        return tree_map(lambda *xs: torch.cat([x.to(self.device)
                                               for x in xs]),
                        *self.state2d_groups)

    @state2d.setter
    def state2d(self, state: Tracker2DState):
        """Copy a 2D state of every camera into the programs' buffers,
        each group's slice into its own."""
        for prog, part in zip(self._progs2d, self._split(state)):
            if prog is not None:
                prog.load(part)

    def precompile(self) -> None:
        """Capture the 2D programs and the fused 3D program's usual
        buckets ahead of the measured frames (Associator3D.precompile);
        call after the engine's own warm-up frames.  Off the card it
        makes the 3D programs' buffers."""
        for prog in self._progs2d:
            if prog is not None:
                prog.capture()
        self.assoc.precompile()

    def _group_slices(self, x: np.ndarray) -> List[np.ndarray]:
        """A [C, ...] host array cut into the camera groups' slices."""
        return np.split(x, len(self._progs2d))

    def _upload_gray(self, gray_u8: np.ndarray) -> None:
        """[C, H, W] u8 gray -> each camera group's slice into its
        program's buffer (nothing for the groups of other processes)."""
        for prog, g in zip(self._progs2d, self._group_slices(gray_u8)):
            if prog is not None:
                prog.put_gray(g)

    def _pad_detections(self, detections):
        c = self.cfg.num_cameras
        d = self.cfg.tracker2d.max_detections
        boxes = np.zeros((c, d, 4), np.float32)
        mask = np.zeros((c, d), bool)
        for ci in range(c):
            det = np.asarray(detections[ci], np.float32).reshape(-1, 4)
            n = min(len(det), d)
            boxes[ci, :n] = det[:n]
            mask[ci, :n] = True
        return boxes, mask

    def _step2d(self, boxes, mask):
        """One run of each camera group's 2D program this process holds,
        on the gray `_upload_gray` put in its buffer; returns the packed
        outputs, [C, T, 6] (as Shards over the camera groups with a
        mesh)."""
        packs = [None if prog is None else prog(box, msk, self.frame_idx)
                 for prog, box, msk in zip(self._progs2d,
                                           self._group_slices(boxes),
                                           self._group_slices(mask))]
        spans.count(self.assoc.timer, "graph.replays",
                    sum(p is not None for p in packs))
        return packs[0] if self.mesh is None else Shards(self._cam_split,
                                                         packs)

    def process_frame(self, frames_rgb: np.ndarray,
                      detections: Sequence[np.ndarray],
                      frame_idx: Optional[int] = None) -> Track3DResult:
        """Args:
          frames_rgb: [C, H, W, 3] images — uint8 in [0, 255] (preferred;
            this is what dataset JPEGs decode to) or float in [0, 1]
            (quantised to uint8 on the host before upload).
          detections: per camera [K_c, 4] (x, y, w, h) arrays.
        """
        t0 = time.perf_counter()
        self.frame_idx = self.frame_idx + 1 if frame_idx is None else frame_idx
        with spans.root(self.assoc.timer, self.frame_idx):
            result = self._frame(frames_rgb, detections)
        if result is None:           # pipeline still filling
            return None
        result.processing_time = time.perf_counter() - t0
        self.timing.append(result.processing_time)
        self.results.append(result)
        return result

    def _frame(self, frames_rgb, detections) -> Optional[Track3DResult]:
        """process_frame's work under its `frame` root: this frame's 2D
        step and, pipelined, the association of frame t-2 (the timer's
        `frame` says which frame a span works on)."""
        timer = self.assoc.timer
        boxes, mask = self._pad_detections(detections)
        f = np.asarray(frames_rgb)
        with timer.stage("gray"):
            if f.dtype != np.uint8:
                f = (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            if self._native_gray:
                from mcmtt_opticalflow_tpu_torch import native
                gray_u8 = native.rgb_to_gray_u8(f)
            else:
                gray_u8 = ((f[..., 0].astype(np.uint16) + f[..., 1]
                            + f[..., 2]) // 3).astype(np.uint8)
        with timer.stage("upload"):
            self._upload_gray(gray_u8)

        if self.pipelined:
            # the associator's phase 1 for frame t-2 runs first, so this
            # frame's 2D work is enqueued after the previous frame's
            # hypothesis solve
            result = None
            if len(self._pending) == 2:
                prev_idx, prev_fetch, prev_rgb = self._pending.pop(0)
                timer.frame = prev_idx
                with timer.stage("get2d"):
                    ids_np, boxes_np, mask_np = _unpack2d(prev_fetch.get())
                result = self.assoc.step_begin(prev_idx, ids_np, boxes_np,
                                               mask_np, prev_rgb)
                self.assoc.step_finish(prev_idx)
                timer.frame = self.frame_idx
            with timer.stage("tracker2d"):
                packs = self._step2d(boxes, mask)
            self._pending.append((self.frame_idx, AsyncFetch(packs), f))
            return result
        with timer.stage("tracker2d"):
            packs = self._step2d(boxes, mask)
        return self._associate(self.frame_idx, packs, f)

    def _associate(self, frame_idx, packs, rgb) -> Track3DResult:
        with self.assoc.timer.stage("get2d"):
            ids_np, boxes_np, mask_np = _unpack2d(AsyncFetch(packs).get())
        return self.assoc.step(frame_idx, ids_np, boxes_np, mask_np, rgb)

    def flush(self) -> Optional[Track3DResult]:
        """Drain one stage of the pipelined tail: first the not-yet-
        associated 2D frame, then the associator's in-flight hypothesis
        solve.  Call until it returns None."""
        result = None
        if self._pending:
            prev_idx, prev_fetch, prev_rgb = self._pending.pop(0)
            with self.assoc.timer.stage("get2d"):
                ids_np, boxes_np, mask_np = _unpack2d(prev_fetch.get())
            result = self.assoc.step(prev_idx, ids_np, boxes_np, mask_np,
                                     prev_rgb)
        if result is None:
            result = self.assoc.collect()
        if result is not None:
            self.results.append(result)
        return result

    def deferred_result(self, frame_idx: int) -> Track3DResult:
        return self.assoc.result_at(frame_idx)
