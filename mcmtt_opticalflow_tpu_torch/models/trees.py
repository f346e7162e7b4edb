"""Host-side track / tracklet / tree bookkeeping.

The reference's MHT data model is a pointer graph of std::list-owned
objects (Track3D / TrackTree, psn_where/PSNWhere_Types.h:258-469) walked
recursively (PSNWhere_Types.cpp:544-809).  Variable-topology bookkeeping is
the one part of the engine that belongs on the host; device code sees only
padded arrays assembled from these records.  Pointer recursion becomes
id-indexed dict walks (iterative, no Python recursion limits).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Tracklet:
    """A 2D tracklet (ref stTracklet2D, PSNWhere_Types.h:258-282)."""

    id: int
    cam: int
    time_start: int
    time_end: int
    duration: int = 1
    activated: bool = True
    box: np.ndarray = None            # [4]
    loc3d: np.ndarray = None          # [3] current ground location
    bp_top: np.ndarray = None         # [3] back-projection line, z=2000 end
    bp_bottom: np.ndarray = None      # [3] z=0 end
    sensitivity: float = 0.0
    rgb_head: np.ndarray = None       # [48] first-frame histogram
    rgb_tail: np.ndarray = None       # [48] latest histogram
    # associability to this frame's new measurements, per camera
    assoc: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Track:
    """A 3D track hypothesis (ref Track3D, PSNWhere_Types.h:355-416).

    Per-position arrays cover the whole track life; `n_measured` counts
    positions up to the last real measurement (dummies appended during a
    pause sit beyond it, ref Associator3D.cpp:1552-1562)."""

    id: int
    tree_id: int
    parent: Optional[int]
    num_cams: int
    combination: Tuple[int, ...]      # current tracklet id per cam (-1 none)
    time_start: int
    time_end: int
    time_generation: int
    children: List[int] = dataclasses.field(default_factory=list)
    tid_hist: List[List[int]] = None  # tracklet id history per cam
    active: bool = True
    valid: bool = True
    new_track: bool = True
    current_best: bool = False
    n_measured: int = 0

    points: np.ndarray = None         # [L, 3]
    smoothed: np.ndarray = None       # [L, 3]
    velocity: np.ndarray = None       # [L, 3]
    raw_points: np.ndarray = None     # [L, C, 3]
    raw_mask: np.ndarray = None       # [L, C]
    max_error: np.ndarray = None      # [L]
    is_meas: np.ndarray = None        # [L]
    cost_recon_pos: np.ndarray = None  # [L]
    cost_link_pos: np.ndarray = None   # [L]

    cost_enter: float = 0.0
    cost_exit: float = 0.0
    cost_rgb: float = 0.0
    gt_prob: float = 0.0
    # NOTE: the reference's BranchGTProb (written at PSNWhere_Types.cpp:
    # 700-746 but consumed by dead code only) is intentionally not carried
    num_outpoint: int = 0

    # per-camera last-tracklet info (ref Track3D fields, Types.h:409-412)
    last_t_end: np.ndarray = None     # [C] int
    last_t_loc: np.ndarray = None     # [C, 3]
    last_sens: np.ndarray = None      # [C]
    last_rgb: np.ndarray = None       # [C, 48]

    # memoized total_cost: every per-frame ordering pass (branching,
    # hypothesis-pool ranking, pruning) sorts by cost, and the reference's
    # GetCost re-sums the per-position arrays each call; mutation sites
    # call invalidate_cost()
    _cost_cache: Optional[float] = dataclasses.field(
        default=None, repr=False, compare=False)
    # capacity-doubling append storage: the public per-position fields are
    # zero-copy VIEWS into these buffers, so the per-frame position append
    # is O(1) amortized instead of 9 full-array reallocations per track
    # per frame (the std::deque push_back of the reference's
    # Track3D.reconstructions, PSNWhere_Types.h:381)
    _cap: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False)
    _bufs: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # (hist_ver, codes-ndarray) cache for the tracklet-share incidence
    # (associator3d._shared_matrix); _hist_ver bumps on every tid_hist
    # append and clones carry it with the copied history, so it is a
    # cheaper invalidation key than re-summing the per-camera lengths
    _share_cache: Optional[Tuple[int, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _hist_ver: int = dataclasses.field(default=0, repr=False, compare=False)

    @property
    def length(self) -> int:
        return 0 if self.points is None else len(self.points)

    @property
    def duration(self) -> int:
        return self.n_measured

    def invalidate_cost(self) -> None:
        self._cost_cache = None

    _POS_ARRAYS = ("points", "smoothed", "velocity", "raw_points",
                   "raw_mask", "max_error", "is_meas", "cost_recon_pos",
                   "cost_link_pos")

    def invalidate_buffers(self) -> None:
        """Call after assigning fresh per-position arrays wholesale."""
        self._cap = None
        self._bufs = {}

    def append_position_row(self, *rows) -> None:
        """Append one row to every per-position array (order of
        _POS_ARRAYS), growing the backing buffers geometrically.
        Unrolled: every active/paused track appends once per frame, and
        the generic zip/getattr/setattr loop measured ~40% slower."""
        n = self.length
        if self._cap is None or self._cap < n + 1:
            newcap = max(8, 2 * (n + 1))
            for name in self._POS_ARRAYS:
                cur = getattr(self, name)
                buf = np.zeros((newcap,) + cur.shape[1:], cur.dtype)
                buf[:n] = cur
                self._bufs[name] = buf
            self._cap = newcap
        bufs = self._bufs
        n1 = n + 1
        b = bufs["points"]; b[n] = rows[0]; self.points = b[:n1]
        b = bufs["smoothed"]; b[n] = rows[1]; self.smoothed = b[:n1]
        b = bufs["velocity"]; b[n] = rows[2]; self.velocity = b[:n1]
        b = bufs["raw_points"]; b[n] = rows[3]; self.raw_points = b[:n1]
        b = bufs["raw_mask"]; b[n] = rows[4]; self.raw_mask = b[:n1]
        b = bufs["max_error"]; b[n] = rows[5]; self.max_error = b[:n1]
        b = bufs["is_meas"]; b[n] = rows[6]; self.is_meas = b[:n1]
        b = bufs["cost_recon_pos"]; b[n] = rows[7]
        self.cost_recon_pos = b[:n1]
        b = bufs["cost_link_pos"]; b[n] = rows[8]
        self.cost_link_pos = b[:n1]
        # incremental memo update: the appended row adds exactly its recon
        # + link costs to the total, so a warm cache stays warm — every
        # active/paused track appends once per frame, and re-summing the
        # arrays for each of the ~2700 total_cost() calls per frame was a
        # top-5 host cost at bench density (rows order = _POS_ARRAYS:
        # cost_recon_pos is rows[7], cost_link_pos rows[8])
        if self._cost_cache is not None:
            self._cost_cache += float(rows[7]) + float(rows[8])

    # position rows trimmed off the front of the history (their recon +
    # link costs fold into this carried scalar; time_start advances by the
    # trimmed count so absolute-frame indexing stays consistent)
    cost_trimmed: float = 0.0

    def total_cost(self) -> float:
        """(ref GetCost, Associator3D.cpp:2567-2578)"""
        if self._cost_cache is None:
            self._cost_cache = (
                self.cost_enter + self.cost_trimmed
                + float(self.cost_recon_pos.sum())
                + float(self.cost_link_pos.sum()) + self.cost_rgb
                + self.cost_exit)
        return self._cost_cache

    def trim_front(self, keep: int) -> None:
        """Drop all but the last `keep` position rows, folding the dropped
        rows' costs into cost_trimmed and advancing time_start.  Bounds
        per-track memory and branch-clone cost to O(keep) over arbitrarily
        long sequences (the reference's deques grow unboundedly,
        PSNWhere_Types.h:381).  Only rows older than every consumer's
        reach may be trimmed — the engine trims to beyond the compat grid
        / smoother / deferred-output windows."""
        k = self.length - keep
        if k <= 0:
            return
        self.cost_trimmed += (float(self.cost_recon_pos[:k].sum())
                              + float(self.cost_link_pos[:k].sum()))
        for name in self._POS_ARRAYS:
            setattr(self, name, getattr(self, name)[k:].copy())
        self.time_start += k
        self.n_measured = max(self.n_measured - k, 0)
        self.invalidate_buffers()
        # total_cost is INVARIANT under trimming (the dropped rows' costs
        # moved into cost_trimmed), so a warm memo stays valid

    def point_at(self, frame_idx: int, time_start: Optional[int] = None):
        """Smoothed position at an absolute frame, or None."""
        ts = self.time_start if time_start is None else time_start
        i = frame_idx - ts
        if i < 0 or i >= self.length:
            return None
        return self.smoothed[i]


@dataclasses.dataclass
class TrackTree:
    """(ref TrackTree, PSNWhere_Types.h:434-469)"""

    id: int
    time_generation: int
    valid: bool = True
    confirmed: bool = False
    track_ids: List[int] = dataclasses.field(default_factory=list)


class TrackRegistry:
    """Owns all tracks and trees; id-indexed pointer-free tree walks."""

    def __init__(self):
        self.tracks: Dict[int, Track] = {}
        self.trees: Dict[int, TrackTree] = {}
        self.next_track_id = 0
        self.next_tree_id = 0

    # ---- tree walks (iterative ports of PSNWhere_Types.cpp:616-809) -------
    def branch_tracks(self, root_id: int) -> List[int]:
        """All descendants incl. root (ref GetTracksInBranch :660-669)."""
        out, stack = [], [root_id]
        while stack:
            tid = stack.pop()
            t = self.tracks.get(tid)
            if t is None:
                continue
            out.append(tid)
            stack.extend(t.children)
        return out

    def set_branch_validity(self, root_id: int, valid: bool) -> None:
        """(ref SetValidityFlagInTrackBranch :639-648)"""
        for tid in self.branch_tracks(root_id):
            self.tracks[tid].valid = valid

    def oldest_track_in_branch(self, track_id: int,
                               most_previous_frame: int) -> int:
        """Climb to the oldest ancestor generated after the pruning time
        (ref FindOldestTrackInBranch :799-809)."""
        cur = self.tracks[track_id]
        while cur.parent is not None:
            parent = self.tracks.get(cur.parent)
            if parent is None or most_previous_frame >= parent.time_generation:
                break
            cur = parent
        return cur.id

    def new_tree(self, time_generation: int) -> TrackTree:
        tree = TrackTree(id=self.next_tree_id,
                         time_generation=time_generation)
        self.trees[tree.id] = tree
        self.next_tree_id += 1
        return tree

    def add_track(self, track: Track) -> Track:
        self.tracks[track.id] = track
        self.trees[track.tree_id].track_ids.append(track.id)
        if track.parent is not None and track.parent in self.tracks:
            self.tracks[track.parent].children.append(track.id)
        return track

    def alloc_track_id(self) -> int:
        tid = self.next_track_id
        self.next_track_id += 1
        return tid

    def gc(self, horizon: Optional[int] = None, roots=None) -> None:
        """Delete every invalid track except ancestors of valid tracks
        (the N-scan-back walk climbs parent chains, so a valid track's
        lineage must survive); drop empty trees.  The reference frees
        invalid tracks every frame (ref Associator3D.cpp:1694-1714 +
        1609-1641) — only collecting them when their whole tree died
        leaks thousands of Track objects per PETS-scale run and every
        per-frame registry sweep slows with it.

        horizon: the N-scan pruning time (frame_idx - proc_window_size).
        The climb (oldest_track_in_branch) stops at the first ancestor
        generated at/before it and reads only that node's parent link +
        children, so deeper ancestors are unreachable — at 22-person
        density uncapped chains held ~7000 dead ancestors by frame 30.

        Collected interior connectors SPLICE: a surviving track whose
        parent was collected is re-attached to its nearest surviving
        ancestor.  Downward N-scan kill-walks (set_branch_validity from a
        fork's children) therefore still reach every surviving subtree —
        without the splice, a sibling subtree hanging two or more
        below-horizon levels under a fork would silently escape
        invalidation once its connector was collected (the reference
        always walks the full lineage, ref Hypothesis_PruningNScanBack
        Associator3D.cpp:2845-2948).  Upward climbs are unaffected: only
        at/below-horizon nodes are collected, and the climb treats every
        such node the same (stop + read parent).

        roots: when given, the keep-set seeds from these ids instead of
        every valid track.  Terminated-but-valid tracks the engine no
        longer references from ANY live list (active/paused/window/
        hypothesis selected+related/best) are then collected too — the
        reference keeps such tracks alive forever ("for logging",
        Associator3D.cpp:1539-1549), which grows its memory ~0.5 tracks/
        frame on long sequences; collecting the unreachable ones cannot
        change results (nothing ever reads them again)."""
        keep = set()
        if roots is None:
            seed_ids = [tid for tid, t in self.tracks.items() if t.valid]
        else:
            seed_ids = [tid for tid in roots if tid in self.tracks]
        for tid in seed_ids:
            cur = tid
            while cur is not None and cur not in keep:
                keep.add(cur)
                tr = self.tracks.get(cur)
                if tr is None:
                    break
                if horizon is not None and tr.time_generation <= horizon:
                    # climb stops here; the prune step still reads this
                    # node's parent (seed.parent + its children list)
                    if tr.parent is not None:
                        keep.add(tr.parent)
                    break
                cur = tr.parent
        if len(keep) != len(self.tracks):
            old = self.tracks
            self.tracks = {tid: old[tid] for tid in sorted(keep)}
            for t in self.tracks.values():
                t.children = [ch for ch in t.children if ch in keep]
            for t in self.tracks.values():
                p = t.parent
                while p is not None and p not in keep:
                    anc = old.get(p)
                    p = anc.parent if anc is not None else None
                if p != t.parent:
                    t.parent = p
                    if p is not None:
                        self.tracks[p].children.append(t.id)
        for tree_id in list(self.trees):
            tree = self.trees[tree_id]
            tree.track_ids = [tid for tid in tree.track_ids
                              if tid in self.tracks]
            if not tree.track_ids:
                del self.trees[tree_id]
