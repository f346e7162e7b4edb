"""The fused 3D program as a captured program (models/associator3d.py::
FrameProgram, models/mwcp.py's three solve parts), on the CPU, where
each part runs eagerly from the program's static buffers.

- the greedy start to a static bound equals the greedy start to the
  number of valid vertices (the loop it replaces read that count on the
  host), an infinite weight outside the graph included;
- the solve with its masked row writes and its device iteration counter,
  whole or in blocks of FrameProgram.BLOCK iterations and a remainder,
  equals the eager solve it replaces (kept here as the reference),
  bit for bit;
- the program, run from its buffers on the recorded inputs of the
  10-frame pipeline scene, gives pack_a and pack_b equal to the eager
  body (Associator3D._rescore_and_solve) and to the JAX package's
  rescore_and_solve on the same inputs and the same random fields;
- two buckets run in turn keep their own buffers and results;
- the program's parts read no device value on the host;
- precompile makes exactly the pairs that fit max_vertices.

The 2D step as a program on static buffers (models/pipeline.py::
Tracker2DProgram), on the 10-frame pipeline scene:
- the program equals tracker2d_step bit for bit, every frame's packed
  output and every state leaf;
- tracker2d_step reads no device value on the host (the assignment's
  plain version, the JV kernel's place on the card, aside);
- a capture (a stand-in here: its eager warm-up writes the state) does
  not advance the state;
- a checkpoint round trip restores the program's buffers;
- a replay passes through no kernel wrapper and leaves their counts as
  they are; the card's kernel runs are counted on the card
  (utils/kernel_events.py), which needs a card and CUPTI.

The capture itself (CUDA graphs) runs only on a card: chip_smoke.py's
graph phases hold the replays against the eager body and the eager 2D
step there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario as j_make_scenario
from mcmtt_opticalflow_tpu.models.associator3d import \
    Associator3D as JaxAssociator3D
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models import mwcp
from mcmtt_opticalflow_tpu_torch.models.associator3d import (Associator3D,
                                                             FrameProgram)
from mcmtt_opticalflow_tpu_torch.models.mwcp import (MwcpResult,
                                                     threefry_fields)
from mcmtt_opticalflow_tpu_torch.checkpoint import (load_snapshot,
                                                    save_snapshot)
from mcmtt_opticalflow_tpu_torch.models.pipeline import (TrackingEngine,
                                                         _pack2d)
from mcmtt_opticalflow_tpu_torch.models.tracker2d import (
    init_tracker2d_state, tracker2d_step)
from mcmtt_opticalflow_tpu_torch.ops import hungarian
from mcmtt_opticalflow_tpu_torch.ops.lk_kernel import lk_level
from mcmtt_opticalflow_tpu_torch.utils import kernel_events, prng
from mcmtt_opticalflow_tpu_torch.utils.graphs import Graphed
from mcmtt_opticalflow_tpu_torch.utils.kernel_events import KernelEvents
from mcmtt_opticalflow_tpu_torch.utils.tree import tree_leaves
from torch_parity import jax_mwcp_fields, to_torch_fields

torch.set_num_threads(2)

NEG = mwcp.NEG
NUM_FRAMES = 10


# ------------------------------------------------ the replaced eager solve
def _greedy_to_nvalid(weights, adj, valid, orders, nvalid):
    """The greedy start as it ran before: to the host-read valid count."""
    r, v = orders.shape
    rows = torch.arange(r)
    in_c = torch.zeros((r, v), dtype=torch.bool)
    size = torch.zeros(r, dtype=torch.long)
    for i in range(nvalid):
        idx = orders[:, i]
        cnt = torch.sum(adj[idx] & in_c, -1)
        can = valid[idx] & (weights[idx] >= 0.0) & (cnt == size)
        in_c[rows, idx] |= can
        size += can
    return in_c


def _eager_solve(weights, adj, valid, init_mask, key, cfg, iters):
    """solve_mwcp as it ran before: host-read greedy bound, boolean-mask
    row writes, Python iteration numbers."""
    v = weights.shape[0]
    r = cfg.num_replicas
    s = cfg.solutions_per_replica
    iters_pad = mwcp.iters_padded(cfg, iters)
    nvalid_t = torch.sum(valid)
    l0 = torch.clamp(cfg.l0_ratio * nvalid_t, min=1.0)
    lmax = torch.clamp(cfg.lmax_ratio * nvalid_t, min=2.0)
    rows = torch.arange(r)
    warm = torch.zeros((r, v), dtype=torch.bool)
    rw = min(init_mask.shape[0], r)
    warm[:rw] = init_mask[:rw]
    f = threefry_fields(key, r, v, iters_pad, "cpu")
    adj_f = adj.to(torch.float32)
    adjc_f = (~adj).to(torch.float32)
    cnt = (warm.to(torch.float32) @ adj_f.T).to(torch.int64)
    wsize = torch.sum(warm, -1)
    is_clique = (torch.all(~warm | (cnt == (wsize - 1)[:, None]), -1)
                 & torch.any(warm, -1) & torch.all(~warm | valid, -1))
    noise = f.noise * torch.clamp(torch.max(torch.abs(weights)), min=1.0) * 0.3
    noise[0] = 0.0
    orders = torch.argsort(-torch.where(valid, weights + noise, NEG), dim=-1,
                           stable=True)
    greedy = _greedy_to_nvalid(weights, adj, valid, orders,
                               int(nvalid_t.item()))
    in_c = torch.where(is_clique[:, None], warm, greedy)
    score0 = torch.sum(torch.where(in_c, weights, 0.0), -1)
    tabu = torch.zeros((r, v), dtype=torch.int32)
    fbest, best, cp = score0.clone(), in_c.clone(), in_c.clone()
    wcnt = torch.zeros(r, dtype=torch.int32)
    l_left = torch.zeros(r)
    use_directed = torch.zeros(r, dtype=torch.bool)
    sol_masks = torch.zeros((r, s, v), dtype=torch.bool)
    sol_scores = torch.full((r, s), NEG)
    sol_next = torch.zeros(r, dtype=torch.int64)
    true_r = torch.ones(r, dtype=torch.bool)
    mwcp._record(sol_masks, sol_scores, sol_next, in_c, score0, true_r, s)
    for it in range(iters_pad):
        cnt = (in_c.to(torch.float32) @ adj_f.T).to(torch.int64)
        csize = torch.sum(in_c, -1)[:, None]
        free = valid & ~in_c
        pa = free & (cnt == csize)
        om = free & (cnt == csize - 1) & (csize > 0)
        fc = torch.sum(torch.where(in_c, weights, 0.0), -1)
        in_w = torch.where(in_c, weights, 0.0)
        w_partner = in_w @ adjc_f.T
        gain_ins = torch.where(pa, weights, NEG)
        gain_swp = torch.where(om, weights - w_partner, NEG)
        bi = torch.argmax(gain_ins, -1)
        bs = torch.argmax(gain_swp, -1)
        gi, gs = gain_ins[rows, bi], gain_swp[rows, bs]
        use_swap = gs > gi
        gain = torch.maximum(gi, gs)
        mv_v = torch.where(use_swap, bs, bi)
        partner = mwcp._argmax_first(in_c & ~adj[mv_v])
        improving = gain > 1e-9
        searching = l_left <= 0
        ls_in_c = in_c.clone()
        ls_in_c[rows, mv_v] = True
        ls_in_c[rows[use_swap], partner[use_swap]] = False
        do_ls = searching & improving
        at_opt = searching & ~improving
        better = fc > fbest
        up = at_opt & better
        fbest = torch.where(up, fc, fbest)
        best = torch.where(up[:, None], in_c, best)
        new_w = torch.where(at_opt, torch.where(better, 0, wcnt + 1), wcnt)
        same_as_cp = torch.all(in_c == cp, -1)
        esc = new_w > cfg.t_nonimprove
        l_new = torch.where(esc, lmax,
                            torch.where(same_as_cp, l_left + 1.0, l0))
        new_w = torch.where(at_opt & esc, 0, new_w).to(torch.int32)
        mwcp._record(sol_masks, sol_scores, sol_next, in_c, fc,
                     at_opt & ~same_as_cp & ~esc, s)
        cp = torch.where(at_opt[:, None], in_c, cp)
        p = torch.where(wcnt == 0, 0.0,
                        torch.clamp(torch.exp(-wcnt / cfg.t_nonimprove),
                                    max=cfg.p0))
        directed = f.u_dir[it] < p
        use_dir_now = torch.where(at_opt, directed, use_directed)
        new_l = torch.where(at_opt, l_new, l_left)
        perturbing = (l_left > 0) | at_opt
        tabu_ok = tabu <= it
        dir_mask = (pa & tabu_ok) | (om & tabu_ok) | in_c
        dv = torch.argmax(torch.where(dir_mask, f.g_dir[it], NEG), -1)
        dany = torch.any(dir_mask, -1)
        d_is_rem = in_c[rows, dv]
        d_is_swap = om[rows, dv]
        d_partner = mwcp._argmax_first(in_c & ~adj[dv])
        pert_dir = in_c.clone()
        pert_dir[rows, dv] = ~d_is_rem
        sw = d_is_swap & ~d_is_rem
        pert_dir[rows[sw], d_partner[sw]] = False
        om_count = torch.sum(om, -1)
        tenure = cfg.phi + (f.u_ten[it] * torch.clamp(om_count, min=1)
                            ).to(torch.int32)
        alpha = torch.where(wcnt == 0, cfg.alpha_s, cfg.alpha_r)
        nbr_w_in_c = in_w @ adj_f.T
        rnd_mask = free & (tabu_ok | (nbr_w_in_c >= (alpha * fc)[:, None]))
        rv = torch.argmax(torch.where(rnd_mask, f.g_rnd[it], NEG), -1)
        rany = torch.any(rnd_mask, -1)
        pert_rnd = in_c & adj[rv]
        pert_rnd[rows, rv] = True
        pert = torch.where((use_dir_now & dany)[:, None], pert_dir,
                           torch.where(rany[:, None], pert_rnd, in_c))
        out_in_c = torch.where(do_ls[:, None], ls_in_c,
                               torch.where(perturbing[:, None], pert, in_c))
        left = in_c & ~out_in_c
        tabu = torch.where(left, it + tenure[:, None], tabu)
        l_left = torch.where(do_ls, l_left, torch.clamp(new_l - 1.0, min=0.0))
        use_directed = torch.where(at_opt, directed, use_directed)
        wcnt = new_w
        in_c = out_in_c
    mwcp._record(sol_masks, sol_scores, sol_next, best, fbest, true_r, s)
    return MwcpResult(best, fbest, sol_masks, sol_scores)


def _graph(seed, v=96, n=80, inf_outside=True):
    """A random solver instance: weights [v] (one -inf weight outside
    the graph when asked), adjacency, validity (about 80% of the first
    n), warm starts of which the first is a clique of two."""
    rng = np.random.RandomState(seed)
    w = (rng.rand(v) * 10).astype(np.float32)
    up = np.triu(rng.rand(v, v) < 0.55, 1)
    adj = up | up.T
    valid = (np.arange(v) < n) & (rng.rand(v) < 0.8)
    if inf_outside:
        w[n + 2] = -np.inf
    adj[:, ~valid] = adj[~valid, :] = False
    init = np.zeros((3, v), bool)
    a = np.flatnonzero(valid)[0]
    b = np.flatnonzero(adj[a])[0]
    init[0, [a, b]] = True
    return (torch.tensor(w), torch.tensor(adj), torch.tensor(valid),
            torch.tensor(init))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("inf_outside", [False, True])
def test_greedy_to_static_bound_equals_greedy_to_nvalid(seed, inf_outside):
    w, adj, valid, _ = _graph(seed, inf_outside=inf_outside)
    v = w.shape[0]
    f = threefry_fields(prng.prng_key(seed), 6, v, 1, "cpu")
    noise = f.noise * torch.clamp(torch.max(torch.abs(w)), min=1.0) * 0.3
    noise[0] = 0.0
    orders = torch.argsort(-torch.where(valid, w + noise, NEG), dim=-1,
                           stable=True)
    nvalid = int(valid.sum())
    want = _greedy_to_nvalid(w, adj, valid, orders, nvalid)
    assert want.any()
    for bound in (nvalid, 88, v):
        got = mwcp._greedy_initial(w, adj, valid, orders, bound)
        assert torch.equal(got, want), bound


@pytest.mark.parametrize("iters", [150, 77])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_equals_the_eager_solve(iters, seed):
    """solve_mwcp, and the solve in blocks of BLOCK iterations plus a
    remainder as FrameProgram runs it, against the replaced eager solve
    (77 is not a multiple of BLOCK)."""
    w, adj, valid, init = _graph(seed)
    v = w.shape[0]
    cfg = tcfg.SolverConfig(num_replicas=6, max_vertices=v,
                            solutions_per_replica=8)
    key = prng.prng_key(10 + seed)
    want = _eager_solve(w, adj, valid, init, key, cfg, iters)
    assert float(want.best_score.max()) > 0.0
    _same(mwcp.solve_mwcp(w, adj, valid, init, key, cfg, iters), want)

    f = mwcp.draw_fields(key, 6, v, iters, "cpu")
    st = mwcp.bls_start(w, adj, valid, init, f, cfg, 88)
    for _ in range(iters // FrameProgram.BLOCK):
        mwcp.bls_steps(st, f, cfg, FrameProgram.BLOCK)
    mwcp.bls_steps(st, f, cfg, iters % FrameProgram.BLOCK)
    assert int(st.it) == iters
    _same(mwcp.bls_result(st), want)


# ------------------------------------------------------- the whole program
def _cfg(mod):
    return mod.EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        tracker2d=mod.Tracker2DConfig(max_detections=16, max_trackers=32,
                                      max_features=16, lk_window=8,
                                      lk_pyramid_levels=2, lk_iterations=6),
        solver=mod.SolverConfig(num_replicas=4, max_vertices=64,
                                solutions_per_replica=8, max_iterations=200))


class _OneDraw:
    """A field source handing out one set of fields."""

    def __init__(self, fields):
        self.fields = fields

    def draw(self, r, v, iters_pad, device):
        return self.fields


@pytest.fixture(scope="module")
def recorded():
    """The port's engine on the 10-frame pipeline scene (the default
    solver stream): every FrameProgram call's bucket, host arrays,
    subkey and outputs."""
    sc = make_scenario(num_cameras=2, num_frames=NUM_FRAMES, num_people=3,
                       image_size=(256, 192), arena=5000.0, seed=11)
    eng = TrackingEngine(_cfg(tcfg), sc.cameras, device="cpu")
    calls = []
    orig = FrameProgram.__call__

    def record(prog, host, key, field_source=None):
        out = orig(prog, host, key, field_source)
        calls.append((prog.bucket, [np.array(x) for x in host], key.clone(),
                      tuple(o.clone() for o in out)))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FrameProgram, "__call__", record)
        for t in range(NUM_FRAMES):
            eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                              frame_idx=t)
    assert len(calls) >= 6 and any(len(r.ids) for r in eng.results), \
        "the scene solved too few frames: the tests would be vacuous"
    return sc, eng, calls


def _eager(assoc, host, fields, iters):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in host]
    return assoc._rescore_and_solve(*t, fields, iters, (t[7], t[9], t[10]))


def test_program_equals_eager_body(recorded):
    _, eng, calls = recorded
    for (nr, nb, iters), host, key, out in calls:
        assert out[0].shape[0] == nr and host[7].shape[0] == nb
        _same(out, _eager(eng.assoc, host, key, iters))


def test_program_equals_jax_rescore_and_solve(recorded, monkeypatch):
    """The program with the JAX package's fields of each recorded subkey
    against the JAX program on the same inputs and subkey (its two-leaf
    output)."""
    sc, eng, calls = recorded
    monkeypatch.setenv("MCMTT_SOLVE_LEAVES", "2")
    jsc = j_make_scenario(num_cameras=2, num_frames=1, num_people=3,
                          image_size=(256, 192), arena=5000.0, seed=11)
    jassoc = JaxAssociator3D(_cfg(jcfg), jsc.cameras)
    assoc = Associator3D(_cfg(tcfg), sc.cameras, device="cpu")
    r = assoc._solver_cfg_fused.num_replicas
    for (nr, nb, iters), host, key, _ in calls:
        jkey = jnp.asarray(key.numpy().astype(np.uint32))
        want = jassoc._rescore_and_solve(
            *[jnp.asarray(x) for x in host[:5]], jassoc.cams,
            *[jnp.asarray(x) for x in host[5:]], jkey, iters=iters)
        fields = to_torch_fields(jax_mwcp_fields(
            jkey, r, assoc.cfg.solver.max_vertices,
            mwcp.iters_padded(assoc._solver_cfg_fused, iters)))
        got = assoc._program(nr, nb, iters)(host, key, _OneDraw(fields))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        pack_b, want_b = got[1].numpy(), np.asarray(want[1])
        np.testing.assert_array_equal(pack_b[:, :-4], want_b[:, :-4])
        # the K-best scores are sums in torch's order: within an ulp of
        # XLA's (ROADMAP.md, Queue 3, "not faults")
        np.testing.assert_array_max_ulp(
            pack_b[:, -4:].copy().view(np.float32),
            want_b[:, -4:].copy().view(np.float32), maxulp=1)
        _same(got, _eager(assoc, host, _OneDraw(fields), iters))


def _grow_rows(host, nr):
    """The same frame as an input of the rescore bucket nr: zero rows
    (length 0) appended to the five rescoring arrays."""
    out = list(host)
    for i in range(5):
        pad = np.zeros((nr - host[i].shape[0],) + host[i].shape[1:],
                       host[i].dtype)
        out[i] = np.concatenate([host[i], pad])
    return out


def test_buckets_in_turn_keep_their_own_buffers(recorded):
    """Two buckets run in turn, each on two frames: every result equals
    the eager body on its inputs, and no buffer of one bucket shares
    storage with the other's."""
    sc, _, calls = recorded
    assoc = Associator3D(_cfg(tcfg), sc.cameras, device="cpu")
    (nr, nb, iters), h1, k1, _ = calls[-2]
    _, h2, k2, _ = calls[-1]
    runs = [(nr, h1, k1), (2 * nr, _grow_rows(h2, 2 * nr), k2),
            (nr, h2, k2), (2 * nr, _grow_rows(h1, 2 * nr), k1)]
    for rows, host, key in runs:
        got = assoc._program(rows, nb, iters)(host, key)
        assert got[0].shape[0] == rows
        _same(got, _eager(assoc, host, key, iters))
    a, b = (assoc._programs[(x, nb, iters)] for x in (nr, 2 * nr))

    def storages(p):
        return {t.untyped_storage().data_ptr()
                for t in (*p.inputs, p.key, *p.fields)}
    assert not storages(a) & storages(b)


def test_program_makes_no_host_sync(recorded, monkeypatch):
    """Every part of the program runs with the host reads of device
    values patched to raise, and with indexed writes of host values
    (a copy from the host on the card) refused."""
    sc, _, calls = recorded
    assoc = Associator3D(_cfg(tcfg), sc.cameras, device="cpu")
    (nr, nb, iters), host, key, out = calls[-1]
    prog = assoc._program(nr, nb, iters)

    def refuse(*a, **k):
        raise AssertionError("host read of a device value")
    setitem = torch.Tensor.__setitem__

    def device_values_only(t, index, value):
        advanced = any(isinstance(i, torch.Tensor) for i in (
            index if isinstance(index, tuple) else (index,)))
        if advanced and not isinstance(value, torch.Tensor):
            raise AssertionError("indexed write of a host value")
        return setitem(t, index, value)
    monkeypatch.setattr(torch.Tensor, "__setitem__", device_values_only)
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    got = prog(host, key)
    monkeypatch.undo()
    _same(got, out)


def test_a_captured_program_replays_each_part_once_a_frame(recorded,
                                                          monkeypatch):
    """With every part captured (stand-in graphs that count replays), a
    frame replays the draw, the head and the tail once, the block
    iters // BLOCK times and the remainder once — and nothing more."""
    sc, _, calls = recorded
    assoc = Associator3D(_cfg(tcfg), sc.cameras, device="cpu")
    (nr, nb, iters), host, key, _ = calls[-1]
    prog = assoc._program(nr, nb, iters)
    prog(host, key)

    class Counted:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1
    monkeypatch.setattr(type(prog.head), "on_card", property(lambda g: True))
    for part in prog.parts():
        part.graph = Counted()
    prog(host, key)
    want = {prog.draw: 1, prog.head: 1, prog.block: prog.blocks,
            prog.rest: 1, prog.tail: 1}
    assert prog.blocks == iters // FrameProgram.BLOCK > 0
    assert [p.graph.replays for p in prog.parts()] == \
        [want[p] for p in prog.parts()]


@pytest.mark.parametrize("vmax,want", [
    (64, []), (512, [(512, 512)]),
    (1024, [(256, 1024), (512, 512), (512, 1024)])])
def test_precompile_builds_the_pairs_that_fit(vmax, want):
    sc = make_scenario(num_cameras=2, num_frames=1, num_people=1,
                       image_size=(256, 192), seed=1)
    cfg = tcfg.EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        solver=tcfg.SolverConfig(num_replicas=2, max_vertices=vmax,
                                 max_iterations=3))
    assoc = Associator3D(cfg, sc.cameras, device="cpu")
    assoc.precompile()
    assert sorted(assoc._programs) == [(nr, nb, 3) for nr, nb in want]
    for (nr, nb, _), prog in assoc._programs.items():
        assert prog.inputs[0].shape[0] == nr and prog.inputs[7].shape == (nb,)


# ------------------------------------------------------ the 2D step program
def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))


@pytest.fixture(scope="module")
def recorded2d():
    """The port's engine (no mesh: its 2D program, run eagerly from its
    static buffers on the CPU) on the 10-frame pipeline scene: after each
    frame, the program's inputs (8-bit gray, boxes, mask), its packed
    output and its state buffers."""
    sc = make_scenario(num_cameras=2, num_frames=NUM_FRAMES, num_people=3,
                       image_size=(256, 192), arena=5000.0, seed=11)
    eng = TrackingEngine(_cfg(tcfg), sc.cameras, device="cpu")
    prog = eng._progs2d[0]
    frames = []
    for t in range(NUM_FRAMES):
        eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                          frame_idx=t)
        frames.append({
            "inputs": [x.clone() for x in (prog.gray_u8, prog.boxes,
                                           prog.mask)],
            "frame_idx": int(prog.frame_idx),
            "pack": prog.graph.out.clone(),
            "state": [x.clone() for x in tree_leaves(prog.state)]})
    assert any(f["pack"][..., 1].sum() > 0 for f in frames[2:]), \
        "the scene emitted no tracklet: the tests would be vacuous"
    return sc, eng, frames


def _eager_2d(eng, frames, n):
    """tracker2d_step itself over the first n recorded frames, from a
    zero state, frame numbers as Python ints: [(pack, state leaves)]."""
    cfg = eng.cfg
    state = init_tracker2d_state(cfg.tracker2d, cfg.image_height,
                                 cfg.image_width, cfg.num_cameras,
                                 device="cpu")
    out = []
    for t, f in enumerate(frames[:n]):
        gray_u8, boxes, mask = f["inputs"]
        state, o = tracker2d_step(state, gray_u8.float() * (1.0 / 255.0),
                                  boxes, mask, eng.cams, t, cfg.tracker2d)
        out.append((_pack2d(o), tree_leaves(state)))
    return out


def test_2d_program_equals_the_eager_step(recorded2d):
    """The program from its buffers (frame number a 0-dim int32 tensor)
    equals tracker2d_step (frame number an int) bit for bit: every
    frame's pack and every state leaf.  tests/test_torch_pipeline.py
    holds the same engine's 2D outputs against the JAX engine's."""
    _, eng, frames = recorded2d
    for t, (pack, state) in enumerate(_eager_2d(eng, frames, NUM_FRAMES)):
        assert frames[t]["frame_idx"] == t
        _same_bits([frames[t]["pack"]] + frames[t]["state"], [pack] + state)


def test_tracker2d_step_reads_nothing_on_the_host(recorded2d, monkeypatch):
    """tracker2d_step over the scene with the host reads of device values
    (item, tolist, cpu, numpy, truth and number conversions, nonzero),
    boolean-mask indexing and indexed writes of host values patched to
    raise; only the assignment's plain version, the JV kernel's place on
    the card, runs unpatched.  Its results stay the program's."""
    _, eng, frames = recorded2d
    refuse_names = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                    "__float__", "__index__")
    orig = {n: getattr(torch.Tensor, n) for n in refuse_names}
    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def refuse(*a, **k):
        raise AssertionError("host read of a device value")

    def indices(index):
        return index if isinstance(index, tuple) else (index,)

    def no_mask(t, index):
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in indices(index)):
            raise AssertionError("boolean-mask indexing (a host sync)")
        return getitem(t, index)

    def device_values_only(t, index, value):
        advanced = any(isinstance(i, torch.Tensor) for i in indices(index))
        if advanced and not isinstance(value, torch.Tensor):
            raise AssertionError("indexed write of a host value")
        return setitem(t, index, value)

    def patch():
        for n in refuse_names:
            setattr(torch.Tensor, n, refuse)
        torch.Tensor.__getitem__ = no_mask
        torch.Tensor.__setitem__ = device_values_only
        torch.nonzero = refuse

    def unpatch():
        for n, fn in orig.items():
            setattr(torch.Tensor, n, fn)
        torch.Tensor.__getitem__, torch.Tensor.__setitem__ = getitem, setitem
        torch.nonzero = nonzero

    nonzero = torch.nonzero
    plain = hungarian.jv_assign_reference

    def plain_unpatched(*a):
        unpatch()
        try:
            return plain(*a)
        finally:
            patch()
    monkeypatch.setattr(hungarian, "jv_assign_reference", plain_unpatched)
    want = _eager_2d(eng, frames, 4)
    patch()
    try:
        got = _eager_2d(eng, frames, 4)
    finally:
        unpatch()
    for (gp, gs), (wp, ws) in zip(got, want):
        _same_bits([gp] + gs, [wp] + ws)


class _Replayed:
    """A stand-in CUDA graph: replaying runs the Graphed's function."""

    def __init__(self, graphed):
        self.graphed, self.replays = graphed, 0

    def replay(self):
        self.replays += 1
        self.graphed.out = self.graphed.fn()


def _stand_in_capture(g):
    """What Graphed.capture does off the card's API: one eager warm-up
    run, then a graph (here a stand-in)."""
    g.fn()
    g.graph = _Replayed(g)


def test_2d_capture_does_not_advance_the_state(recorded2d, monkeypatch):
    """A capture runs the step once eagerly (its warm-up), which writes
    the new state into the buffers; the program puts the state back, so
    the replay that follows advances it exactly one frame."""
    sc, _, frames = recorded2d
    eng = TrackingEngine(_cfg(tcfg), sc.cameras, device="cpu")
    for t in range(3):
        eng.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                          frame_idx=t)
    prog = eng._progs2d[0]
    before = [x.clone() for x in tree_leaves(prog.state)]
    monkeypatch.setattr(Graphed, "on_card", property(lambda g: True))
    monkeypatch.setattr(Graphed, "capture", _stand_in_capture)
    prog.capture()
    assert isinstance(prog.graph.graph, _Replayed)
    _same_bits(tree_leaves(prog.state), before)
    prog.capture()                  # captured: nothing more to do
    assert prog.graph.graph.replays == 0
    eng.process_frame(np.stack(sc.frames(3)), sc.detections[3], frame_idx=3)
    assert prog.graph.graph.replays == 1
    _same_bits([prog.graph.out] + tree_leaves(prog.state),
               [frames[3]["pack"]] + frames[3]["state"])


def test_2d_checkpoint_round_trip_restores_the_program_buffers(
        recorded2d, tmp_path):
    """save_snapshot reads the program's state; load_snapshot writes it
    into a fresh engine's buffers (they stay the program's), and both
    engines then give the same 2D outputs."""
    sc, _, frames = recorded2d
    a = TrackingEngine(_cfg(tcfg), sc.cameras, device="cpu")
    for t in range(4):
        a.process_frame(np.stack(sc.frames(t)), sc.detections[t],
                        frame_idx=t)
    path = str(tmp_path / "snap.pkl")
    save_snapshot(a, path)
    b = TrackingEngine(_cfg(tcfg), sc.cameras, device="cpu")
    buffers = tree_leaves(b._progs2d[0].state)
    assert load_snapshot(b, path) == 3
    assert b.state2d_groups[0] is b._progs2d[0].state
    assert all(x is y for x, y in zip(tree_leaves(b._progs2d[0].state),
                                      buffers))
    _same_bits(tree_leaves(b._progs2d[0].state), frames[3]["state"])
    for eng in (a, b):
        eng.process_frame(np.stack(sc.frames(4)), sc.detections[4],
                          frame_idx=4)
    _same_bits([b._progs2d[0].graph.out] + tree_leaves(b._progs2d[0].state),
               [frames[4]["pack"]] + frames[4]["state"])
    # the getter hands out a copy: the next frame leaves it as it was
    held = b.state2d
    b.process_frame(np.stack(sc.frames(5)), sc.detections[5], frame_idx=5)
    _same_bits(tree_leaves(held), frames[4]["state"])


def test_a_replay_leaves_the_wrappers_counts(monkeypatch):
    """A replay runs no Python, so no kernel wrapper sees it: Graphed
    counts its replays and touches no launch count."""
    g = Graphed(lambda: None, "cpu")
    monkeypatch.setattr(Graphed, "on_card", property(lambda g: True))
    g.graph = _Replayed(g)
    counts = (lk_level.launches, lk_level.serial_launches,
              hungarian.jv_assign.launches)
    g()
    g()
    assert g.n_replays == 2 and g.graph.replays == 2
    assert (lk_level.launches, lk_level.serial_launches,
            hungarian.jv_assign.launches) == counts


def test_kernel_events_needs_a_card_and_cupti(monkeypatch, tmp_path):
    """The counter of the card's kernel runs refuses to start without a
    card, finds no CUPTI where there is none, and sums its counts by part
    of the demangled name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with KernelEvents():
            pass
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUPTI not found"):
        kernel_events.build()
    ev = KernelEvents()
    ev.counts = {"void lk_level_kernel<false, 16>(float const*)": 304,
                 "void lk_level_kernel<true, 16>(float const*)": 6,
                 "(anonymous namespace)::jv_assign_kernel(float const*)": 38}
    assert (ev.count("lk_level_kernel<false"), ev.count("lk_level_kernel"),
            ev.count("jv_assign_kernel"), ev.total) == (304, 310, 38, 348)
