"""The solver's field draw (ops/threefry_kernel.py) at small sizes, with v
not a multiple of 4: the wrapper on CPU tensors (its plain version, into
given buffers and into new ones) bit-equal to models/mwcp.py's
threefry_fields, with no kernel launch; the same draw against the JAX
package's own jax.random draws (mwcp.py:134-141, 279-284): bits and
uniforms bit-equal, gumbel within 2 ulp of max(|g|, 1); FrameProgram's
draw part filling its static fields in place from its key buffer; the
wrapper's rejections; field_work against a hand count; and (on a card
only) the kernel bit-equal to its plain version."""

import jax
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.associator3d import Associator3D
from mcmtt_opticalflow_tpu_torch.models.mwcp import (MwcpFields,
                                                     iters_padded,
                                                     threefry_fields)
from mcmtt_opticalflow_tpu_torch.ops import threefry_kernel as tk
from mcmtt_opticalflow_tpu_torch.utils import prng
from torch_parity import cuda_device, jax_mwcp_fields  # noqa: F401

torch.set_num_threads(2)

SHAPES = [(3, 40, 8), (5, 37, 3), (1, 1, 1)]
GUMBEL_ULPS = 2


def _key(seed):
    """A solver subkey from a numpy-made seed: split(PRNGKey(seed))[1]."""
    seed = int(np.random.RandomState(seed).randint(0, 2 ** 31 - 1))
    return seed, prng.split(prng.prng_key(seed))[1]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    r, v, ip = shape
    _, key = _key(sum(shape))
    want = threefry_fields(key, r, v, ip, "cpu")
    launches = tk.threefry_fields.launches
    new = tk.threefry_fields(key, r, v, ip)
    _same_bits(new, want)
    _same_bits(tk.threefry_fields_reference(key, r, v, ip), want)
    out = tuple(torch.full(s, 7.0) for s in tk.field_shapes(r, v, ip))
    got = tk.threefry_fields(key, r, v, ip, out)
    assert all(g is o for g, o in zip(got, out))
    _same_bits(out, want)
    into = threefry_fields(key, r, v, ip, "cpu",
                           MwcpFields(*[torch.zeros_like(x) for x in want]))
    _same_bits(into, want)
    assert tk.threefry_fields.launches == launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_draw_equals_jax(shape):
    r, v, ip = shape
    seed, key = _key(100 + sum(shape))
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    want = jax_mwcp_fields(jkey, r, v, ip)
    got = tk.threefry_fields(key, r, v, ip)
    # the bits under each field's key, as jax.random.bits draws them
    keys = jax.random.split(jkey, r + 1)
    ku1 = jax.random.split(keys[r], 4)[0]
    np.testing.assert_array_equal(
        prng.random_bits(prng.split(key, r + 1)[:r], (v,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (v,)))(keys[:r]))
        .astype(np.int64))
    np.testing.assert_array_equal(
        prng.random_bits(prng.split(prng.split(key, r + 1)[r], 4)[0],
                         (ip, r)).numpy(),
        np.asarray(jax.random.bits(ku1, (ip, r))).astype(np.int64))
    for name in ("noise", "u_dir", "u_ten"):
        np.testing.assert_array_equal(
            got[tk.FIELDS.index(name)].numpy(),
            np.asarray(getattr(want, name)), err_msg=name)
    for name in ("g_dir", "g_rnd"):
        g = got[tk.FIELDS.index(name)].numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape
        d = np.abs(g.astype(np.float64) - w.astype(np.float64))
        ulp = np.spacing(np.maximum(np.abs(w), np.float32(1.0)))
        assert (d <= GUMBEL_ULPS * ulp).all(), (name, float((d / ulp).max()))


def _assoc():
    cfg = tcfg.EngineConfig(
        num_cameras=2, image_width=256, image_height=192,
        solver=tcfg.SolverConfig(num_replicas=3, max_vertices=37,
                                 solutions_per_replica=4,
                                 max_iterations=60))
    sc = make_scenario(num_cameras=2, num_frames=1, num_people=1,
                       image_size=(256, 192), arena=3000.0, seed=0)
    return Associator3D(cfg, sc.cameras, device="cpu")


def test_frame_program_draws_into_its_fields():
    """The draw part, run eagerly on the CPU from the key buffer, writes
    the program's static fields in place: equal to threefry_fields of that
    key, and the part's output is those very tensors."""
    assoc = _assoc()
    prog = assoc._program(8, 8, 60)
    cfg = assoc._solver_cfg_fused
    r, v = cfg.num_replicas, cfg.max_vertices
    ip = iters_padded(cfg, 60)
    ptrs = [t.data_ptr() for t in prog.fields]
    for seed in (1, 2):
        _, key = _key(seed)
        prog.key.copy_(key)
        out = prog.draw()
        assert all(o is f for o, f in zip(out, prog.fields))
        assert [t.data_ptr() for t in prog.fields] == ptrs
        _same_bits(prog.fields, threefry_fields(key, r, v, ip, "cpu"))


def test_rejects_bad_keys_and_buffers():
    _, key = _key(0)
    r, v, ip = 2, 5, 3
    good = [torch.zeros(s) for s in tk.field_shapes(r, v, ip)]
    with pytest.raises(ValueError, match="key"):
        tk.threefry_fields(key.to(torch.int32), r, v, ip)
    with pytest.raises(ValueError, match="key"):
        tk.threefry_fields(key[None], r, v, ip)
    with pytest.raises(ValueError, match="key"):
        tk.threefry_fields(key.tolist(), r, v, ip)
    with pytest.raises(ValueError, match=">= 0"):
        tk.threefry_fields(key, -1, v, ip)
    with pytest.raises(ValueError, match="5 tensors"):
        tk.threefry_fields(key, r, v, ip, good[:4])
    for i, bad in ((0, good[0].double()), (2, torch.zeros(ip, r, v + 1)),
                   (3, torch.zeros(r, ip).T)):
        out = list(good)
        out[i] = bad
        with pytest.raises(ValueError, match=tk.FIELDS[i]):
            tk.threefry_fields(key, r, v, ip, out)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.threefry_fields(key.to("meta"), r, v, ip)


def test_empty_draws():
    _, key = _key(0)
    for r, v, ip in ((0, 5, 3), (2, 0, 3), (2, 5, 0)):
        got = tk.threefry_fields(key, r, v, ip)
        assert [tuple(g.shape) for g in got] == list(
            tk.field_shapes(r, v, ip))
        if r:              # the plain version draws the non-empty fields
            _same_bits(got, tk.threefry_fields_reference(key, r, v, ip))


def test_field_work_hand_count():
    work = tk.field_work(2, 3, 4)
    # uniforms: noise 2 x 3, u_dir and u_ten 4 x 2 each; gumbels 2 x 4x2x3;
    # the built kernel's SASS: 130.375 (63.25 ALU) instructions a gumbel,
    # 79.125 (49.25) a uniform
    assert work["numbers"] == 22 + 48
    assert work["bytes"] == 4 * 70 + 16
    assert work["instructions"] == 130.375 * 48 + 79.125 * 22
    assert work["alu_instructions"] == 63.25 * 48 + 49.25 * 22
    warp_clocks = 132 * 1.98e9 * 32
    assert work["issue_s"] == pytest.approx(
        (130.375 * 48 + 79.125 * 22) / (4 * warp_clocks))
    assert work["alu_s"] == pytest.approx(
        (63.25 * 48 + 49.25 * 22) / (2 * warp_clocks))
    assert work["bytes_s"] == pytest.approx(296 / 3.35e12)
    # mostly uniforms: the integer ALU pipe bounds it
    assert work["bound_by"] == "operations"
    assert work["bound_s"] == work["alu_s"] > work["issue_s"]
    # the bench's draw [38, 1024, 150] is issue-bound: 45.61 us
    bench = tk.field_work(38, 1024, 150)
    assert bench["bound_by"] == "operations"
    assert bench["bound_s"] == bench["issue_s"] > bench["alu_s"] > \
        bench["bytes_s"]
    assert bench["bound_s"] == pytest.approx(45.61e-6, rel=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(38, 1024, 150)])
def test_cuda_kernel_equals_plain_version(cuda_device, shape):
    r, v, ip = shape
    _, key = _key(sum(shape))
    key = key.to(cuda_device)
    launches = tk.threefry_fields.launches
    got = threefry_fields(key, r, v, ip, cuda_device)
    assert tk.threefry_fields.launches == launches + 1
    _same_bits(got, tk.threefry_fields_reference(key, r, v, ip))
