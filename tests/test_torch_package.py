"""Package-level checks of the port: it imports no jax, its carried
host modules have not drifted from the JAX package's, its config
dataclasses equal the JAX package's field by field, and its synthetic
scenes are identical to the JAX package's."""

import ast
import dataclasses
import difflib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mcmtt_opticalflow_tpu as jpkg
import mcmtt_opticalflow_tpu_torch as tpkg
from mcmtt_opticalflow_tpu import config as jcfg
from mcmtt_opticalflow_tpu.data import make_scenario as jax_make_scenario
from mcmtt_opticalflow_tpu_torch import config as tcfg
from mcmtt_opticalflow_tpu_torch.data import make_scenario

torch.set_num_threads(2)

JROOT = os.path.dirname(jpkg.__file__)
TROOT = os.path.dirname(tpkg.__file__)

# every module of the port: one run of the main path imports them all
_NO_JAX = r"""
import pkgutil, importlib, sys
import numpy as np
import torch
torch.set_num_threads(1)
import mcmtt_opticalflow_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
sc = make_scenario(num_cameras=2, num_frames=2, num_people=2,
                   image_size=(256, 192), arena=3000.0, seed=2)
cfg = EngineConfig(num_cameras=2, image_width=256, image_height=192,
    tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                              max_features=16, lk_window=8,
                              lk_pyramid_levels=2, lk_iterations=4),
    solver=SolverConfig(num_replicas=2, max_vertices=32, max_iterations=20))
eng = TrackingEngine(cfg, sc.cameras, device="cpu")
for t in range(2):
    eng.process_frame(np.stack(sc.frames(t)), sc.detections[t])
bad = sorted(m for m in sys.modules
             if m in ("jax", "mcmtt_opticalflow_tpu")
             or m.startswith(("jax.", "jaxlib", "mcmtt_opticalflow_tpu.")))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                          text=True, timeout=300, env=env,
                          cwd=os.path.dirname(TROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _body_without_imports(path):
    """Source lines of a module minus its import statements."""
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno - 1, node.end_lineno))
    return [l for i, l in enumerate(lines) if i not in drop]


# Carried modules whose body must differ from the JAX package's, and the
# only lines that may differ (JAX-only lines, port-only lines); everything
# else is compared as for the other carried modules.  main.py takes
# --device (the card unless asked for the CPU), gives it to its engines
# and reports it; snapshot.py moves the 2D state through
# convert.py and keeps the solver's PRNG key as a torch tensor (saved as
# the JAX package's two uint32 words).
_MUST_DIFFER = {
    "main.py": (
        ["        return TrackingEngine(cfg, sc.cameras)",
         "        return TrackingEngine(cfg, cams, pipelined=True, "
         "sidemaps=sidemaps)"],
        ["        return TrackingEngine(cfg, sc.cameras, device=args.device)",
         "        return TrackingEngine(cfg, cams, pipelined=True, "
         "sidemaps=sidemaps,",
         "                              device=args.device)",
         '    ap.add_argument("--device", choices=("cuda", "cpu"), '
         'default="cuda",',
         '                    help="run on the CUDA card (default) or the '
         'CPU")',
         '    if args.device == "cuda":',
         "        try:",
         "            args.device = default_device()",
         "        except RuntimeError as e:",
         '            raise SystemExit(f"error: {e}")',
         '    print(f"device: {args.device}", file=sys.stderr)']),
    "checkpoint/snapshot.py": (
        ["", "", "def _to_numpy(tree):",
         "    return jax.tree.map(lambda x: np.asarray(x), tree)",
         '        "state2d": _to_numpy(engine.state2d),',
         '            "solver_key": np.asarray(a.solver_key),',
         "",
         "    # tree-map preserves the NamedTuple structure incl. nested "
         "tuples",
         "    # (frames_lo pyramid rings)",
         "    engine.state2d = jax.tree.map(jnp.asarray, state_np)",
         '    a.solver_key = jnp.asarray(s["solver_key"])'],
        ["",
         "Port of mcmtt_opticalflow_tpu/checkpoint/snapshot.py with the "
         "same payload",
         "layout, except that the 2D state goes through "
         "convert.tracker2d_state_to_numpy",
         "and comes back onto the engine's device.  The solver key is saved "
         "as the",
         "JAX package saves it (two uint32 words), so a resumed run draws "
         "the same",
         "random fields as an uninterrupted one.",
         "",
         '        "state2d": tracker2d_state_to_numpy(engine.state2d),',
         '            "solver_key": a.solver_key.cpu().numpy()'
         '.astype(np.uint32),',
         "    engine.state2d = tracker2d_state_from_numpy(state_np, "
         "engine.device)",
         "    a.solver_key = torch.from_numpy(",
         '        np.asarray(s["solver_key"]).astype(np.int64))']),
}


@pytest.mark.parametrize("rel", ["config.py", "geometry/tsai_np.py",
                                 "models/trees.py", "eval/clearmot.py",
                                 "data/images.py", "data/pets.py",
                                 "eval/experiment.py", "main.py",
                                 "checkpoint/snapshot.py",
                                 "utils/logging.py", "utils/colors.py",
                                 "utils/math.py", "utils/dumps.py",
                                 "viz/overlay.py", "viz/video.py"])
def test_carried_module_has_not_drifted(rel):
    """Bodies equal without imports, the package's own name read as the
    JAX package's (a usage line names the module it is in)."""
    ours = [l.replace(tpkg.__name__, jpkg.__name__)
            for l in _body_without_imports(os.path.join(TROOT, rel))]
    ref = _body_without_imports(os.path.join(JROOT, rel))
    ref_only, ours_only = [], []
    ops = difflib.SequenceMatcher(a=ref, b=ours, autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in ops:
        ref_only += ref[i1:i2] if tag != "equal" else []
        ours_only += ours[j1:j2] if tag != "equal" else []
    assert (ref_only, ours_only) == _MUST_DIFFER.get(rel, ([], []))


@pytest.mark.parametrize("mod,name", [
    ("utils.timing", "StageTimer"),
    ("ops.histogram", "host_rgb_histogram"),
    ("ops.hungarian", "hungarian_host"),
    ("geometry.sidemaps", "read_sidemap_txt"),
    ("geometry.sidemaps", "write_sidemap_txt"),
    ("geometry.sidemaps", "load_or_compute_sidemaps")])
def test_carried_definition_has_not_drifted(mod, name):
    import importlib
    ours = getattr(importlib.import_module(f"{tpkg.__name__}.{mod}"), name)
    ref = getattr(importlib.import_module(f"{jpkg.__name__}.{mod}"), name)
    assert inspect.getsource(ours) == inspect.getsource(ref)


def test_collect_k_best_has_not_drifted():
    """The host K-best is carried over but reads the result tensors
    through .cpu().numpy() (np.asarray cannot read a CUDA tensor): those
    two lines are the only difference."""
    from mcmtt_opticalflow_tpu.models import mwcp as jmod
    from mcmtt_opticalflow_tpu_torch.models import mwcp as tmod
    ref = inspect.getsource(jmod.collect_k_best).splitlines()
    ours = inspect.getsource(tmod.collect_k_best).splitlines()
    ref_only = [l for l in ref if l not in ours]
    ours_only = [l for l in ours if l not in ref]
    assert (ref_only, ours_only) == (
        ["    masks = np.asarray(result.sol_masks).reshape(-1, "
         "result.sol_masks.shape[-1])",
         "    scores = np.asarray(result.sol_scores).reshape(-1)"],
        ["    masks = result.sol_masks.cpu().numpy().reshape(-1, "
         "result.sol_masks.shape[-1])",
         "    scores = result.sol_scores.cpu().numpy().reshape(-1)"])
    assert [l for l in ref if l in ours] == [l for l in ours if l in ref]


# The definitions of models/associator3d.py that the port carries from
# the JAX file unchanged (an `ast` comparison of the two files: 49 of
# them, 1897 lines).  Deliberately different, and not checked: the device
# boundary the port rewrote for PyTorch and the mesh — `incompat_rows`,
# `_compat_from`, `compat_matrix`, `FrameProgram`, and of `Associator3D`
# `__init__`, `_build_device_fns`, `_rescore_and_solve`, `_score_graph`,
# `_score_rows`, `_score_joined`, `_pack_k_best`, `_dev`, `_splits`,
# `_cams`, `_on_rows`, `_rescore_tails`, `_form_hypotheses`, `_program`,
# `_graph_pool`, `precompile`, `_unpack_solve`, `_collect_solve` — and
# `_update_tracklets`, which differs by its two imports only
# (test_update_tracklets_has_not_drifted).
_CARRIED_ASSOCIATOR = [
    "_bucket", "_link_prob_batch", "Hypothesis", "Track3DResult",
    "Associator3D._sensitivity_at",
    "Associator3D._distance_from_boundary_batch",
    "Associator3D._distance_from_boundary", "Associator3D._enter_cost",
    "Associator3D._exit_cost", "Associator3D._enter_cost_batch",
    "Associator3D._exit_cost_batch", "Associator3D._visible_anywhere_batch",
    "Associator3D._visible_anywhere", "Associator3D._reconstruct",
    "Associator3D._finish_reconstruction",
    "Associator3D._visible_anywhere_cam", "Associator3D._tracklet_tables",
    "Associator3D._recon_cost_batch", "Associator3D._reconstruct_batch",
    "Associator3D.step", "Associator3D.step_begin", "Associator3D.step_finish",
    "Associator3D._gc_roots", "Associator3D.collect",
    "Associator3D._update_tracks_prep", "Associator3D._update_tracks",
    "Associator3D._append_position", "Associator3D._pack_windows",
    "Associator3D._apply_window_scores", "Associator3D._generate_combinations",
    "Associator3D._combo_tables", "Associator3D._generate_combinations_batch",
    "Associator3D._generate_seeds", "Associator3D._enumerate_seeds",
    "Associator3D._materialize_seeds", "Associator3D._admit_seeds",
    "Associator3D._new_track_from_seed", "Associator3D._branch_tracks",
    "Associator3D._spawn_spatial_batch", "Associator3D._make_temporal_branch",
    "Associator3D._clone_track", "Associator3D._apply_history_batch",
    "Associator3D._track_share_codes", "Associator3D._shared_matrix",
    "Associator3D._finish_rescore", "Associator3D._prune",
    "Associator3D._package_result", "Associator3D.result_at",
    "Associator3D._package_result_at"]


def _definition(module, name):
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
    return inspect.getsource(obj)


@pytest.mark.parametrize("name", _CARRIED_ASSOCIATOR)
def test_carried_associator_definition_has_not_drifted(name):
    from mcmtt_opticalflow_tpu.models import associator3d as jmod
    from mcmtt_opticalflow_tpu_torch.models import associator3d as tmod
    assert _definition(tmod, name) == _definition(jmod, name)


def test_update_tracklets_has_not_drifted():
    """The tracklet ingest is carried over but imports its two host
    helpers from the port: those import lines are the only difference."""
    from mcmtt_opticalflow_tpu.models import associator3d as jmod
    from mcmtt_opticalflow_tpu_torch.models import associator3d as tmod
    name = "Associator3D._update_tracklets"
    ref = _definition(jmod, name).splitlines()
    ours = _definition(tmod, name).splitlines()
    ref_only = [l for l in ref if l not in ours]
    ours_only = [l for l in ours if l not in ref]
    assert (ref_only, ours_only) == (
        ["        from mcmtt_opticalflow_tpu.ops.histogram import "
         "host_rgb_histogram",
         "        from mcmtt_opticalflow_tpu.geometry.tsai_np import ("],
        ["        from mcmtt_opticalflow_tpu_torch.ops.histogram import \\",
         "            host_rgb_histogram",
         "        from mcmtt_opticalflow_tpu_torch.geometry.tsai_np import ("])
    assert [l for l in ref if l in ours] == [l for l in ours if l in ref]


def _exported_names(init_path):
    """Names an __init__.py imports from its package's modules."""
    with open(init_path) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names]


@pytest.mark.parametrize("sub", ["ops", "models", "geometry", "viz",
                                 "parallel", "utils"])
def test_subpackage_exports_match(sub):
    """Every name the JAX package's sub-package exports imports from the
    port's counterpart, and the port exports no other."""
    import importlib
    ref = _exported_names(os.path.join(JROOT, sub, "__init__.py"))
    assert ref
    mod = importlib.import_module(f"{tpkg.__name__}.{sub}")
    missing = [n for n in ref if not hasattr(mod, n)]
    assert not missing, f"{sub}: {missing}"
    assert _exported_names(os.path.join(TROOT, sub, "__init__.py")) == ref


# JAX modules whose counterpart has another path or other names:
# {JAX path: (port path, {JAX name: port name})}.  The Pallas kernel's
# module becomes the CUDA kernel's wrapper (ops/csrc/lk_level.cu), whose
# one entry point takes both kernel bodies as `variant`.  The TPU-only
# machinery that is not ported (ROADMAP.md, "Not to port") has no public
# top-level name, so it needs no entry.
_COUNTERPART = {
    "ops/lk_pallas.py": ("ops/lk_kernel.py",
                         {"lk_level_pallas": "lk_level"}),
}


def _jax_modules():
    return sorted(os.path.relpath(os.path.join(d, f), JROOT)
                  for d, _, files in os.walk(JROOT) for f in files
                  if f.endswith(".py"))


def _public_definitions(path):
    """Names of the public top-level functions and classes of a module."""
    with open(path) as f:
        body = ast.parse(f.read()).body
    return [n.name for n in body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_module_has_its_counterpart(rel):
    """The port has a module at the same relative path (or the one named
    in _COUNTERPART), and it defines or imports every public top-level
    def / class name of the JAX module."""
    import importlib
    port_rel, renamed = _COUNTERPART.get(rel, (rel, {}))
    assert os.path.exists(os.path.join(TROOT, port_rel)), port_rel
    mod = port_rel[:-len(".py")].replace(os.sep, ".")
    mod = mod[:-len(".__init__")] if mod.endswith(".__init__") else mod
    mod = importlib.import_module(
        tpkg.__name__ + ("" if mod == "__init__" else f".{mod}"))
    names = _public_definitions(os.path.join(JROOT, rel))
    missing = [n for n in names if not hasattr(mod, renamed.get(n, n))]
    assert not missing, f"{port_rel}: {missing}"


@pytest.mark.parametrize("cls", ["Tracker2DConfig", "Associator3DConfig",
                                 "SolverConfig", "EvalConfig",
                                 "EngineConfig"])
def test_config_fields_equal(cls):
    ours, ref = getattr(tcfg, cls), getattr(jcfg, cls)
    fo = [(f.name, f.type) for f in dataclasses.fields(ours)]
    fr = [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert fo == fr
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())


def test_make_scenario_identical():
    kw = dict(num_cameras=3, num_frames=4, num_people=5,
              image_size=(256, 192), arena=4000.0, noise_px=1.0,
              fp_rate=0.3, fn_rate=0.1, enter_exit=True, seed=7)
    ours, ref = make_scenario(**kw), jax_make_scenario(**kw)
    np.testing.assert_array_equal(ours.gt_xy, ref.gt_xy)
    np.testing.assert_array_equal(ours.heights, ref.heights)
    for t in range(kw["num_frames"]):
        for a, b in zip(ours.detections[t], ref.detections[t]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.frames(t), ref.frames(t)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.cameras, ref.cameras):
        for f in b._fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
