"""The port's bench entry point (mcmtt_opticalflow_tpu_torch/bench.py)
against the repository's bench.py: the same configuration, scene,
warm-up, windows and JSON keys (read from bench.py's source, which is
never run here), BENCH_ASSOC_OVERRIDES honoured, `--device cpu` running
on the CPU, and the card being the default (no card here: a named
error)."""

import ast
import io
import json
import os
import contextlib

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch import bench

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = ("EngineConfig", "Tracker2DConfig", "Associator3DConfig",
         "SolverConfig", "make_scenario")


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _call_kwargs(tree):
    """{callee: {keyword: literal}} for the calls in CALLS (literal values
    only; `**overrides` and names are skipped)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in CALLS:
            kw = {}
            for k in node.keywords:
                if k.arg is None:
                    continue
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    pass
            out[node.func.id] = kw
    return out


def test_config_and_scene_match_bench_py():
    ref = _call_kwargs(_tree(os.path.join(ROOT, "bench.py")))
    ours = _call_kwargs(_tree(bench.__file__))
    assert set(ref) == set(CALLS)
    for name in CALLS:
        assert ours[name] == ref[name], name


def _bench_py_json_keys():
    tree = _tree(os.path.join(ROOT, "bench.py"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "dumps" and node.args \
                and isinstance(node.args[0], ast.Dict):
            return [ast.literal_eval(k) for k in node.args[0].keys
                    if k is not None]
    raise AssertionError("bench.py prints no JSON dict")


def test_protocol_constants_match_bench_py():
    tree = _tree(os.path.join(ROOT, "bench.py"))
    consts = {n.targets[0].id: ast.literal_eval(n.value)
              for n in tree.body if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Name)}
    assert bench.WARMUP == consts["WARMUP"]
    src = open(os.path.join(ROOT, "bench.py")).read()
    assert "windows = (0, 3, 6)" in src and bench.WINDOWS == (0, 3, 6)
    assert "else 30" in src and bench.MEASURED == 30


def test_overrides_honoured(monkeypatch):
    monkeypatch.setenv("BENCH_ASSOC_OVERRIDES",
                       "max_time_jump=7, min_target_proximity=350.0")
    got = bench.assoc_overrides()
    assert got == {"max_time_jump": 7, "min_target_proximity": 350.0}
    cfg = bench.bench_config(**got)
    assert cfg.assoc3d.max_time_jump == 7
    assert cfg.assoc3d.min_target_proximity == 350.0
    assert cfg.assoc3d.k_best_size == 30


def test_cli_on_the_cpu(monkeypatch):
    """One measured frame (8 frames of the 8-frame scene) on the CPU's
    gather LK: one JSON line with bench.py's keys plus device and
    lk_route."""
    monkeypatch.setenv("MCMTT_LK_BACKEND", "xla")
    monkeypatch.delenv("BENCH_ASSOC_OVERRIDES", raising=False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        bench.main(["1", "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == _bench_py_json_keys()[:-1] + [
        "mota_w0", "mota_w3", "mota_w6", "stage_ms", "device", "lk_route"]
    assert rec["device"] == "cpu" and rec["lk_route"] == "gather"
    assert rec["frames"] == 1 and rec["value"] > 0
    assert all(np.isfinite(rec[f"mota_w{w}"]) for w in (0, 3, 6))
    assert "w0:" in err.getvalue() and "dominant stage" in err.getvalue()


def test_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main(["1"])
