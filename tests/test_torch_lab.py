"""The JAX package's lab tools (scripts/density_lab.py,
scripts/tracklet_audit.py, scripts/microbench2d.py) on the port
(mcmtt_opticalflow_tpu_torch/density_lab.py, tracklet_audit.py,
microbench2d.py), held to the JAX scripts on the CPU.

Each JAX script runs as a subprocess (JAX_PLATFORMS=cpu) while the
port's module runs in process through its main(argv) with --device cpu.  The port's
runs take the gather LK (MCMTT_LK_BACKEND=xla), as the JAX engine's CPU
run does:

- density_lab --assoc-only --frames 12 --debug, and the full pipeline
  --frames 6 --people 10 --debug: the JSON line equal but for
  `elapsed_s`, and every stderr line of the lab's own (the per-frame
  counters and audit, the windows' CLEAR-MOT summaries) before the
  stage timer's summary equal line for line.  Where two lines differ
  only in numbers printed to one decimal (a track's cost terms and
  average camera count), each such number may differ by
  ONE_DECIMAL_TOL: one unit of the last printed digit, as sums in
  another order may round across it;
- tracklet_audit --frames 6 --people 10: the JSON line equal;
- each entry point exits with its error without a card unless given
  --device cpu, and run_lab / run_audit raise;
- --profile writes a file that pstats loads;
- microbench2d's two LK routes on 64 of its points a camera: the gather
  route equal to the kernel route under MCMTT_LK_BACKEND=xla bit for
  bit, within TRACKED_ATOL of the kernel's plain version, and the JAX
  script's LK (its vmapped lk_track_pyramid on the gather path) within
  TRACKED_ATOL in position and 1e-4 in residual, status equal;
- lab_reference.json (tests/lab_reference.py) holds every run with its
  command, its --assoc-only port entry equals the JAX script's, and
  (slow) the `jax` entries equal fresh runs of the JAX scripts.

Run the slow case explicitly:
    python -m pytest tests/test_torch_lab.py -m slow -q
"""

import contextlib
import io
import json
import os
import pstats
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu_torch import density_lab, microbench2d, \
    tracklet_audit

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_DECIMAL_TOL = 0.1
# px: float32 sums in another order, over two levels and 8 iterations
# (the gather paths part by up to ~1.3e-4 px at ~400 px)
TRACKED_ATOL = 1e-3
ASSOC_ARGS = ["--assoc-only", "--frames", "12", "--debug"]
FULL_ARGS = ["--frames", "6", "--people", "10", "--debug"]
AUDIT_ARGS = ["--frames", "6", "--people", "10"]
# the lab's own stderr lines: per-frame counters, audit lines, summaries
LAB_LINE = re.compile(r"^(f\d{3} \{|      \S|w\d+: MOTA=)")
TIMER_LINE = re.compile(r"total=\s*[\d.]+s\s+mean=")
ONE_DECIMAL = re.compile(r"-?\d+\.\d(?!\d)")


def _port_main(mod, args):
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            mod.main([*args, "--device", "cpu"])
    return out.getvalue(), err.getvalue()


def _both(script, mod, args, port_args=()):
    """The JAX script (a subprocess, started first) and the port's module
    (in this process, meanwhile) on the same arguments: ((JAX stdout,
    stderr), (port stdout, stderr))."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("MCMTT_LK_BACKEND", None)
    proc = subprocess.Popen([sys.executable,
                             os.path.join(ROOT, "scripts", script), *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = _port_main(mod, [*args, *port_args])
        jax_out, jax_err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, jax_err[-4000:]
    return (jax_out, jax_err), port


def _json_line(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def _lab_lines(stderr):
    lines = []
    for line in stderr.splitlines():
        if TIMER_LINE.search(line):
            break
        if LAB_LINE.match(line):
            lines.append(line)
    return lines


def _same_line(a, b):
    if a == b:
        return True
    if ONE_DECIMAL.sub("#", a) != ONE_DECIMAL.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= ONE_DECIMAL_TOL + 1e-9
               for x, y in zip(ONE_DECIMAL.findall(a),
                               ONE_DECIMAL.findall(b)))


@pytest.fixture(scope="module")
def assoc_only(tmp_path_factory):
    """(JAX stdout, stderr), (port stdout, stderr), the port's profile."""
    prof = str(tmp_path_factory.mktemp("lab") / "lab.prof")
    return (*_both("density_lab.py", density_lab, ASSOC_ARGS,
                   ["--profile", prof]), prof)


@pytest.fixture(scope="module")
def full():
    return _both("density_lab.py", density_lab, FULL_ARGS)


@pytest.fixture(params=["assoc_only", "full"])
def lab_runs(request):
    """(mode, JAX (stdout, stderr), port (stdout, stderr))."""
    return (request.param, *request.getfixturevalue(request.param)[:2])


def test_density_lab_json_equals_the_jax_script(lab_runs):
    mode, (jax_out, _), (port_out, _) = lab_runs
    jax_rec, port_rec = _json_line(jax_out), _json_line(port_out)
    jax_rec.pop("elapsed_s")
    port_rec.pop("elapsed_s")
    assert port_rec == jax_rec
    assert port_rec["tracks_peak"] > 0


def test_density_lab_debug_lines_equal_the_jax_script(lab_runs):
    mode, (_, jax_err), (_, port_err) = lab_runs
    jax_lines, port_lines = _lab_lines(jax_err), _lab_lines(port_err)
    frames = {"assoc_only": 12, "full": 6}[mode]
    assert sum(l.startswith("f") for l in port_lines) == frames
    assert sum(l.startswith("w") for l in port_lines) == 3
    assert len(port_lines) == len(jax_lines), (port_lines, jax_lines)
    for p, j in zip(port_lines, jax_lines):
        assert _same_line(p, j), (p, j)
    # the stage timer's summary follows the lab's lines in both
    assert TIMER_LINE.search(port_err) and TIMER_LINE.search(jax_err)


def test_tracklet_audit_equals_the_jax_script():
    (jax_out, _), (port_out, _) = _both("tracklet_audit.py",
                                        tracklet_audit, AUDIT_ARGS)
    port_rec = _json_line(port_out)
    assert port_rec == _json_line(jax_out)
    assert port_rec["num_tracklets"] > 0


def test_profile_writes_pstats(assoc_only):
    stats = pstats.Stats(assoc_only[2])
    assert stats.total_calls > 0
    assert any(fn[2] == "step" and fn[0].endswith("associator3d.py")
               for fn in stats.stats)


@pytest.mark.parametrize("mod,args", [
    (density_lab, ["--frames", "2", "--people", "1"]),
    (tracklet_audit, ["--frames", "2", "--people", "1"]),
    (microbench2d, []),
], ids=["density_lab", "tracklet_audit", "microbench2d"])
def test_entry_point_needs_the_card_unless_asked_for_the_cpu(
        monkeypatch, mod, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        mod.main(args)
    run = {density_lab: lambda: density_lab.run_lab(frames=2, people=1),
           tracklet_audit: lambda: tracklet_audit.run_audit(2, 1)}.get(mod)
    if run is not None:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run()


@pytest.fixture(scope="module")
def lk_inputs():
    x = microbench2d.inputs("cpu")
    pts = x["backward"][:, :64].contiguous()
    return x["prev"], x["next"], pts, torch.ones((4, 64), dtype=torch.bool)


def test_microbench_gather_route_equals_the_switched_kernel_route(
        lk_inputs):
    gather = microbench2d.gather_track(*lk_inputs)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCMTT_LK_BACKEND", raising=False)
        plain = microbench2d.kernel_track(*lk_inputs)
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        switched = microbench2d.kernel_track(*lk_inputs)
    for g, s in zip(gather, switched):
        assert torch.equal(g, s)
    assert torch.equal(gather[1], plain[1])
    both = gather[1] & plain[1]
    assert both.sum() > 100
    assert (gather[0] - plain[0])[both].abs().max() <= TRACKED_ATOL


def test_microbench_lk_matches_the_jax_script(lk_inputs):
    import jax
    import jax.numpy as jnp
    import mcmtt_opticalflow_tpu.ops.lk as jlk
    prev, nxt, pts, act = (jnp.asarray(t.numpy()) for t in lk_inputs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        jlk._lk_level_cached.cache_clear()
        try:
            ref = jax.vmap(lambda p, q, x, a: jlk.lk_track_pyramid(
                p, q, x, levels=2, window=16, iterations=8, active=a))(
                    prev, nxt, pts, act)
            ref = [np.asarray(r) for r in ref]
        finally:
            jlk._lk_level_cached.cache_clear()
    got = [t.numpy() for t in microbench2d.gather_track(*lk_inputs)]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=TRACKED_ATOL)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)


def test_microbench_bench_line(capsys):
    times = microbench2d.bench("x", lambda a: a + 1, torch.zeros(3), n=3)
    line = capsys.readouterr().out
    assert re.match(r"x +med= +[\d.]+ms min= +[\d.]+ms", line), line
    assert 0 <= times[1] <= times[0]


def _reference():
    with open(density_lab.REFERENCE) as f:
        return json.load(f)


def test_reference_holds_every_run():
    import lab_reference
    ref = _reference()
    for tool, entry in lab_reference.RUNS.values():
        rec = ref[tool][entry]
        assert rec["command"] == lab_reference.command(tool, entry)
        assert "elapsed_s" not in rec
    assert ref["density_lab_assoc_only"]["port"] == {
        **ref["density_lab_assoc_only"]["jax"],
        "command": ref["density_lab_assoc_only"]["port"]["command"]}


@pytest.mark.slow
@pytest.mark.parametrize("tool", ["density_lab", "density_lab_assoc_only",
                                  "tracklet_audit"])
def test_reference_jax_entries_equal_fresh_runs(tool):
    import lab_reference
    rec = dict(_reference()[tool]["jax"])
    rec.pop("command")
    assert lab_reference.run_jax_script(tool) == rec
