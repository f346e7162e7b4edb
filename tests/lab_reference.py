"""Build mcmtt_opticalflow_tpu_torch/lab_reference.json: the JAX
package's lab scripts (scripts/density_lab.py, scripts/tracklet_audit.py)
and the port's modules (density_lab.py, tracklet_audit.py) at each
tool's defaults, run on the CPU.

    JAX_PLATFORMS=cpu python tests/lab_reference.py \
        {lab_jax,lab_jax_pallas,lab_plain,assoc_jax,assoc_port,
         audit_jax,audit_jax_pallas,audit_plain,all}

  density_lab (the full pipeline, 35 frames, 22 people, V=512, seed 0,
  64 features a box):
    jax         the JAX script as it is (on the CPU its LK is the gather
                path);
    jax_pallas  the JAX script run in process (runpy) on its Pallas LK
                kernel in interpret mode: MCMTT_LK_BACKEND=pallas and
                tests/torch_parity.py::pallas_interpret's patch (nothing
                in the JAX package changes);
    plain       the port on the CPU with the LK kernel's plain PyTorch
                version, the arithmetic of the CUDA kernel the card runs;
  density_lab_assoc_only (--assoc-only at the same defaults; no LK):
    jax, port;
  tracklet_audit (35 frames, 22 people): jax, jax_pallas, plain.

Each entry is the tool's JSON line (density_lab's without `elapsed_s`)
with the command that made it; each run replaces its entry in the file.
chip_smoke.py's lab phase holds the card's runs against the file, and
tests/test_torch_lab.py reruns the `jax` entries (slow)."""

from __future__ import annotations

import argparse
import json
import os
import runpy
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "mcmtt_opticalflow_tpu_torch", "lab_reference.json")
SCRIPTS = {"density_lab": "scripts/density_lab.py",
           "density_lab_assoc_only": "scripts/density_lab.py",
           "tracklet_audit": "scripts/tracklet_audit.py"}
ARGS = {"density_lab": [], "density_lab_assoc_only": ["--assoc-only"],
        "tracklet_audit": []}
# run name -> (tool, entry)
RUNS = {"lab_jax": ("density_lab", "jax"),
        "lab_jax_pallas": ("density_lab", "jax_pallas"),
        "lab_plain": ("density_lab", "plain"),
        "assoc_jax": ("density_lab_assoc_only", "jax"),
        "assoc_port": ("density_lab_assoc_only", "port"),
        "audit_jax": ("tracklet_audit", "jax"),
        "audit_jax_pallas": ("tracklet_audit", "jax_pallas"),
        "audit_plain": ("tracklet_audit", "plain")}


def command(tool: str, entry: str) -> str:
    line = " ".join(["JAX_PLATFORMS=cpu python", SCRIPTS[tool],
                     *ARGS[tool]])
    if entry == "jax_pallas":
        return ("MCMTT_LK_BACKEND=pallas, lk_level_pallas(interpret=True): "
                + line + " (in process)")
    if entry in ("plain", "port"):
        module = "density_lab" if tool.startswith("density") else tool
        return (f"MCMTT_LK_BACKEND unset: python -m mcmtt_opticalflow_tpu_"
                f"torch.{module} {' '.join(ARGS[tool])} --device cpu").replace(
                    "  ", " ")
    return line


def _record(tool: str, line: str) -> dict:
    rec = json.loads(line)
    if tool.startswith("density"):
        rec.pop("elapsed_s")
    return rec


def run_jax_script(tool: str, extra=()) -> dict:
    """The JAX script as it is, in a subprocess on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("MCMTT_LK_BACKEND", None)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, SCRIPTS[tool]), *ARGS[tool],
         *extra], cwd=ROOT, env=env, check=True, capture_output=True,
        text=True)
    return _record(tool, out.stdout.strip().splitlines()[-1])


def run_jax_pallas(tool: str) -> dict:
    """The JAX script in this process, its LK on the Pallas kernel in
    interpret mode."""
    import contextlib
    import io
    from tests.torch_parity import pallas_interpret
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = [SCRIPTS[tool], *ARGS[tool]]
    try:
        with pallas_interpret(), contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, SCRIPTS[tool]),
                           run_name="__main__")
    finally:
        sys.argv = argv
    return _record(tool, buf.getvalue().strip().splitlines()[-1])


def run_port(tool: str) -> dict:
    """The port's module on the CPU, the LK kernel's plain version."""
    import io
    os.environ.pop("MCMTT_LK_BACKEND", None)
    if tool == "tracklet_audit":
        from mcmtt_opticalflow_tpu_torch.tracklet_audit import run_audit
        return run_audit(device="cpu")[0]
    from mcmtt_opticalflow_tpu_torch.density_lab import run_lab
    run = run_lab(assoc_only=tool == "density_lab_assoc_only",
                  device="cpu", out=io.StringIO())
    return _record(tool, json.dumps(run.record))


def build(name: str) -> tuple:
    tool, entry = RUNS[name]
    t0 = time.perf_counter()
    rec = {"jax": run_jax_script, "jax_pallas": run_jax_pallas}.get(
        entry, run_port)(tool)
    print(f"{name}: {json.dumps(rec)} ({time.perf_counter() - t0:.0f} s)",
          file=sys.stderr)
    return tool, entry, {"command": command(tool, entry), **rec}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", choices=(*RUNS, "all"))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    for name in (tuple(RUNS) if args.run == "all" else (args.run,)):
        tool, entry, rec = build(name)
        data = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                data = json.load(f)
        data.setdefault(tool, {})[entry] = rec
        with open(args.out, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
