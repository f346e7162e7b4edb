"""The port's CLI, `python -m mcmtt_opticalflow_tpu_torch.main`, run as a
user runs it on the CPU (`--device cpu`): the synthetic demo, a
reference-layout dataset at the default EngineConfig, and the usage
error.  Each run must import no jax (checked from `python -X
importtime`)."""

import math
import os
import subprocess
import sys

import numpy as np

import mcmtt_opticalflow_tpu_torch as tpkg
from mcmtt_opticalflow_tpu_torch.data import (make_scenario,
                                              write_detection_file,
                                              write_ground_truth, write_image)
from mcmtt_opticalflow_tpu_torch.data.pets import write_tsai_xml

REPO = os.path.dirname(os.path.dirname(tpkg.__file__))


def _run_cli(args):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run([sys.executable, "-X", "importtime", "-m",
                           "mcmtt_opticalflow_tpu_torch.main", *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def _imported(stderr):
    """Module names from `python -X importtime`'s stderr."""
    return {ln.rsplit("|", 1)[1].strip() for ln in stderr.splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2}


def _assert_ran_without_jax(proc):
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "device: cpu" in proc.stderr
    mods = _imported(proc.stderr)
    assert "mcmtt_opticalflow_tpu_torch.models.pipeline" in mods
    bad = sorted(m for m in mods
                 if m.split(".")[0] in ("jax", "jaxlib",
                                        "mcmtt_opticalflow_tpu"))
    assert not bad, bad


def test_cli_synthetic_on_cpu_without_jax():
    proc = _run_cli(["--synthetic", "--cameras", "2", "--frames", "4",
                     "--device", "cpu"])
    _assert_ran_without_jax(proc)
    assert "== K=10 repeat=0" in proc.stdout
    assert proc.stdout.count("window=") == 3


def test_cli_dataset_on_cpu_without_jax(tmp_path):
    """Three frames of two cameras in the reference's layout (.ppm
    frames), run by `main.py <parameters.txt>` at the default
    EngineConfig: the 11-window table is printed for K=10."""
    w, h, cam_ids, n = 256, 192, (1, 5), 3
    sc = make_scenario(num_cameras=2, num_frames=n, num_people=3,
                       image_size=(w, h), arena=4000.0, seed=13)
    root = str(tmp_path)
    for ci, cid in enumerate(cam_ids):
        cam = sc.cameras[ci]
        write_tsai_xml(os.path.join(root, "calibrationInfos",
                                    f"View_{cid:03d}.xml"), cam,
                       rx=math.atan2(float(cam.r32), float(cam.r33)),
                       ry=math.asin(-float(cam.r31)),
                       rz=math.atan2(float(cam.r21), float(cam.r11)))
        for t in range(n):
            write_detection_file(
                os.path.join(root, f"View_{cid:03d}", "detectionResult",
                             f"frame_{t:04d}.txt"), sc.detections[t][ci])
            rgb = (np.clip(sc.frames(t)[ci], 0, 1) * 255 + 0.5).astype(
                np.uint8)
            write_image(os.path.join(root, f"View_{cid:03d}",
                                     f"frame_{t:04d}.ppm"), rgb)
    write_ground_truth(os.path.join(root, "groundTruth", "cropped.txt"),
                       *sc.gt_matrices())
    params = os.path.join(root, "parameters.txt")
    with open(params, "w") as f:
        f.write(f"DATASET_PATH={root}\nCAM_IDS=1,5\nSTART_FRAME_IDX=0\n"
                f"END_FRAME_IDX={n - 1}\nSIZE_OF_KS=10\nNUM_EXPERIMENTS=1\n"
                "CROP_ZONE=-10000,-10000,10000,10000\n")
    proc = _run_cli([params, "--device", "cpu"])
    _assert_ran_without_jax(proc)
    assert "feeding flat gray" not in proc.stderr
    assert "== K=10 repeat=0" in proc.stdout
    assert proc.stdout.count("window=") == 11


def test_cli_missing_parameter_file_is_a_usage_error(tmp_path):
    proc = _run_cli([str(tmp_path / "nope.txt"), "--device", "cpu"])
    assert proc.returncode == 2
    assert "parameter file not found" in proc.stderr
