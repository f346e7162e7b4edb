"""The port runs on the CUDA card unless the caller asks for the CPU:
its public constructors and its CLI raise without a card when no device
is named, and build on the CPU when asked for it."""

import os
import subprocess
import sys

import pytest
import torch

import mcmtt_opticalflow_tpu_torch as tpkg
from mcmtt_opticalflow_tpu_torch.config import (EngineConfig, SolverConfig,
                                                Tracker2DConfig)
from mcmtt_opticalflow_tpu_torch.data import make_scenario
from mcmtt_opticalflow_tpu_torch.models.associator3d import Associator3D
from mcmtt_opticalflow_tpu_torch.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu_torch.models.tracker2d import init_tracker2d_state
from mcmtt_opticalflow_tpu_torch.utils.device import default_device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(tpkg.__file__))
CFG = EngineConfig(
    num_cameras=2, image_width=256, image_height=192,
    tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                              max_features=16, lk_window=8,
                              lk_pyramid_levels=2, lk_iterations=4),
    solver=SolverConfig(num_replicas=2, max_vertices=32, max_iterations=20))


def _cameras():
    return make_scenario(num_cameras=2, num_frames=1, num_people=2,
                         image_size=(256, 192), arena=3000.0,
                         seed=2).cameras


_CONSTRUCTORS = {
    "TrackingEngine": lambda **kw: TrackingEngine(CFG, _cameras(), **kw),
    "Associator3D": lambda **kw: Associator3D(CFG, _cameras(), **kw),
    "init_tracker2d_state": lambda **kw: init_tracker2d_state(
        CFG.tracker2d, 192, 256, 2, **kw),
}


def _device_of(obj):
    return (obj.frames.device if hasattr(obj, "frames")
            else obj.cams.r11.device)


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_no_device_and_no_card_raises(name, monkeypatch):
    """Decided inside the test: with no card visible, the default device
    is not the CPU but an error that names the missing card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card") as err:
        _CONSTRUCTORS[name]()
    assert 'device="cpu"' in str(err.value)


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_cpu_when_asked(name):
    obj = _CONSTRUCTORS[name](device="cpu")
    assert _device_of(obj).type == "cpu"
    if hasattr(obj, "device"):
        assert obj.device == torch.device("cpu")


def test_default_device_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")


def test_cli_without_a_card_names_it():
    """`main.py` with no --device and no visible card exits non-zero and
    says how to ask for the CPU."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "mcmtt_opticalflow_tpu_torch.main",
         "--synthetic", "--cameras", "2", "--frames", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert "== K=" not in proc.stdout
