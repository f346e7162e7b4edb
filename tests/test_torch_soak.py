"""The long-sequence stability soak (scripts/soak.py, tests/test_soak.py)
on the port: mcmtt_opticalflow_tpu_torch/soak.py.

- slow: the port's soak on the CPU at 300 frames and 15 people, with
  tests/test_soak.py's four assertions;
- fast: the JAX script's run_soak and the port's, both at 40 frames and
  8 people on the CPU, give the same population numbers and checks (at
  this length buffers are sampled once, at frame 0, so buf_mb_q2_med is
  NaN in both and buffers_flat False: what the script does at 40
  frames);
- fast: off the card the summary has the JAX script's keys and checks
  and no device keys;
- fast: the card's three checks (device_state) on made-up samples: flat
  memory and early captures pass; allocated or pinned bytes that grow,
  reserved bytes that rise after the half in a frame that captured
  nothing, and a bucket first met in the last quarter fail;
- fast: a download's arrays own their memory, so the row views of the 2D
  boxes that the associator's tracklets keep hold no download buffer
  (on the card the soak found them holding a pinned block a frame).

The port runs on the gather LK (MCMTT_LK_BACKEND=xla), as the JAX
engine's CPU run does.

Run the slow case explicitly:
    python -m pytest tests/test_torch_soak.py -m slow -q
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

torch.set_num_threads(2)

POPULATION = ("registry_q2_med", "registry_q4_med", "buf_mb_q2_med",
              "buf_mb_q4_med", "vis_map_max", "live_peak")
JAX_KEYS = {"frames", "people", "wall_s", "fps", "frame_ms_first50_med",
            "frame_ms_mid50_med", "frame_ms_last50_med", *POPULATION,
            "checks"}
JAX_CHECKS = {"fps_stable", "registry_flat", "buffers_flat",
              "vis_ids_bounded"}


def _port_soak(num_frames, num_people):
    from mcmtt_opticalflow_tpu_torch.soak import run_soak
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCMTT_LK_BACKEND", "xla")
        return run_soak(num_frames=num_frames, num_people=num_people,
                        verbose=False, device="cpu")


@pytest.fixture(scope="module")
def short_soaks():
    from soak import run_soak
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MCMTT_LK_BACKEND", raising=False)
        jax_out = run_soak(num_frames=40, num_people=8, verbose=False)
    return jax_out, _port_soak(40, 8)


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def test_short_soak_equals_the_jax_script(short_soaks):
    jax_out, port_out = short_soaks
    for key in POPULATION:
        assert _same(port_out[key], jax_out[key]), (key, port_out[key],
                                                    jax_out[key])
    assert port_out["checks"] == jax_out["checks"]
    assert math.isnan(port_out["buf_mb_q2_med"])
    assert port_out["live_peak"] > 0


def test_cpu_summary_has_no_device_keys(short_soaks):
    jax_out, port_out = short_soaks
    assert set(port_out) == set(jax_out) == JAX_KEYS
    assert set(port_out["checks"]) == JAX_CHECKS


def test_soak_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from mcmtt_opticalflow_tpu_torch import soak
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        soak.run_soak(num_frames=2, num_people=1, verbose=False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        soak.main(["2", "1", "--json"])


def _samples(allocated, pinned, frames=300, every=16):
    return [{"frame": t, "allocated_mib": allocated(t),
             "reserved_mib": 2048.0, "pinned_mib": pinned(t),
             "rss_mib": 900.0}
            for t in range(0, frames, every)]


def _bucket(frame):
    return {"bucket": [64, 512, 100], "frame": frame, "capture_s": 0.1}


@pytest.mark.parametrize("case", ["flat", "growing", "late_rise",
                                  "rise_at_capture", "late_capture",
                                  "pinned_growing"])
def test_device_checks(case):
    from mcmtt_opticalflow_tpu_torch.soak import device_state
    n, start = 300, 500.0
    allocated = {"growing": lambda t: start + 10.0 + t}.get(
        case, lambda t: start + 120.0 + (t % 3))
    # the parent's measured pinned growth: ~4.9 KB a frame from 0.4 MiB
    pinned = {"pinned_growing": lambda t: 0.4 + 0.0046 * t}.get(
        case, lambda t: 0.5 + 0.01 * (t % 2))
    reserved = [2 ** 31] * n
    buckets = [_bucket(0), _bucket(40)]
    if case in ("late_rise", "rise_at_capture"):
        reserved[200:] = [2 ** 31 + 2 ** 21] * (n - 200)
    if case == "rise_at_capture":
        buckets.append(_bucket(200))
    if case == "late_capture":
        buckets.append(_bucket(n - n // 4))
    keys, checks = device_state(start, _samples(allocated, pinned),
                                reserved, buckets, n)
    names = ("device_memory_flat", "captures_settle", "pinned_memory_flat")
    assert set(checks) == set(names)
    want = {"flat": (True, True, True), "growing": (False, True, True),
            "late_rise": (False, True, True),
            "rise_at_capture": (True, True, True),
            "late_capture": (True, False, True),
            "pinned_growing": (True, True, False)}[case]
    assert tuple(checks[k] for k in names) == want
    assert keys["reserved_rises_after_half"] == (
        [200] if case in ("late_rise", "rise_at_capture") else [])
    assert keys["allocated_mib_q2_med"] >= start


def test_downloads_own_their_memory():
    from mcmtt_opticalflow_tpu_torch.models.pipeline import _unpack2d
    from mcmtt_opticalflow_tpu_torch.utils.fetch import DeviceFetch
    pack = torch.arange(1, 37, dtype=torch.float32).reshape(1, 6, 6)
    fetch = DeviceFetch([pack])
    (host,) = fetch.get()
    _, boxes, _ = _unpack2d(host)
    for buffer in (fetch._host[0].numpy(), pack.numpy()):
        assert not np.shares_memory(host, buffer)
        assert not np.shares_memory(boxes, buffer)
    pack.zero_()
    assert boxes.min() > 0


@pytest.mark.slow
def test_long_sequence_stability():
    out = _port_soak(300, 15)
    assert out["checks"]["fps_stable"], out
    assert out["checks"]["registry_flat"], out
    assert out["checks"]["buffers_flat"], out
    assert out["checks"]["vis_ids_bounded"], out
