"""The port's dataset entry point against the JAX package: reader/writer
round trips across the two packages (a file one writes, the other reads),
side-maps loaded or computed, and a reference-layout dataset run
through `k_sweep` by both packages with their own readers."""

import importlib
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmtt_opticalflow_tpu import data as jdata
from mcmtt_opticalflow_tpu.data import pets as jpets
from mcmtt_opticalflow_tpu.geometry import sidemaps as jsidemaps
from mcmtt_opticalflow_tpu.geometry.tsai import TsaiCamera as JaxCamera
from mcmtt_opticalflow_tpu_torch import data as tdata
from mcmtt_opticalflow_tpu_torch.data import pets as tpets
from mcmtt_opticalflow_tpu_torch.geometry import sidemaps as tsidemaps
from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera
from torch_parity import JaxFieldSource, pallas_interpret

torch.set_num_threads(2)

W, H = 256, 192
CAM_IDS = [1, 5]
ZONE = (-10000.0, -10000.0, 10000.0, 10000.0)
NUM_FRAMES = 8
# MOTP is 1 - (mean matched distance) / (1000 mm margin); the two packages'
# 3D points agree within 1 mm (float32 sums in another order,
# tests/test_torch_pipeline.py), so MOTP agrees within 1e-3.  The counts
# and MOTA are exact.
MOTP_ATOL = 1e-3
PACKAGES = {"jax": "mcmtt_opticalflow_tpu",
            "torch": "mcmtt_opticalflow_tpu_torch"}
# writer -> reader directions of every round trip
DIRECTIONS = [(jdata, tdata), (tdata, jdata)]
DIRECTION_IDS = ["jax-to-torch", "torch-to-jax"]

CAM_ARGS = dict(width=768, height=576, dpx=0.0083, dpy=0.0083, focal=8.0,
                kappa1=1e-6, cx=384.0, cy=288.0, sx=1.0, tx=100.0,
                ty=-11000.0, tz=8000.0, rx=2.4, ry=0.2, rz=0.3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_cameras_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f)


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=DIRECTION_IDS)
def test_detection_file_round_trip(tmp_path, writer, reader):
    boxes = np.asarray([[10.0, 20.0, 30.0, 60.0],
                        [100.5, 120.25, 25.0, 50.0]], np.float32)
    path = str(tmp_path / "View_001" / "detectionResult" / "frame_0000.txt")
    writer.write_detection_file(path, boxes)
    out, parts = reader.read_detection_file(path)
    ref, ref_parts = writer.read_detection_file(path)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(parts, ref_parts)
    np.testing.assert_allclose(out, boxes, rtol=1e-6)


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=DIRECTION_IDS)
def test_ground_truth_round_trip(tmp_path, writer, reader):
    rng = np.random.RandomState(0)
    x, y = rng.rand(5, 3) * 1e4, rng.rand(5, 3) * 1e4
    path = str(tmp_path / "groundTruth" / "cropped.txt")
    writer.write_ground_truth(path, x, y)
    for a, b in zip(reader.read_ground_truth(path),
                    writer.read_ground_truth(path)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=DIRECTION_IDS)
def test_tsai_xml_round_trip(tmp_path, writer, reader):
    """Camera fields read by either package from either package's file
    are equal (each builds its camera in float32 from the same text)."""
    cam = (JaxCamera if writer is jdata else TsaiCamera).create(**CAM_ARGS)
    path = str(tmp_path / "calibrationInfos" / "View_001.xml")
    wpets = jpets if writer is jdata else tpets
    wpets.write_tsai_xml(path, cam, rx=2.4, ry=0.2, rz=0.3)
    got = reader.read_tsai_xml(path)
    _assert_cameras_equal(got, writer.read_tsai_xml(path))
    assert isinstance(tpets.read_tsai_xml(path), TsaiCamera)
    assert tpets.read_tsai_xml(path).width.device.type == "cpu"


def test_tsai_dat_readers_agree(tmp_path):
    path = str(tmp_path / "cam.dat")
    vals = [768, 768, 0.0083, 0.0083, 0.0083, 0.0083, 384.0, 288.0, 1.0,
            8.0, 1e-6, 100.0, -11000.0, 8000.0, 2.4, 0.2, 0.3]
    with open(path, "w") as f:
        f.write(" ".join(str(v) for v in vals))
    _assert_cameras_equal(tpets.read_tsai_dat(path, 768, 576),
                          jpets.read_tsai_dat(path, 768, 576))


@pytest.mark.parametrize("writer,reader",
                         [(jsidemaps, tsidemaps), (tsidemaps, jsidemaps)],
                         ids=DIRECTION_IDS)
def test_sidemap_text_round_trip(tmp_path, writer, reader):
    m = np.linspace(0, 50, 12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "ProjectionSensitivity_View001.txt")
    writer.write_sidemap_txt(p, m)
    assert open(p).readline() == "row:3,col:4\n"
    np.testing.assert_array_equal(reader.read_sidemap_txt(p),
                                  writer.read_sidemap_txt(p))


@pytest.mark.parametrize("ext", [".ppm", ".png"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=DIRECTION_IDS)
def test_frame_round_trip(tmp_path, writer, reader, ext):
    rgb = (np.random.RandomState(0).rand(24, 32, 3) * 255).astype(np.uint8)
    p = str(tmp_path / f"View_001/frame_0003{ext}")
    os.makedirs(os.path.dirname(p))
    writer.write_image(p, rgb)
    assert reader.find_frame(str(tmp_path), 1, 3) == p
    np.testing.assert_array_equal(reader.read_image(p), rgb)
    frames = reader.FrameSource(str(tmp_path), [1], 32, 24)(3)
    np.testing.assert_array_equal(frames[0], rgb)


def test_ppm_fallback_reader_agrees(tmp_path):
    """The dependency-free PPM path (the one a machine without PIL and
    cv2 takes) reads what both packages write."""
    from mcmtt_opticalflow_tpu_torch.data.images import _read_ppm
    rgb = (np.random.RandomState(1).rand(12, 20, 3) * 255).astype(np.uint8)
    for i, writer in enumerate((jdata, tdata)):
        p = str(tmp_path / f"{i}.ppm")
        writer.write_image(p, rgb)
        np.testing.assert_array_equal(_read_ppm(p), rgb)


def test_sample_map_matches_jax():
    rng = np.random.RandomState(2)
    m = rng.rand(48, 64).astype(np.float32)
    uv = np.stack([rng.uniform(-20, 280, 50), rng.uniform(-20, 210, 50)],
                  -1).astype(np.float32)
    ref = jsidemaps.sample_map(jnp.asarray(m), jnp.asarray(uv), W, H, 4)
    got = tsidemaps.sample_map(torch.tensor(m), torch.tensor(uv), W, H, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("files", [False, True], ids=["computed", "loaded"])
def test_load_or_compute_sidemaps_matches_jax(tmp_path, files):
    jsc = jdata.make_scenario(num_cameras=2, num_frames=1, num_people=1,
                              image_size=(W, H), arena=4000.0, seed=3)
    tsc = tdata.make_scenario(num_cameras=2, num_frames=1, num_people=1,
                              image_size=(W, H), arena=4000.0, seed=3)
    root = str(tmp_path)
    if files:
        os.makedirs(os.path.join(root, "calibrationInfos"))
        rng = np.random.RandomState(4)
        for cid in CAM_IDS:
            for name in ("ProjectionSensitivity", "DistanceFromBoundary"):
                jsidemaps.write_sidemap_txt(
                    os.path.join(root, "calibrationInfos",
                                 f"{name}_View{cid:03d}.txt"),
                    rng.rand(H, W).astype(np.float32) * 100)
    for ci, cid in enumerate(CAM_IDS):
        ref = jsidemaps.load_or_compute_sidemaps(
            jsc.cameras[ci], W, H, 4, dataset_path=root, cam_id=cid)
        got = tsidemaps.load_or_compute_sidemaps(
            tsc.cameras[ci], W, H, 4, dataset_path=root, cam_id=cid)
        assert got[2] == ref[2] == (1 if files else 4)
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(a, np.asarray(b))


# --- a reference-layout dataset through both packages ---------------------

@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """The reference's layout (calibration XML, per-frame detection files,
    .ppm frames, groundTruth/cropped.txt), written by the JAX package."""
    root = str(tmp_path_factory.mktemp("dataset"))
    sc = jdata.make_scenario(num_cameras=2, num_frames=NUM_FRAMES,
                             num_people=3, image_size=(W, H), arena=4000.0,
                             seed=13)
    for ci, cid in enumerate(CAM_IDS):
        cam = sc.cameras[ci]
        ry = math.asin(-float(cam.r31))
        rx = math.atan2(float(cam.r32), float(cam.r33))
        rz = math.atan2(float(cam.r21), float(cam.r11))
        jpets.write_tsai_xml(os.path.join(root, "calibrationInfos",
                                          f"View_{cid:03d}.xml"),
                             cam, rx=rx, ry=ry, rz=rz)
    for t in range(NUM_FRAMES):
        imgs = sc.frames(t)
        for ci, cid in enumerate(CAM_IDS):
            jdata.write_detection_file(
                os.path.join(root, f"View_{cid:03d}", "detectionResult",
                             f"frame_{t:04d}.txt"), sc.detections[t][ci])
            rgb = (np.clip(imgs[ci], 0, 1) * 255 + 0.5).astype(np.uint8)
            jdata.write_image(os.path.join(root, f"View_{cid:03d}",
                                           f"frame_{t:04d}.ppm"), rgb)
    gx, gy = sc.gt_matrices()
    jdata.write_ground_truth(os.path.join(root, "groundTruth",
                                          "cropped.txt"), gx, gy)
    return root


def _sweep(pkg: str, root: str):
    """Read the dataset with `pkg`'s own readers and run its k_sweep with
    tests/test_dataset_compat.py's small engine, as main.run_dataset
    wires them."""
    mod = lambda name: importlib.import_module(f"{PACKAGES[pkg]}.{name}")
    cfgm, data = mod("config"), mod("data")
    cams = [data.read_tsai_xml(os.path.join(
        root, "calibrationInfos", f"View_{cid:03d}.xml")) for cid in CAM_IDS]
    sidemaps = [mod("geometry.sidemaps").load_or_compute_sidemaps(
        c, W, H, 4, dataset_path=root, cam_id=cid)
        for c, cid in zip(cams, CAM_IDS)]

    def make_engine(k):
        cfg = cfgm.EngineConfig(
            num_cameras=2, image_width=W, image_height=H,
            tracker2d=cfgm.Tracker2DConfig(
                max_detections=16, max_trackers=32, max_features=16,
                lk_window=8, lk_pyramid_levels=2, lk_iterations=6),
            assoc3d=cfgm.Associator3DConfig(k_best_size=k),
            solver=cfgm.SolverConfig(num_replicas=4, max_vertices=64,
                                     solutions_per_replica=8,
                                     max_iterations=200, solve_batch=4))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        eng = mod("models.pipeline").TrackingEngine(cfg, cams,
                                                    sidemaps=sidemaps, **kw)
        if pkg == "torch":
            eng.assoc.field_source = JaxFieldSource(cfg.solver.seed)
        return eng

    def dets(t):
        return [data.read_detection_file(os.path.join(
            root, f"View_{cid:03d}", "detectionResult",
            f"frame_{t:04d}.txt"))[0] for cid in CAM_IDS]

    gt = data.read_ground_truth(os.path.join(root, "groundTruth",
                                             "cropped.txt"))
    frames = data.FrameSource(root, CAM_IDS, W, H)
    return mod("eval.experiment").k_sweep(
        make_engine, frames, dets, NUM_FRAMES, gt, ZONE, ks=[10],
        num_experiments=1)


def test_k_sweep_matches_jax_on_reference_layout(dataset_root):
    with pallas_interpret():
        ref = _sweep("jax", dataset_root)
    got = _sweep("torch", dataset_root)
    assert len(ref) == len(got) == 1
    assert got[0].k == ref[0].k == 10
    assert sorted(got[0].per_window) == sorted(ref[0].per_window) \
        == list(range(11))
    for w, r in ref[0].per_window.items():
        g = got[0].per_window[w]
        for f in ("mota", "false_positives", "missed", "id_switches"):
            assert getattr(g, f) == pytest.approx(getattr(r, f), abs=1e-9), \
                (w, f, g.summary(), r.summary())
        assert g.motp == pytest.approx(r.motp, abs=MOTP_ATOL), \
            (w, g.summary(), r.summary())
    assert ref[0].per_window[0].mota > 0.3
