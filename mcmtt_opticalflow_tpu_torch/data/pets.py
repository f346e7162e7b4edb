"""Readers/writers for the reference's on-disk dataset formats.

A user of the reference can point this engine at the same directory tree:

  * per-frame detection text files, PETS full-body format with part boxes
    (ref psn_where/PSNWhere_Utils.cpp:1051-1075) and ETRI/head formats
    (ref :1004-1050)
  * ground-truth X/Y matrices, groundTruth/cropped.txt
    (ref psn_where/Evaluator.cpp:45-88)
  * Tsai calibration XML (ref psn_where/calibration/cameraModel.cpp:100-235)
    and .dat (ref :465-492)
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from mcmtt_opticalflow_tpu_torch.geometry.tsai import TsaiCamera

PART_NAMES = ["HEAD", "F1", "S1", "GR", "S2", "A1", "A2", "F2"]


# ---------------------------------------------------------------------------
# detections
# ---------------------------------------------------------------------------

def read_detection_file(path: str, fmt: str = "pets_fullbody"):
    """Read one per-frame detection file.

    Returns (boxes [K, 4], part_boxes [K, 8, 4] or None).
    Formats:
      'pets_fullbody': numBoxes:N then {ROOT:{x,y,w,h} + 8 named parts}
                       (ref PSNWhere_Utils.cpp:1051-1075)
      'etri':          N then 'score id w h x y' rows (ref :1037-1049)
      'head':          N then 'score id w h x y' comma rows (ref :1005-1019)
    """
    if not os.path.exists(path):
        return np.zeros((0, 4), np.float32), None
    text = open(path).read()
    if fmt == "pets_fullbody":
        n_match = re.search(r"numBoxes:(\d+)", text)
        n = int(n_match.group(1)) if n_match else 0
        quads = re.findall(
            r"(ROOT|" + "|".join(PART_NAMES) + r"):\{([-\d.eE]+),([-\d.eE]+),"
            r"([-\d.eE]+),([-\d.eE]+)\}", text)
        boxes, parts, cur = [], [], None
        for name, x, y, w, h in quads:
            vals = [float(x), float(y), float(w), float(h)]
            if name == "ROOT":
                boxes.append(vals)
                cur = []
                parts.append(cur)
            elif cur is not None:
                cur.append(vals)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)[:n or None]
        part_arr = None
        if parts and all(len(p) == len(PART_NAMES) for p in parts):
            part_arr = np.asarray(parts, np.float32)
        return boxes, part_arr
    # ETRI / head simple row formats: score id w h x y
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return np.zeros((0, 4), np.float32), None
    try:
        n = int(lines[0].split()[0].split(",")[0])
    except ValueError:
        n = len(lines) - 1
    boxes = []
    for ln in lines[1:1 + n]:
        vals = [float(v) for v in re.split(r"[,\s]+", ln.strip()) if v]
        if len(vals) >= 6:
            _, _, w, h, x, y = vals[:6]
            boxes.append([x, y, w, h])
    return np.asarray(boxes, np.float32).reshape(-1, 4), None


def write_detection_file(path: str, boxes: np.ndarray,
                         fmt: str = "pets_fullbody") -> None:
    """Write detections in the reference's PETS full-body format (parts are
    synthesised as the ROOT box; the engine only consumes ROOT + HEAD)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if fmt == "pets_fullbody":
            f.write(f"numBoxes:{len(boxes)}\n")
            for b in boxes:
                x, y, w, h = [float(v) for v in b]
                f.write("{\n\tROOT:{%f,%f,%f,%f}\n" % (x, y, w, h))
                head = (x + 0.3 * w, y, 0.4 * w, 0.2 * h)
                for name in PART_NAMES:
                    if name == "HEAD":
                        f.write("\t%s:{%f,%f,%f,%f}\n" % ((name,) + head))
                    else:
                        f.write("\t%s:{%f,%f,%f,%f}\n" % (name, x, y, w, h))
                f.write("}\n")
        else:
            f.write(f"{len(boxes)}\n")
            for b in boxes:
                x, y, w, h = [float(v) for v in b]
                f.write(f"0 0 {w} {h} {x} {y}\n")


def read_track2d_result(path: str):
    """Read a per-frame 2D tracking result file (the reference's tracklet
    input mode, psn_where/PSNWhere_Utils.cpp:1099-1240 /
    Tracker2D FilePrintResult format).

    Returns (cam_idx, frame_idx, ids [K], boxes [K, 4])."""
    if not os.path.exists(path):
        return -1, -1, np.zeros(0, np.int64), np.zeros((0, 4), np.float32)
    text = open(path).read()
    cam = int(re.search(r"camIdx:(\d+)", text).group(1))
    frame = int(re.search(r"frameIdx:(\d+)", text).group(1))
    ids, boxes = [], []
    for m in re.finditer(
            r"id:(\d+)\s*[\n\t ]+box:\(([-\d.eE]+),([-\d.eE]+),"
            r"([-\d.eE]+),([-\d.eE]+)\)", text):
        ids.append(int(m.group(1)))
        boxes.append([float(m.group(k)) for k in range(2, 6)])
    return (cam, frame, np.asarray(ids, np.int64),
            np.asarray(boxes, np.float32).reshape(-1, 4))


# ---------------------------------------------------------------------------
# ground truth
# ---------------------------------------------------------------------------

def read_ground_truth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read groundTruth/cropped.txt -> (X [T, P], Y [T, P])
    (ref Evaluator.cpp:45-88)."""
    text = open(path).read()
    m = re.search(r"numObj=(\d+),numTime=(\d+)", text)
    num_obj, num_time = int(m.group(1)), int(m.group(2))
    nums = re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?",
                      text[m.end():])
    vals = np.asarray([float(v) for v in nums], np.float64)
    need = 2 * num_time * num_obj
    vals = vals[:need]
    x = vals[:num_time * num_obj].reshape(num_time, num_obj)
    y = vals[num_time * num_obj:].reshape(num_time, num_obj)
    return x, y


def write_ground_truth(path: str, x: np.ndarray, y: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t, p = x.shape
    with open(path, "w") as f:
        f.write(f"numObj={p},numTime={t}\n")
        f.write("X={\n")
        for row in x:
            f.write(",".join(f"{v:.4f}" for v in row) + ",\n")
        f.write("}\nY={\n")
        for row in y:
            f.write(",".join(f"{v:.4f}" for v in row) + ",\n")
        f.write("}\n")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def read_tsai_xml(path: str) -> TsaiCamera:
    """Parse the Etiseo Camera XML (attributes on Geometry/Intrinsic/
    Extrinsic tags; ref cameraModel.cpp:100-235, without the MSXML/COM
    dependency)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    cam_el = root if root.tag == "Camera" else root.find(".//Camera")
    geo = cam_el.find("Geometry").attrib
    intr = cam_el.find("Intrinsic").attrib
    extr = cam_el.find("Extrinsic").attrib
    return TsaiCamera.create(
        width=int(float(geo["width"])), height=int(float(geo["height"])),
        dpx=float(geo["dpx"]), dpy=float(geo["dpy"]),
        focal=float(intr["focal"]), kappa1=float(intr["kappa1"]),
        cx=float(intr["cx"]), cy=float(intr["cy"]), sx=float(intr["sx"]),
        tx=float(extr["tx"]), ty=float(extr["ty"]), tz=float(extr["tz"]),
        rx=float(extr["rx"]), ry=float(extr["ry"]), rz=float(extr["rz"]))


def write_tsai_xml(path: str, cam: TsaiCamera, rx: float, ry: float,
                   rz: float, name: str = "cam") -> None:
    """Write the Etiseo XML (Euler angles must be supplied; TsaiCamera
    stores the precomputed rotation)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            '<Camera name="%s">\n'
            '  <Geometry width="%d" height="%d" ncx="%f" nfx="%f" dx="%f" '
            'dy="%f" dpx="%f" dpy="%f"/>\n'
            '  <Intrinsic focal="%f" kappa1="%g" cx="%f" cy="%f" sx="%f"/>\n'
            '  <Extrinsic tx="%f" ty="%f" tz="%f" rx="%f" ry="%f" rz="%f"/>\n'
            "</Camera>\n"
            % (name, int(cam.width), int(cam.height),
               float(cam.width), float(cam.width), float(cam.dpx),
               float(cam.dpy), float(cam.dpx), float(cam.dpy),
               float(cam.focal), float(cam.kappa1), float(cam.cx),
               float(cam.cy), float(cam.sx),
               float(cam.tx), float(cam.ty), float(cam.tz), rx, ry, rz))


def read_tsai_dat(path: str, width: int, height: int) -> TsaiCamera:
    """Read the 17-value Tsai .dat stream (ref cameraModel.cpp:465-492)."""
    vals = [float(v) for v in open(path).read().split()]
    (ncx, nfx, dx, dy, dpx, dpy, cx, cy, sx, focal, kappa1,
     tx, ty, tz, rx, ry, rz) = vals[:17]
    return TsaiCamera.create(
        width=width, height=height, dpx=dpx, dpy=dpy, focal=focal,
        kappa1=kappa1, cx=cx, cy=cy, sx=sx, tx=tx, ty=ty, tz=tz,
        rx=rx, ry=ry, rz=rz)
