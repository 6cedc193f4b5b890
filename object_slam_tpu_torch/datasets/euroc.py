"""EuRoC MAV stereo/monocular loader with stereo rectification.

A numpy copy of object_slam_tpu/datasets/euroc.py
(Examples/Stereo/stereo_euroc.cc, Examples/Monocular/mono_euroc.cc):
images are ``<cam_dir>/<timestamp_ns>.png``, enumerated by a timestamps
file or the mav0 ``cam0/data.csv``; the pair is rectified with maps built
as ``cv::initUndistortRectifyMap`` builds them from the LEFT./RIGHT.
K/D/R/P blocks of the settings YAML (for each rectified pixel: unproject
through the new projection P, rotate back by R^T, apply the original K's
radial-tangential distortion), then remapped bilinearly. Images are
decoded by datasets/png.py. ``write_sequence`` writes a mav0 directory
and a settings YAML from rendered frames.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from object_slam_tpu_torch.datasets.png import read_png, write_png

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


@dataclass
class EurocFrame:
    index: int
    timestamp: float       # seconds
    left_path: str
    right_path: str


def load_sequence(left_dir: str, right_dir: str,
                  times_file: str) -> List[EurocFrame]:
    frames = []
    with open(times_file) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            ns = line.split(".")[0].split(",")[0]
            frames.append(EurocFrame(
                index=i, timestamp=float(ns) * 1e-9,
                left_path=os.path.join(left_dir, ns + ".png"),
                right_path=os.path.join(right_dir, ns + ".png")))
    return frames


def load_sequence_mav(mav_dir: str) -> List[EurocFrame]:
    """Enumerate from the mav0 layout (cam0/data.csv) without a separate
    timestamps file."""
    left_dir = os.path.join(mav_dir, "cam0", "data")
    right_dir = os.path.join(mav_dir, "cam1", "data")
    csv = os.path.join(mav_dir, "cam0", "data.csv")
    frames = []
    with open(csv) as f:
        i = 0
        for line in f:
            if line.startswith("#"):
                continue
            ns = line.split(",")[0].strip()
            if not ns:
                continue
            frames.append(EurocFrame(
                index=i, timestamp=float(ns) * 1e-9,
                left_path=os.path.join(left_dir, ns + ".png"),
                right_path=os.path.join(right_dir, ns + ".png")))
            i += 1
    return frames


# ---------------------------------------------------------------------------
# Settings-YAML calibration parsing (OpenCV FileStorage format, no cv2)
# ---------------------------------------------------------------------------

_MAT_RE = re.compile(
    r"^(?P<name>[A-Z]+\.[A-Za-z]+):\s*!!opencv-matrix", re.M)


def _parse_opencv_yaml(text: str):
    """Extract scalar keys and !!opencv-matrix blocks from an OpenCV
    FileStorage YAML (the reference settings format, Tracking.cc:68-130)."""
    scalars = {}
    for mline in re.finditer(
            r"^([A-Za-z]+(?:\.[A-Za-z0-9_]+)+):\s*([-0-9.eE+]+)\s*$",
            text, re.M):
        scalars[mline.group(1)] = float(mline.group(2))
    mats = {}
    for m in re.finditer(
            r"^([A-Z]+\.[A-Za-z]+):\s*!!opencv-matrix\s*\n"
            r"\s*rows:\s*(\d+)\s*\n\s*cols:\s*(\d+)\s*\n\s*dt:\s*\w+\s*\n"
            r"\s*data:\s*\[([^\]]*)\]", text, re.M):
        name, rows, cols, data = m.groups()
        vals = np.array([float(x) for x in data.replace("\n", " ").split(",")])
        mats[name] = vals.reshape(int(rows), int(cols))
    return scalars, mats


@dataclass
class SideCalib:
    K: np.ndarray          # [3, 3] original intrinsics
    D: np.ndarray          # [5] radtan k1 k2 p1 p2 k3
    R: np.ndarray          # [3, 3] rectifying rotation
    P: np.ndarray          # [3, 3] new projection (P[:3, :3])
    width: int
    height: int


@dataclass
class EurocCalib:
    left: SideCalib
    right: SideCalib

    @staticmethod
    def from_yaml(path: str) -> "EurocCalib":
        with open(path) as f:
            scalars, mats = _parse_opencv_yaml(f.read())
        sides = {}
        for side in ("LEFT", "RIGHT"):
            D = mats[f"{side}.D"].reshape(-1)
            D = np.pad(D, (0, max(0, 5 - D.shape[0])))[:5]
            sides[side] = SideCalib(
                K=mats[f"{side}.K"], D=D, R=mats[f"{side}.R"],
                P=mats[f"{side}.P"][:3, :3],
                width=int(scalars[f"{side}.width"]),
                height=int(scalars[f"{side}.height"]))
        return EurocCalib(left=sides["LEFT"], right=sides["RIGHT"])


def _distort_radtan(x, y, D):
    k1, k2, p1, p2, k3 = D
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def rectify_maps(c: SideCalib) -> Tuple[np.ndarray, np.ndarray]:
    """initUndistortRectifyMap: rectified pixel -> source pixel maps
    (map_x, map_y), each [H, W] float32."""
    H, W = c.height, c.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    # unproject through the NEW projection
    x = (u - c.P[0, 2]) / c.P[0, 0]
    y = (v - c.P[1, 2]) / c.P[1, 1]
    ray = np.stack([x, y, np.ones_like(x)], -1) @ c.R  # == R^T applied rowwise
    xn = ray[..., 0] / ray[..., 2]
    yn = ray[..., 1] / ray[..., 2]
    xd, yd = _distort_radtan(xn, yn, c.D)
    map_x = c.K[0, 0] * xd + c.K[0, 2]
    map_y = c.K[1, 1] * yd + c.K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """cv::remap(..., INTER_LINEAR, BORDER_CONSTANT=0) as a vectorized
    gather."""
    H, W = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int32)
    y0 = np.floor(map_y).astype(np.int32)
    inb = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    # offsets relative to the CLIPPED base so the last row/col interpolate
    # correctly (fx = 1 selects the far sample)
    fx = map_x - x0c
    fy = map_y - y0c
    i00 = img[y0c, x0c]
    i01 = img[y0c, x0c + 1]
    i10 = img[y0c + 1, x0c]
    i11 = img[y0c + 1, x0c + 1]
    out = (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
           + i10 * (1 - fx) * fy + i11 * fx * fy)
    return np.where(inb, out, 0.0).astype(np.float32)


class Rectifier:
    """Per-sequence rectification state (maps computed once)."""

    def __init__(self, calib: EurocCalib):
        self.lx, self.ly = rectify_maps(calib.left)
        self.rx, self.ry = rectify_maps(calib.right)

    def __call__(self, gray_l: np.ndarray, gray_r: np.ndarray):
        return (remap_bilinear(gray_l, self.lx, self.ly),
                remap_bilinear(gray_r, self.rx, self.ry))


def load_groundtruth_csv(path: str):
    """mav0/state_groundtruth_estimate0/data.csv -> (ts [N] seconds,
    pos [N, 3], quat_wxyz [N, 4]) body-in-world."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.strip().split(",")
            if len(v) < 8:
                continue
            ts.append(float(v[0]) * 1e-9)
            pos.append([float(x) for x in v[1:4]])
            quat.append([float(x) for x in v[4:8]])
    return np.asarray(ts), np.asarray(pos), np.asarray(quat)


def euroc_camera_config(calib: EurocCalib, bf: float = 47.90639384423901,
                        fps: float = 20.0, th_depth: float = 35.0):
    """CameraConfig for the rectified pair: intrinsics come from LEFT.P and
    distortion is zero (Examples/Stereo/EuRoC.yaml Camera.* block)."""
    from object_slam_tpu_torch.config import CameraConfig
    P = calib.left.P
    return CameraConfig(
        fx=float(P[0, 0]), fy=float(P[1, 1]),
        cx=float(P[0, 2]), cy=float(P[1, 2]),
        dist=(0.0, 0.0, 0.0, 0.0, 0.0),
        width=calib.left.width, height=calib.left.height,
        fps=fps, bf=bf, th_depth=th_depth, depth_map_factor=1.0)


def load_gray(path: str) -> np.ndarray:
    """One EuRoC image as f32 gray (an RGB file reduced to its luma, as
    scripts/run_euroc.py does)."""
    return to_gray(read_png(path))


def to_gray(img: np.ndarray) -> np.ndarray:
    """A decoded image (read_png's, or the native prefetcher's) ->
    load_gray's f32 gray."""
    g = img.astype(np.float32)
    if g.ndim == 3:
        g = g[..., :3] @ _LUMA
    return g


def _yaml_matrix(name: str, M) -> str:
    M = np.asarray(M, np.float64)
    data = ", ".join(repr(float(x)) for x in M.reshape(-1))
    return (f"{name}: !!opencv-matrix\n   rows: {M.shape[0]}\n"
            f"   cols: {M.shape[1]}\n   dt: d\n   data: [{data}]\n")


def write_settings(path: str, cam) -> None:
    """A settings YAML whose LEFT./RIGHT. blocks rectify nothing (zero
    distortion, identity R, K = P = the camera's intrinsics)."""
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                  [0.0, 0.0, 1.0]])
    P = np.concatenate([K, np.zeros((3, 1))], 1)
    lines = ["%YAML:1.0\n", f"Camera.fx: {cam.fx!r}\n",
             f"Camera.fy: {cam.fy!r}\n"]
    for side in ("LEFT", "RIGHT"):
        lines += [f"{side}.height: {cam.height}\n",
                  f"{side}.width: {cam.width}\n",
                  _yaml_matrix(f"{side}.D", np.zeros((1, 5))),
                  _yaml_matrix(f"{side}.K", K),
                  _yaml_matrix(f"{side}.R", np.eye(3)),
                  _yaml_matrix(f"{side}.P", P)]
    with open(path, "w") as f:
        f.write("".join(lines))


def write_sequence(mav_dir: str, poses, frames, fps: float = 20.0,
                   t0_ns: int = 1403636579763555584) -> List[int]:
    """A mav0 directory: cam0/ and cam1/ with data/<ns>.png (u8) and
    data.csv, and state_groundtruth_estimate0/data.csv (the body in the
    world, position and quaternion wxyz, the camera taken as the body).
    poses: world-to-camera [4, 4]; frames: per pose (gray_l u8, gray_r
    u8). Returns the nanosecond stamps."""
    stamps = [t0_ns + int(round(i * 1e9 / fps)) for i in range(len(frames))]
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(mav_dir, cam, "data"), exist_ok=True)
        with open(os.path.join(mav_dir, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            f.writelines(f"{ns},{ns}.png\n" for ns in stamps)
    for ns, (gl, gr) in zip(stamps, frames):
        write_png(os.path.join(mav_dir, "cam0", "data", f"{ns}.png"), gl)
        write_png(os.path.join(mav_dir, "cam1", "data", f"{ns}.png"), gr)
    gt_dir = os.path.join(mav_dir, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for ns, T in zip(stamps, poses):
            Twc = np.linalg.inv(np.asarray(T, np.float64))
            q = _quat_wxyz(Twc[:3, :3])
            f.write(f"{ns}," + ",".join(f"{x:.9f}" for x in Twc[:3, 3])
                    + "," + ",".join(f"{x:.9f}" for x in q) + "\n")
    return stamps


def _quat_wxyz(R) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                  (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    return q / np.linalg.norm(q)
