"""Trajectory and object-info writers in the reference's output formats.

A numpy copy of object_slam_tpu/eval/trajectory_io.py:
``System::SaveTrajectoryTUM`` (System.cc:378-436: per-frame
``timestamp tx ty tz qx qy qz qw`` of camera-to-world),
``SaveKeyFrameTrajectoryTUM`` (:439), ``SaveTrajectoryKITTI`` (:475: 3x4
row-major camera-to-world per line) and ``SaveObjctInfo`` (:331-374:
per-label object counts, total, semantic-constraint count).
"""

from __future__ import annotations

import numpy as np


def _rot_to_quat(R):
    """[3,3] -> (qx, qy, qz, qw)."""
    tr = np.trace(R)
    if tr > 0:
        qw = np.sqrt(1.0 + tr) / 2
        qx = (R[2, 1] - R[1, 2]) / (4 * qw)
        qy = (R[0, 2] - R[2, 0]) / (4 * qw)
        qz = (R[1, 0] - R[0, 1]) / (4 * qw)
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            qx = np.sqrt(1 + R[0, 0] - R[1, 1] - R[2, 2]) / 2
            qw = (R[2, 1] - R[1, 2]) / (4 * qx)
            qy = (R[0, 1] + R[1, 0]) / (4 * qx)
            qz = (R[0, 2] + R[2, 0]) / (4 * qx)
        elif i == 1:
            qy = np.sqrt(1 - R[0, 0] + R[1, 1] - R[2, 2]) / 2
            qw = (R[0, 2] - R[2, 0]) / (4 * qy)
            qx = (R[0, 1] + R[1, 0]) / (4 * qy)
            qz = (R[1, 2] + R[2, 1]) / (4 * qy)
        else:
            qz = np.sqrt(1 - R[0, 0] - R[1, 1] + R[2, 2]) / 2
            qw = (R[1, 0] - R[0, 1]) / (4 * qz)
            qx = (R[0, 2] + R[2, 0]) / (4 * qz)
            qy = (R[1, 2] + R[2, 1]) / (4 * qz)
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def _tum_line(ts, Tcw) -> str:
    Twc = np.linalg.inv(Tcw)
    q = _rot_to_quat(Twc[:3, :3])
    t = Twc[:3, 3]
    return (f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_trajectory_tum(path, trajectory):
    """trajectory: iterable of (timestamp, Tcw [4,4], tracked). Writes
    camera-to-world lines `t tx ty tz qx qy qz qw` for tracked frames."""
    with open(path, "w") as f:
        for ts, Tcw, tracked in trajectory:
            if tracked:
                f.write(_tum_line(ts, Tcw))


def save_trajectory_kitti(path, trajectory):
    """3x4 row-major camera-to-world per line (all frames)."""
    with open(path, "w") as f:
        for ts, Tcw, tracked in trajectory:
            Twc = np.linalg.inv(Tcw)
            row = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_keyframe_trajectory_tum(path, kf_timestamps, kf_poses, kf_valid):
    with open(path, "w") as f:
        for ts, Tcw, ok in zip(kf_timestamps, kf_poses, kf_valid):
            if ok:
                f.write(_tum_line(ts, Tcw))


def save_object_info(path, obj_labels, obj_valid, semantic_constraints: int):
    """ObjectInfo.txt equivalent: label -> count census, total, and the
    accumulated semantic-constraint count (System.cc:331-374)."""
    labels = np.asarray(obj_labels)[np.asarray(obj_valid)]
    uniq, counts = np.unique(labels, return_counts=True)
    with open(path, "w") as f:
        for lab, cnt in zip(uniq, counts):
            f.write(f"label {int(lab)}: {int(cnt)}\n")
        f.write(f"total: {int(counts.sum()) if len(counts) else 0}\n")
        f.write(f"semantic_constraints: {int(semantic_constraints)}\n")
