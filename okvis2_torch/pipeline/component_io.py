"""Multi-session map serialisation (g2o-style text).

Port of ``okvis2_tpu/pipeline/component_io.py``, a copy: the same
vocabulary and the same format strings, so that a map either package
saves loads in the other, and identical records give identical bytes.

Covers okvis::Component (reference: okvis_ceres/src/Component.cpp:70-404
load, :405-526 save): poses, velocities, biases, landmarks, IMU edges
with raw measurements, and observation edges with keypoints+descriptors,
in the same g2o-style vertex/edge text vocabulary so maps are
inspectable and round-trippable:

    VERTEX_SE3:QUAT_TIME id x y z qx qy qz qw t
    VERTEX_R3:VEL id vx vy vz
    VERTEX_R3:GYRBIAS id bgx bgy bgz
    VERTEX_R3:ACCBIAS id bax bay baz
    VERTEX_TRACKXYZ lid x y z w
    EDGE_IMU id0 id1 n
    IMU_MEAS t wx wy wz ax ay az     (n lines after EDGE_IMU)
    EDGE_OBS lid sid cam kp u v size <hex descriptor (optional)>
"""

from __future__ import annotations

import binascii
from typing import Optional

import numpy as np


def save_component(path: str, estimator, descriptors: Optional[dict] = None):
    """Serialise the estimator's graph. `descriptors` optionally maps
    landmark id -> packed uint32[16] descriptor."""
    with open(path, "w") as f:
        for sid in estimator.state_order:
            rec = estimator.states[sid]
            p = rec.pose
            sb = rec.speed_bias
            f.write(
                f"VERTEX_SE3:QUAT_TIME {sid} "
                f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                f"{p[3]:.9f} {p[4]:.9f} {p[5]:.9f} {p[6]:.9f} {rec.t:.9f}\n"
            )
            f.write(f"VERTEX_R3:VEL {sid} {sb[0]:.9f} {sb[1]:.9f} {sb[2]:.9f}\n")
            f.write(f"VERTEX_R3:GYRBIAS {sid} {sb[3]:.9f} {sb[4]:.9f} {sb[5]:.9f}\n")
            f.write(f"VERTEX_R3:ACCBIAS {sid} {sb[6]:.9f} {sb[7]:.9f} {sb[8]:.9f}\n")
        for lid, lm in estimator.landmarks.items():
            hp = lm.hp_W
            f.write(
                f"VERTEX_TRACKXYZ {lid} {hp[0]:.9f} {hp[1]:.9f} "
                f"{hp[2]:.9f} {hp[3]:.9f}\n"
            )
        order = estimator.state_order
        for i in range(1, len(order)):
            rec = estimator.states[order[i]]
            n = len(rec.imu_dt)
            if n == 0:
                continue
            f.write(f"EDGE_IMU {order[i-1]} {order[i]} {n}\n")
            for k in range(n):
                w = rec.imu_w[k]
                a = rec.imu_a[k]
                f.write(
                    f"IMU_MEAS {rec.imu_dt[k]:.9f} "
                    f"{w[0]:.9f} {w[1]:.9f} {w[2]:.9f} "
                    f"{a[0]:.9f} {a[1]:.9f} {a[2]:.9f}\n"
                )
        for lid, lm in estimator.landmarks.items():
            for (sid, ci, kp), (u, v, size) in lm.obs.items():
                desc_hex = ""
                if descriptors and lid in descriptors:
                    desc_hex = " " + binascii.hexlify(
                        np.asarray(descriptors[lid], np.uint32).tobytes()
                    ).decode()
                f.write(
                    f"EDGE_OBS {lid} {sid} {ci} {kp} "
                    f"{u:.4f} {v:.4f} {size:.2f}{desc_hex}\n"
                )
        # pose-graph edges (marginalisation + loop closures)
        for e in estimator.pose_graph_edges:
            Tij = " ".join(f"{x:.9f}" for x in e.T_ij)
            sq = " ".join(f"{x:.9e}" for x in e.sqrt_info.reshape(-1))
            f.write(f"EDGE_REL {e.id_i} {e.id_j} {e.kind} {Tij} {sq}\n")


def load_component(path: str):
    """Parse a saved component into plain dicts (used for multi-session
    localisation; reference Frontend::loadComponent, Frontend.cpp:180-218).

    Returns dict with states, landmarks, imu_edges, observations, rel_edges.
    """
    states = {}
    landmarks = {}
    imu_edges = []
    observations = []
    rel_edges = []
    cur_imu = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE3:QUAT_TIME":
                sid = int(parts[1])
                vals = [float(x) for x in parts[2:10]]
                states.setdefault(sid, {})["pose"] = np.asarray(vals[:7])
                states[sid]["t"] = vals[7]
            elif tag == "VERTEX_R3:VEL":
                states.setdefault(int(parts[1]), {})["v"] = np.asarray(
                    [float(x) for x in parts[2:5]]
                )
            elif tag == "VERTEX_R3:GYRBIAS":
                states.setdefault(int(parts[1]), {})["bg"] = np.asarray(
                    [float(x) for x in parts[2:5]]
                )
            elif tag == "VERTEX_R3:ACCBIAS":
                states.setdefault(int(parts[1]), {})["ba"] = np.asarray(
                    [float(x) for x in parts[2:5]]
                )
            elif tag == "VERTEX_TRACKXYZ":
                landmarks[int(parts[1])] = np.asarray(
                    [float(x) for x in parts[2:6]]
                )
            elif tag == "EDGE_IMU":
                cur_imu = {
                    "id0": int(parts[1]),
                    "id1": int(parts[2]),
                    "n": int(parts[3]),
                    "meas": [],
                }
                imu_edges.append(cur_imu)
            elif tag == "IMU_MEAS" and cur_imu is not None:
                cur_imu["meas"].append([float(x) for x in parts[1:8]])
            elif tag == "EDGE_OBS":
                obs = {
                    "lid": int(parts[1]),
                    "sid": int(parts[2]),
                    "cam": int(parts[3]),
                    "kp": int(parts[4]),
                    "uv": (float(parts[5]), float(parts[6])),
                    "size": float(parts[7]),
                }
                if len(parts) > 8:
                    obs["descriptor"] = np.frombuffer(
                        binascii.unhexlify(parts[8]), np.uint32
                    )
                observations.append(obs)
            elif tag == "EDGE_REL":
                rel_edges.append(
                    {
                        "id_i": int(parts[1]),
                        "id_j": int(parts[2]),
                        "kind": parts[3],
                        "T_ij": np.asarray([float(x) for x in parts[4:11]]),
                        "sqrt_info": np.asarray(
                            [float(x) for x in parts[11:47]]
                        ).reshape(6, 6),
                    }
                )
    return {
        "states": states,
        "landmarks": landmarks,
        "imu_edges": imu_edges,
        "observations": observations,
        "rel_edges": rel_edges,
    }
