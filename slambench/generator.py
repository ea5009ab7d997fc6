"""The benchmark's traffic generator: a synthetic world, an analytic
trajectory and its IMU (exact, or with seeded white noise), read from a
traffic file.

A frozen copy of the port's generator (``pipeline/dataset.py``:
``SyntheticDataset`` and ``TexturedWorldDataset``; ``utils/synthetic.py``:
the default and circle trajectories, exact IMU; the pinhole-radtan
projection), written in numpy and plain torch so that the yardstick does
not move when the program does. It imports nothing of the port.

Two changes to the copied worlds, both for stationary traffic (the same
work per frame however far into the sequence a run gets):

- the star field is drawn in blocks of ``block_m`` metres along x, the
  first block with the port's draws in the port's order (so at one block
  it is the port's world), each further block the same draws shifted by
  ``block_m``;
- the textured room is a row of ``segments`` rooms of ``block_m`` metres
  along x, the first the port's (its planes, occluders and textures drawn
  in the port's order when ``occluders_per_segment`` is the port's 3 and
  the box and occluder ranges keep their defaults); each further segment
  gets its own back wall, floor, ceiling and occluders.

A trajectory is ``pos_i(t) = c_i + v_i t + sum a sin(w t + phi)`` per axis
and a rotation ``theta(t) = sum b sin(w t + phi)`` about a fixed axis,
which holds the port's default and circle trajectories exactly and the
walk's yaw sweeps; velocities and accelerations are analytic.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterator, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> dict:
    """``slambench/<kind>/<name>.json``."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# rotations (numpy, xyzw quaternions as the port's)
# ---------------------------------------------------------------------------

def quat_axis_angle(axis: np.ndarray, theta: float) -> np.ndarray:
    s = math.sin(0.5 * theta)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(0.5 * theta)])


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def mat_to_quat(C: np.ndarray) -> np.ndarray:
    tr = np.trace(C)
    cands = [1.0 + tr, 1.0 + C[0, 0] - C[1, 1] - C[2, 2], 1.0 - C[0, 0] + C[1, 1] - C[2, 2],
             1.0 - C[0, 0] - C[1, 1] + C[2, 2]]
    k = int(np.argmax(cands))
    s = 2.0 * math.sqrt(max(cands[k], 1e-12))
    if k == 0:
        q = [(C[2, 1] - C[1, 2]) / s, (C[0, 2] - C[2, 0]) / s, (C[1, 0] - C[0, 1]) / s, s / 4]
    elif k == 1:
        q = [s / 4, (C[0, 1] + C[1, 0]) / s, (C[0, 2] + C[2, 0]) / s, (C[2, 1] - C[1, 2]) / s]
    elif k == 2:
        q = [(C[0, 1] + C[1, 0]) / s, s / 4, (C[1, 2] + C[2, 1]) / s, (C[0, 2] - C[2, 0]) / s]
    else:
        q = [(C[0, 2] + C[2, 0]) / s, (C[1, 2] + C[2, 1]) / s, s / 4, (C[1, 0] - C[0, 1]) / s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------

class Trajectory:
    """Analytic trajectory from a traffic file's ``trajectory`` entry:
    ``position``: per axis {"c", "v", "sines": [[a, w, phi], ...]};
    ``rotation``: {"axis": [3], "sines": [[b, w, phi], ...]}."""

    def __init__(self, spec: dict):
        self.pos = [(float(a.get("c", 0.0)), float(a.get("v", 0.0)),
                     [tuple(map(float, s)) for s in a.get("sines", [])])
                    for a in spec["position"]]
        axis = np.asarray(spec["rotation"]["axis"], np.float64)
        self.axis = axis / np.linalg.norm(axis)
        self.rot = [tuple(map(float, s)) for s in spec["rotation"].get("sines", [])]

    def position(self, t: float) -> np.ndarray:
        return np.array([c + v * t + sum(a * math.sin(w * t + p) for a, w, p in s)
                         for c, v, s in self.pos])

    def velocity(self, t: float) -> np.ndarray:
        return np.array([v + sum(a * w * math.cos(w * t + p) for a, w, p in s)
                         for _c, v, s in self.pos])

    def acceleration(self, t: float) -> np.ndarray:
        return np.array([sum(-a * w * w * math.sin(w * t + p) for a, w, p in s)
                         for _c, _v, s in self.pos])

    def theta(self, t: float) -> float:
        return sum(b * math.sin(w * t + p) for b, w, p in self.rot)

    def theta_dot(self, t: float) -> float:
        return sum(b * w * math.cos(w * t + p) for b, w, p in self.rot)

    def pose(self, t: float) -> np.ndarray:
        """T_WS as [r, q_xyzw]."""
        return np.concatenate([self.position(t), quat_axis_angle(self.axis, self.theta(t))])

    def imu(self, t: float, g: float):
        """Exact (gyro, accel) in the body frame: a rotation about a fixed
        axis turns at theta' about that axis in every frame."""
        C_WS = quat_to_mat(quat_axis_angle(self.axis, self.theta(t)))
        a_S = C_WS.T @ (self.acceleration(t) - np.array([0.0, 0.0, -g]))
        return self.axis * self.theta_dot(t), a_S


# ---------------------------------------------------------------------------
# cameras (pinhole + radial-tangential, as configured)
# ---------------------------------------------------------------------------

class Camera:
    def __init__(self, spec: dict):
        self.width, self.height = (int(v) for v in spec["size"])
        self.focal = np.asarray(spec["focal"], np.float64)
        self.center = np.asarray(spec["center"], np.float64)
        if spec["distortion"] != "radialtangential":
            raise ValueError(f"generator: distortion {spec['distortion']!r} is not modelled")
        self.k = np.asarray(spec["coefficients"], np.float64)
        T = np.asarray(spec["T_SC"], np.float64).reshape(4, 4)
        self.T_SC7 = np.concatenate([T[:3, 3], mat_to_quat(T[:3, :3])])

    def project(self, p_C: np.ndarray):
        """[N,3] -> (uv [N,2], valid [N]): in front, inside the image with
        the half-pixel margin."""
        z = p_C[:, 2]
        safe = np.where(np.abs(z) > 1e-12, z, 1e-12)
        x, y = p_C[:, 0] / safe, p_C[:, 1] / safe
        k1, k2, p1, p2 = self.k
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + k2 * r2)
        xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        uv = np.stack([xd * self.focal[0] + self.center[0], yd * self.focal[1] + self.center[1]], -1)
        ok = ((z > 1e-12) & (uv[:, 0] >= -0.5) & (uv[:, 0] <= self.width - 0.5)
              & (uv[:, 1] >= -0.5) & (uv[:, 1] <= self.height - 0.5))
        return uv, ok

    def rays(self) -> np.ndarray:
        """Unit rays through the pixel centres [HW,3] (the radtan inverse by
        the port's fixed-point iteration is not needed: a ray is back-
        projected exactly by Newton steps on the distortion)."""
        u, v = np.meshgrid(np.arange(self.width, dtype=np.float64) + 0.5,
                           np.arange(self.height, dtype=np.float64) + 0.5)
        xd = (u.ravel() - self.center[0]) / self.focal[0]
        yd = (v.ravel() - self.center[1]) / self.focal[1]
        x, y = xd.copy(), yd.copy()
        k1, k2, p1, p2 = self.k
        for _ in range(20):
            r2 = x * x + y * y
            rad = 1.0 + r2 * (k1 + k2 * r2)
            fx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
            fy = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y) - yd
            drad = k1 + 2.0 * k2 * r2
            j00 = rad + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
            j01 = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
            j10 = 2.0 * x * y * drad + 2.0 * p2 * y + 2.0 * p1 * x
            j11 = rad + 2.0 * y * y * drad + 2.0 * p2 * x + 6.0 * p1 * y
            det = j00 * j11 - j01 * j10
            x = x - (j11 * fx - j01 * fy) / det
            y = y - (-j10 * fx + j00 * fy) / det
        ray = np.stack([x, y, np.ones_like(x)], -1)
        return ray / np.linalg.norm(ray, axis=-1, keepdims=True)


def T_CW(T_WS7: np.ndarray, T_SC7: np.ndarray):
    """(R_CW, t_CW) of the camera at body pose T_WS."""
    R_WS = quat_to_mat(T_WS7[3:7])
    R_WC = R_WS @ quat_to_mat(T_SC7[3:7])
    o_W = T_WS7[:3] + R_WS @ T_SC7[:3]
    return R_WC.T, -R_WC.T @ o_W


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

class StarField:
    """Small textured squares ("stars") in blocks of ``block_m`` metres along
    x: the port's ``SyntheticDataset`` world at one block."""

    def __init__(self, spec: dict, cameras: List[Camera], seed: int):
        n, blocks, L = int(spec["stars_per_block"]), int(spec["blocks"]), float(spec["block_m"])
        rng = np.random.default_rng(seed)
        stars, inten, size, pat = [], [], [], []
        for b in range(blocks):
            s = np.concatenate([rng.uniform(-6, 10, (n, 1)), rng.uniform(-6, 6, (n, 1)),
                                rng.uniform(2.0, 12.0, (n, 1))], axis=-1)
            s[:, 0] += b * L
            stars.append(s)
            inten.append(rng.uniform(0.25, 1.0, n))
            size.append(rng.integers(3, 6, n))
            pat.append(rng.uniform(0.3, 1.0, (n, 6, 6)))
        self.stars = np.concatenate(stars)
        self.intensity = np.concatenate(inten)
        self.size = np.concatenate(size)
        self.pattern = np.concatenate(pat)
        self.cameras = cameras

    def render(self, T_WS7: np.ndarray, frame_index: int):
        out = []
        for cam in self.cameras:
            R, t = T_CW(T_WS7, cam.T_SC7)
            p_C = self.stars @ R.T + t
            uv, ok = cam.project(p_C)
            ok &= p_C[:, 2] > 0.2
            img = np.zeros((cam.height, cam.width), np.float32)
            for k in np.nonzero(ok)[0]:
                x, y = uv[k]
                s = int(self.size[k])
                x0, y0 = int(round(x)) - s // 2, int(round(y)) - s // 2
                x1, y1 = x0 + s, y0 + s
                x0c, y0c = max(x0, 0), max(y0, 0)
                x1c, y1c = min(x1, cam.width), min(y1, cam.height)
                if x1c > x0c and y1c > y0c:
                    patch = self.intensity[k] * self.pattern[k][: y1c - y0c, : x1c - x0c]
                    img[y0c:y1c, x0c:x1c] = np.maximum(img[y0c:y1c, x0c:x1c],
                                                       patch.astype(np.float32))
            out.append(img)
        return out, None


def _upsample_bilinear(g: np.ndarray, T: int) -> np.ndarray:
    o = g.shape[0]
    x = np.linspace(0.0, o - 1.0, T)
    x0 = np.floor(x).astype(int)
    x1 = np.minimum(x0 + 1, o - 1)
    fx = (x - x0).astype(np.float32)
    rows = g[x0] * (1 - fx)[:, None] + g[x1] * fx[:, None]
    return rows[:, x0] * (1 - fx)[None, :] + rows[:, x1] * fx[None, :]


def _noise_texture(rng, T: int = 512, octaves=(4, 8, 16, 32, 64, 128),
                   amp_decay: float = 0.55) -> np.ndarray:
    img = np.zeros((T, T), np.float32)
    amp = 1.0
    for o in octaves:
        img += amp * _upsample_bilinear(rng.standard_normal((o, o)).astype(np.float32), T)
        amp *= amp_decay
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-9)
    return 0.1 + 0.85 * img


CLASS_BACKGROUND, CLASS_SKY, CLASS_PERSON = 0, 10, 11


class TexturedRoom:
    """Noise-textured planes, a featureless "sky" ceiling and upright
    occluder quads (one "person" per segment), rendered per pixel by
    ray-plane intersection with a z-buffer and an exposure gain; the
    port's ``TexturedWorldDataset`` world at one segment."""

    def __init__(self, spec: dict, cameras: List[Camera], seed: int, device):
        self.cameras, self.device = cameras, device
        self.exposure_amp = float(spec.get("exposure_amp", 0.15))
        self.frame_rate = None  # set by the stream
        segs, L = int(spec["segments"]), float(spec["block_m"])
        n_occ = int(spec["occluders_per_segment"])
        tex_size = int(spec.get("tex_size", 512))
        # the room's box (ceiling y0 to floor y1, front z0 to back z1) and
        # the occluders' centres; the defaults are the port's room
        y0, y1 = spec.get("room_y", (-6.0, 6.0))
        z0, z1 = spec.get("room_z", (-4.0, 12.0))
        oy, oz = spec.get("occluder_y", (-3.0, 3.0)), spec.get("occluder_z", (4.0, 8.0))
        H, D = y1 - y0, z1 - z0
        rng = np.random.default_rng(seed + 7)
        bg = CLASS_BACKGROUND
        x_end = -6.0 + L * segs
        planes = [
            ([-6, y0, z1], [L, 0, 0], [0, H, 0], bg),  # back wall
            ([-6, y0, z0], [0, H, 0], [L, 0, 0], bg),  # front wall
            ([-6, y0, z0], [0, 0, D], [0, H, 0], bg),  # left wall x=-6
            ([x_end, y0, z0], [0, H, 0], [0, 0, D], bg),  # right wall at the room's end
            ([-6, y1, z0], [L, 0, 0], [0, 0, D], bg),  # floor
            ([-6, y0, z0], [0, 0, D], [L, 0, 0], CLASS_SKY),  # ceiling
        ]

        def occluders(x0):
            out = []
            for k in range(n_occ):
                c = np.array([x0 + rng.uniform(-3, 6), rng.uniform(*oy), rng.uniform(*oz)])
                w, h = rng.uniform(0.8, 2.0), rng.uniform(1.2, 2.6)
                ang = rng.uniform(0, 2 * np.pi)
                u = np.array([np.cos(ang), np.sin(ang), 0.0]) * w
                v = np.array([0.0, 1.0, 0.0]) * h
                out.append((c - u / 2 - v / 2, u, v, CLASS_PERSON if k == 0 else bg))
            return out

        planes += occluders(0.0)
        for s in range(1, segs):
            x0 = -6.0 + L * s
            planes += [
                ([x0, y0, z1], [L, 0, 0], [0, H, 0], bg),
                ([x0, y0, z0], [0, H, 0], [L, 0, 0], bg),
                ([x0, y1, z0], [L, 0, 0], [0, 0, D], bg),
                ([x0, y0, z0], [0, 0, D], [L, 0, 0], CLASS_SKY),
            ]
            planes += occluders(L * s)
        self.plane_class = np.asarray([p[3] for p in planes], np.int32)
        P = len(planes)
        tex = np.stack([_noise_texture(rng, tex_size) for _ in range(P)])
        g = np.linspace(0.92, 1.0, tex_size, dtype=np.float32)
        sky = np.broadcast_to(g[:, None], (tex_size, tex_size)).copy()
        for i, p in enumerate(planes):
            if p[3] == CLASS_SKY:
                tex[i] = sky
            elif p[3] == CLASS_PERSON:
                tex[i] = 0.12 + 0.25 * tex[i]
        f32 = dict(dtype=torch.float32, device=device)
        self._planes = [torch.as_tensor(np.asarray([p[i] for p in planes], np.float32), **f32)
                        for i in range(3)] + [torch.as_tensor(tex, **f32)]
        self._rays = [torch.as_tensor(c.rays(), **f32) for c in cameras]
        self._T_SC7 = [torch.as_tensor(c.T_SC7, **f32) for c in cameras]

    def gain(self, frame_index: int) -> float:
        return float(1.0 + self.exposure_amp * np.sin(0.9 * frame_index / self.frame_rate + 0.7))

    def render(self, T_WS7: np.ndarray, frame_index: int):
        gain = torch.tensor(self.gain(frame_index), dtype=torch.float32, device=self.device)
        T7 = torch.as_tensor(np.asarray(T_WS7, np.float32), device=self.device)
        images, labels = [], []
        for ci, cam in enumerate(self.cameras):
            img, lab = render_textured(self._rays[ci], T7, self._T_SC7[ci], *self._planes, gain)
            lab = lab.reshape(cam.height, cam.width).to(torch.int32).cpu().numpy()
            images.append(img.reshape(cam.height, cam.width).cpu().numpy())
            labels.append(np.where(lab >= 0, self.plane_class[np.maximum(lab, 0)], -1))
        return images, labels


def _quat_to_matrix_t(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def render_textured(cam_rays, T_WS7, T_SC7, p0, eu, ev, tex, gain):
    """One camera's image of the planes (the port's ``render_textured``)."""
    R_WS = _quat_to_matrix_t(T_WS7[3:7])
    R_WC = R_WS @ _quat_to_matrix_t(T_SC7[3:7])
    o_W = T_WS7[:3] + R_WS @ T_SC7[:3]
    d = cam_rays @ R_WC.T
    n = torch.linalg.cross(eu, ev)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    denom = d @ n.T
    tnum = torch.sum((p0 - o_W[None, :]) * n, dim=-1)
    tt = tnum[None, :] / torch.where(denom.abs() < 1e-9, torch.full_like(denom, torch.inf),
                                     denom)
    X = o_W[None, None, :] + tt[..., None] * d[:, None, :]
    rel = X - p0[None, :, :]
    uu = torch.sum(rel * eu[None], -1) / torch.sum(eu * eu, -1)[None]
    vv = torch.sum(rel * ev[None], -1) / torch.sum(ev * ev, -1)[None]
    ok = (tt > 0.2) & (uu >= 0) & (uu <= 1) & (vv >= 0) & (vv <= 1)
    tt = torch.where(ok, tt, torch.full_like(tt, 1e9))
    k = torch.argmin(tt, dim=1)
    ar = torch.arange(tt.shape[0], device=tt.device)
    hit = tt[ar, k] < 1e8
    Tsz = tex.shape[1]
    px = uu[ar, k].clamp(0, 1) * (Tsz - 1)
    py = vv[ar, k].clamp(0, 1) * (Tsz - 1)
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    x1 = torch.clamp(x0 + 1, max=Tsz - 1)
    y1 = torch.clamp(y0 + 1, max=Tsz - 1)
    fx, fy = px - x0, py - y0
    val = (tex[k, y0, x0] * (1 - fx) * (1 - fy) + tex[k, y0, x1] * fx * (1 - fy)
           + tex[k, y1, x0] * (1 - fx) * fy + tex[k, y1, x1] * fx * fy)
    img = torch.where(hit, val, torch.zeros_like(val))
    return torch.clamp(img * gain, 0.0, 1.0), torch.where(hit, k, torch.full_like(k, -1))


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

class Stream:
    """Frames of a traffic file for one configuration's rig and a seed.

    The world is drawn from the traffic's ``world_seed`` where it names one
    (the same scene, and so the same work per frame, in every run), else
    from ``seed``; with ``imu_noise`` the IMU samples carry white noise at
    the rig's ``sigma_g_c`` / ``sigma_a_c`` densities, drawn from ``seed``.

    ``frame(i)`` -> (t, images [float32 HxW in [0, 1]], ground-truth pose
    [7], class maps or None); ``imu_until(t)`` -> the IMU samples (t, accel,
    gyro) at ``imu_rate`` up to t, each once, in order. Frames come at
    ``frame_rate`` from t = 0, as the port's datasets stream them."""

    def __init__(self, traffic: dict, rig: dict, seed: int, device="cpu"):
        self.cameras = [Camera(c) for c in rig["cameras"]]
        self.g = float(rig["imu"]["g"])
        self.frame_rate = float(traffic["frame_rate"])
        self.imu_rate = float(traffic["imu_rate"])
        self.trajectory = Trajectory(traffic["trajectory"])
        world = traffic["world"]
        world_seed = int(traffic.get("world_seed", seed))
        if world["kind"] == "stars":
            self.world = StarField(world, self.cameras, world_seed)
        elif world["kind"] == "textured":
            self.world = TexturedRoom(world, self.cameras, world_seed, device)
            self.world.frame_rate = self.frame_rate
        else:
            raise ValueError(f"unknown world {world['kind']!r}")
        self._imu_next = 0
        self._imu_sigma = None
        if traffic.get("imu_noise", False):
            # white noise at the configuration's continuous-time densities
            root = math.sqrt(self.imu_rate)
            imu = rig["imu"]
            self._imu_sigma = (float(imu["sigma_g_c"]) * root, float(imu["sigma_a_c"]) * root)
            self._imu_rng = np.random.default_rng([abs(int(seed)), 1])

    def frame(self, i: int):
        t = i / self.frame_rate
        pose = self.trajectory.pose(t)
        images, labels = self.world.render(pose, i)
        return t, images, pose, labels

    def imu_until(self, t: float):
        out = []
        dt = 1.0 / self.imu_rate
        while self._imu_next * dt <= t + 1e-9:
            ti = self._imu_next * dt
            w, a = self.trajectory.imu(ti, self.g)
            if self._imu_sigma is not None:
                w = w + self._imu_rng.normal(0.0, self._imu_sigma[0], 3)
                a = a + self._imu_rng.normal(0.0, self._imu_sigma[1], 3)
            out.append((ti, a, w))
            self._imu_next += 1
        return out

    def events(self, n_frames: int) -> Iterator[tuple]:
        """("imu", t, accel, gyro) and ("images", t, images, pose) events."""
        for i in range(n_frames):
            t, images, pose, _ = self.frame(i)
            for ev in self.imu_until(t):
                yield ("imu",) + ev
            yield ("images", t, images, pose)
