"""Synthetic datasets: deterministic worlds along an analytic trajectory,
with exact IMU.

Port of ``okvis2_tpu/pipeline/dataset.py::SyntheticDataset`` and
``TexturedWorldDataset`` (the default and the circle trajectory). Each
world is drawn with the same numpy ``default_rng`` calls in the same order
as the JAX package, so one seed gives one world.

- ``SyntheticDataset``: a field of small textured squares ("stars"). Each
  frame projects the stars into every camera with the port's
  ``Transformation`` and ``PinholeCamera`` on the device, then paints them
  in numpy.
- ``TexturedWorldDataset``: a room of noise-textured planes with a
  featureless "sky" ceiling and floating occluder quads, one of them a
  dark "person", rendered on the device per pixel by ray-plane
  intersection with a z-buffer, bilinear texture sampling and a per-frame
  exposure gain; ``render_with_labels`` also gives the per-pixel class map
  (cityscapes ids, as the CNN gate reads them).

Trajectory and IMU come from ``utils/synthetic.true_state`` / ``imu_at``,
or from ``utils/synthetic.CircleTrajectory`` with one circle per
``duration``.

Dataset folders (the rest of the JAX module):

- ``EurocDatasetReader``: the EuRoC/ASL folder format
  (``mav0/cam{i}/data.csv`` + ``data/``, ``mav0/imu0/data.csv``; the
  reference's DatasetReader, okvis_multisensor_processing/src/
  DatasetReader.cpp), streamed as ``('imu', t, acc, gyr)`` and
  ``('images', t, [img...])`` events in time order, cam0 the master of the
  camera sync; ``start_streaming`` feeds callbacks from a thread.
- ``RpgDatasetReader``: the UZH-RPG format (``images.txt``, ``imu.txt``,
  optionally ``left_images.txt`` / ``right_images.txt``).
- ``DatasetWriter``: records a stream into an EuRoC folder
  (DatasetWriter.cpp); its CSVs are the JAX writer's byte for byte.

Images are read and written by the port's PNG codec (``pipeline/png.py``),
float32 in [0, 1] on the way in, ``clip(img * 255)`` truncated to uint8 on
the way out, as the JAX package does through OpenCV.
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from okvis2_torch import resolve_device
from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.pipeline import png
from okvis2_torch.utils import synthetic


class SyntheticDataset:
    """Renders every camera of a rig along the canonical test trajectory
    (``trajectory="default"``) or one circle (``"circle"``).

    ``cameras``/``extrinsics``: PinholeCamera and Transformation per
    camera; ``imu_params``: ImuParameters. Runs on ``device`` (None: the
    CUDA card; raises without one)."""

    def __init__(self, cameras, extrinsics, imu_params, n_stars: int = 3000,
                 duration: float = 10.0, frame_rate: float = 10.0, imu_rate: float = 200.0,
                 seed: int = 0, imu_noise: float = 0.0, trajectory: str = "default",
                 device=None):
        if trajectory not in ("default", "circle"):
            raise ValueError(f"trajectory {trajectory!r}")
        self.device = resolve_device(device)
        self.syn = synthetic.CircleTrajectory(duration) if trajectory == "circle" else synthetic
        self.cameras = cameras
        self.extrinsics = extrinsics
        self.imu_params = imu_params
        self.duration = duration
        self.frame_rate = frame_rate
        self.imu_rate = imu_rate
        self.imu_noise = imu_noise
        rng = np.random.default_rng(seed)
        # stars distributed in a shell in front of/around the trajectory
        self.stars = np.concatenate([
            rng.uniform(-6, 10, (n_stars, 1)),
            rng.uniform(-6, 6, (n_stars, 1)),
            rng.uniform(2.0, 12.0, (n_stars, 1)),
        ], axis=-1)
        self.star_intensity = rng.uniform(0.25, 1.0, n_stars)
        self.star_size = rng.integers(3, 6, n_stars)
        # a random texture patch per star keeps binary descriptors
        # discriminative (constant squares alias heavily)
        self.star_pattern = rng.uniform(0.3, 1.0, (n_stars, 6, 6))
        dtype = cameras[0].focal.dtype
        self._stars_dev = torch.as_tensor(self.stars, dtype=dtype, device=self.device)
        self._T_SC = [Transformation(r=T.r.to(self.device, dtype), q=T.q.to(self.device, dtype))
                      for T in extrinsics]

    def _project(self, cam, T_WS7: np.ndarray, T_SC: Transformation):
        T7 = torch.as_tensor(np.asarray(T_WS7), dtype=self._stars_dev.dtype, device=self.device)
        T_CW = (Transformation(r=T7[:3], q=T7[3:7]) @ T_SC).inverse()
        p_C = T_CW.apply(self._stars_dev)
        uv, valid = cam.project(p_C)
        return uv.cpu().numpy(), (valid & (p_C[:, 2] > 0.2)).cpu().numpy()

    def render(self, T_WS) -> List[np.ndarray]:
        """Render all cameras at body pose T_WS (numpy [7]) -> float32
        images [H,W] in [0,1]."""
        out = []
        for cam, T_SC in zip(self.cameras, self._T_SC):
            uv, valid = self._project(cam, T_WS, T_SC)
            img = np.zeros((cam.height, cam.width), np.float32)
            for k in np.nonzero(valid)[0]:
                x, y = uv[k]
                s = int(self.star_size[k])
                x0, y0 = int(round(x)) - s // 2, int(round(y)) - s // 2
                x1, y1 = x0 + s, y0 + s
                x0c, y0c = max(x0, 0), max(y0, 0)
                x1c, y1c = min(x1, cam.width), min(y1, cam.height)
                if x1c > x0c and y1c > y0c:
                    patch = (self.star_intensity[k]
                             * self.star_pattern[k][: y1c - y0c, : x1c - x0c])
                    img[y0c:y1c, x0c:x1c] = np.maximum(img[y0c:y1c, x0c:x1c],
                                                       patch.astype(np.float32))
            out.append(img)
        return out

    def stream(self) -> Iterator[tuple]:
        """Yield ("imu", t, accel, gyro) and ("images", t, [img...], pose7)
        events in time order."""
        rng = np.random.default_rng(123)
        n_frames = int(self.duration * self.frame_rate)
        imu_dt = 1.0 / self.imu_rate
        n_imu = int(np.ceil((n_frames - 1) / self.frame_rate / imu_dt)) + 2
        ts_imu = np.arange(n_imu) * imu_dt
        w_all, a_all = vmap(lambda tt: self.syn.imu_at(tt, self.imu_params))(
            torch.as_tensor(ts_imu, dtype=torch.float64, device=self.imu_params.g.device))
        w_all, a_all = w_all.cpu().numpy(), a_all.cpu().numpy()
        ts_frame = np.arange(n_frames) / self.frame_rate
        if self.imu_noise > 0:
            w_all = w_all + rng.normal(0, self.imu_noise * 1e-2, w_all.shape)
            a_all = a_all + rng.normal(0, self.imu_noise * 1e-1, a_all.shape)

        ii = 0
        for fi in range(n_frames):
            t = ts_frame[fi]
            while ii < n_imu and ts_imu[ii] <= t + 1e-9:
                yield ("imu", ts_imu[ii], a_all[ii], w_all[ii])
                ii += 1
            pose = self.ground_truth(t)
            yield ("images", t, self.render(pose), pose)

    def ground_truth(self, t: float) -> np.ndarray:
        T_gt, _ = self.syn.true_state(t, device=self.device)
        return torch.cat([T_gt.r, T_gt.q]).cpu().numpy()


def _upsample_bilinear(g: np.ndarray, T: int) -> np.ndarray:
    """Separable bilinear upsample of a square grid to T x T (numpy)."""
    o = g.shape[0]
    x = np.linspace(0.0, o - 1.0, T)
    x0 = np.floor(x).astype(int)
    x1 = np.minimum(x0 + 1, o - 1)
    fx = (x - x0).astype(np.float32)
    rows = g[x0] * (1 - fx)[:, None] + g[x1] * fx[:, None]
    return rows[:, x0] * (1 - fx)[None, :] + rows[:, x1] * fx[None, :]


def _noise_texture(rng, T: int = 512, octaves=(4, 8, 16, 32, 64, 128),
                   amp_decay: float = 0.55) -> np.ndarray:
    """Multi-octave value-noise texture in [0.1, 0.95]: features from
    coarse blobs down to fine grain."""
    img = np.zeros((T, T), np.float32)
    amp = 1.0
    for o in octaves:
        img += amp * _upsample_bilinear(rng.standard_normal((o, o)).astype(np.float32), T)
        amp *= amp_decay
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-9)
    return 0.1 + 0.85 * img


def render_textured(cam_rays, T_WS7, T_SC7, p0, eu, ev, tex, gain):
    """One camera's image of the planes: ``cam_rays`` [HW,3] unit rays in
    the camera frame, poses [7], planes (corner ``p0``, edges ``eu``,
    ``ev``: [P,3]), textures [P,T,T], exposure ``gain`` (0-d). Returns
    (image [HW] in [0,1], the index of the plane hit [HW], -1 for none)."""
    R_WS = so3.quat_to_matrix(T_WS7[3:7])
    R_WC = R_WS @ so3.quat_to_matrix(T_SC7[3:7])
    o_W = T_WS7[:3] + R_WS @ T_SC7[:3]
    d = cam_rays @ R_WC.T  # [HW,3]
    n = torch.linalg.cross(eu, ev)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)  # [P,3]
    denom = d @ n.T  # [HW,P]
    tnum = torch.sum((p0 - o_W[None, :]) * n, dim=-1)  # [P]
    tt = tnum[None, :] / torch.where(denom.abs() < 1e-9, torch.full_like(denom, torch.inf),
                                     denom)
    X = o_W[None, None, :] + tt[..., None] * d[:, None, :]
    rel = X - p0[None, :, :]
    uu = torch.sum(rel * eu[None], -1) / torch.sum(eu * eu, -1)[None]
    vv = torch.sum(rel * ev[None], -1) / torch.sum(ev * ev, -1)[None]
    ok = (tt > 0.2) & (uu >= 0) & (uu <= 1) & (vv >= 0) & (vv <= 1)
    tt = torch.where(ok, tt, torch.full_like(tt, 1e9))
    k = torch.argmin(tt, dim=1)  # [HW] z-buffer, first nearest
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


class TexturedWorldDataset(SyntheticDataset):
    """A room of noise-textured planes plus floating occluder quads,
    rendered by ray-plane intersection with a z-buffer (true occlusion) and
    a per-frame exposure gain (auto-exposure or lighting change), in
    float32 on the dataset's device. ``render_with_labels`` also returns
    the per-pixel class map: -1 no hit, 0 background, 10 the "sky"
    ceiling, 11 the "person" occluder (the cityscapes ids of the reference's
    fast-scnn gate, okvis_cv/src/Frame.cpp:46-147)."""

    CLASS_BACKGROUND, CLASS_SKY, CLASS_PERSON = 0, 10, 11

    def __init__(self, cameras, extrinsics, imu_params, duration: float = 10.0,
                 frame_rate: float = 10.0, imu_rate: float = 200.0, seed: int = 0,
                 imu_noise: float = 0.0, trajectory: str = "default", tex_size: int = 512,
                 exposure_amp: float = 0.15, sky_ceiling: bool = True, n_occluders: int = 3,
                 device=None):
        super().__init__(cameras, extrinsics, imu_params, n_stars=1, duration=duration,
                         frame_rate=frame_rate, imu_rate=imu_rate, seed=seed,
                         imu_noise=imu_noise, trajectory=trajectory, device=device)
        rng = np.random.default_rng(seed + 7)
        self.exposure_amp = exposure_amp
        # the room encloses the canonical trajectories (the stars' box
        # x[-6,10], y[-6,6], z[2,12]): 5 walls, a ceiling, occluders
        bg = self.CLASS_BACKGROUND
        planes = [
            ([-6, -6, 12], [16, 0, 0], [0, 12, 0], bg),  # back wall z=12
            ([-6, -6, -4], [0, 12, 0], [16, 0, 0], bg),  # front wall z=-4
            ([-6, -6, -4], [0, 0, 16], [0, 12, 0], bg),  # left wall x=-6
            ([10, -6, -4], [0, 12, 0], [0, 0, 16], bg),  # right wall x=10
            ([-6, 6, -4], [16, 0, 0], [0, 0, 16], bg),  # floor y=+6
            ([-6, -6, -4], [0, 0, 16], [16, 0, 0],
             self.CLASS_SKY if sky_ceiling else bg),  # ceiling y=-6
        ]
        for k in range(n_occluders):
            c = np.array([rng.uniform(-3, 6), rng.uniform(-3, 3), rng.uniform(4.0, 8.0)])
            w, h = rng.uniform(0.8, 2.0), rng.uniform(1.2, 2.6)
            ang = rng.uniform(0, 2 * np.pi)
            u = np.array([np.cos(ang), np.sin(ang), 0.0]) * w
            v = np.array([0.0, 1.0, 0.0]) * h  # upright quad
            planes.append((c - u / 2 - v / 2, u, v, self.CLASS_PERSON if k == 0 else bg))
        self.plane_p0, self.plane_eu, self.plane_ev = (
            np.asarray([p[i] for p in planes], np.float32) for i in range(3))
        self.plane_class = np.asarray([p[3] for p in planes], np.int32)
        P = len(planes)
        self.textures = np.stack([_noise_texture(rng, tex_size) for _ in range(P)])
        if sky_ceiling:
            # featureless bright "sky": a faint vertical gradient only
            g = np.linspace(0.92, 1.0, tex_size, dtype=np.float32)
            self.textures[5] = np.broadcast_to(g[:, None], (tex_size, tex_size)).copy()
        # darker "person" occluder (class contrast for the CNN)
        self.textures[6 % P] = 0.12 + 0.25 * self.textures[6 % P]
        f32 = dict(dtype=torch.float32, device=self.device)
        self._planes_dev = [torch.as_tensor(a, **f32) for a in
                            (self.plane_p0, self.plane_eu, self.plane_ev, self.textures)]
        self._T_SC7 = [torch.cat([T.r, T.q]).to(**f32) for T in self._T_SC]
        self._rays = {}
        self._frame_i = 0

    def _cam_rays(self, ci: int) -> torch.Tensor:
        """Unit rays through the pixel centres of camera ``ci`` [HW,3]
        (float32), back-projected in the camera's dtype."""
        if ci not in self._rays:
            cam = self.cameras[ci]
            u, v = np.meshgrid(np.arange(cam.width, dtype=np.float32) + 0.5,
                               np.arange(cam.height, dtype=np.float32) + 0.5)
            uv = torch.as_tensor(np.stack([u.ravel(), v.ravel()], -1), dtype=cam.focal.dtype,
                                 device=self.device)
            self._rays[ci] = cam.back_project(uv).to(torch.float32)
        return self._rays[ci]

    def _gain_at(self, t: float) -> float:
        return float(1.0 + self.exposure_amp * np.sin(0.9 * t + 0.7))

    def _render_all(self, T_WS):
        """[(image [H,W] float32, plane index [H,W] int32)] per camera; the
        exposure gain follows the frame clock (one tick per call)."""
        i = self._frame_i
        self._frame_i = i + 1
        gain = torch.tensor(self._gain_at(i / self.frame_rate), dtype=torch.float32,
                            device=self.device)
        T7 = torch.as_tensor(np.asarray(T_WS, np.float32), device=self.device)
        out = []
        for ci, cam in enumerate(self.cameras):
            img, lab = render_textured(self._cam_rays(ci), T7, self._T_SC7[ci],
                                       *self._planes_dev, gain)
            out.append((img.reshape(cam.height, cam.width).cpu().numpy(),
                        lab.reshape(cam.height, cam.width).to(torch.int32).cpu().numpy()))
        return out

    def render(self, T_WS) -> List[np.ndarray]:
        return [im for im, _ in self._render_all(T_WS)]

    def render_with_labels(self, T_WS):
        """[(image [H,W] float32, class map [H,W] int32)] per camera."""
        return [(im, np.where(lab >= 0, self.plane_class[np.maximum(lab, 0)], -1))
                for im, lab in self._render_all(T_WS)]

    def stream(self) -> Iterator[tuple]:
        self._frame_i = 0  # the exposure follows the frame clock
        yield from super().stream()


def load_image(fn: str) -> np.ndarray:
    """A dataset image as float32 [H, W] in [0, 1]."""
    return png.read_png(fn).astype(np.float32) / 255.0


def _load_images(fns) -> List[np.ndarray]:
    return [load_image(f) for f in fns]


def _imu_events(imu, frames, load_frame=_load_images) -> Iterator[tuple]:
    """Merge IMU rows and synced frames into one time-ordered stream: the
    IMU up to 5 ms past each frame goes before it (DatasetReader's
    look-ahead). ``load_frame`` turns a frame's image paths into its
    images."""
    ii = 0
    for t, fns in frames:
        while ii < len(imu) and imu[ii][0] <= t + 0.005:
            yield ("imu", imu[ii][0], imu[ii][1], imu[ii][2])
            ii += 1
        yield ("images", t, load_frame(fns))
    while ii < len(imu):
        yield ("imu", imu[ii][0], imu[ii][1], imu[ii][2])
        ii += 1


class EurocDatasetReader:
    """EuRoC/ASL folder reader: ``<path>/mav0/cam{i}/data.csv`` + ``data/``,
    ``<path>/mav0/imu0/data.csv``."""

    def __init__(self, path: str, num_cameras: int = 2):
        self.path = path
        self.num_cameras = num_cameras
        self.imu_callback: Optional[Callable] = None
        self.images_callback: Optional[Callable] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def set_imu_callback(self, cb: Callable):
        self.imu_callback = cb

    def set_images_callback(self, cb: Callable):
        self.images_callback = cb

    def _read_imu(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        rows = []
        with open(os.path.join(self.path, "mav0", "imu0", "data.csv")) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                gyr = np.asarray([float(x) for x in row[1:4]])
                acc = np.asarray([float(x) for x in row[4:7]])
                rows.append((int(row[0]) * 1e-9, acc, gyr))
        return rows

    def _read_cam_index(self, ci: int) -> List[Tuple[float, str]]:
        rows = []
        with open(os.path.join(self.path, "mav0", f"cam{ci}", "data.csv")) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                rows.append((int(row[0]) * 1e-9,
                             os.path.join(self.path, "mav0", f"cam{ci}", "data", row[1].strip())))
        return rows

    def stream(self, sync_tolerance: float = 0.005) -> Iterator[tuple]:
        """Yield ('imu', t, acc, gyr) and ('images', t, [img...]) events in
        time order; each cam0 frame is synced with the other cameras'
        nearest frames within ``sync_tolerance`` (DatasetReader's sync
        groups) and dropped when one has none."""
        return _imu_events(self._read_imu(), self.synced_frames(sync_tolerance))

    def synced_frames(self, sync_tolerance: float = 0.005) -> List[Tuple[float, List[str]]]:
        """[(t, [image path per camera])] of the frames ``stream`` yields."""
        cams = [self._read_cam_index(ci) for ci in range(self.num_cameras)]
        frames = []
        ptrs = [0] * self.num_cameras
        for t0, fn0 in cams[0]:
            fns = [fn0]
            for ci in range(1, self.num_cameras):
                while (ptrs[ci] + 1 < len(cams[ci])
                       and cams[ci][ptrs[ci] + 1][0] <= t0 + sync_tolerance):
                    ptrs[ci] += 1
                tc, fnc = cams[ci][ptrs[ci]]
                if abs(tc - t0) > sync_tolerance:
                    break
                fns.append(fnc)
            else:
                frames.append((t0, fns))
        return frames

    def start_streaming(self):
        """Feed the callbacks from a thread of their own."""
        def run():
            for ev in self.stream():
                if self._stop.is_set():
                    break
                if ev[0] == "imu" and self.imu_callback:
                    self.imu_callback(ev[1], ev[2], ev[3])
                elif ev[0] == "images" and self.images_callback:
                    self.images_callback(ev[1], ev[2])

        self._stop.clear()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop_streaming(self):
        self._stop.set()
        if self._thread:
            self._thread.join()


class RpgDatasetReader:
    """UZH-RPG format reader (the reference's RpgDatasetReader,
    okvis_multisensor_processing/src/RpgDatasetReader.cpp): ``images.txt``
    (id t path), ``imu.txt`` (id t wx wy wz ax ay az), and for stereo
    ``left_images.txt`` / ``right_images.txt``."""

    def __init__(self, path: str, num_cameras: int = 1):
        self.path = path
        self.num_cameras = num_cameras

    def _read_images_index(self, fn):
        out = []
        with open(os.path.join(self.path, fn)) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                out.append((float(parts[1]), os.path.join(self.path, parts[2])))
        return out

    def _read_imu(self):
        out = []
        with open(os.path.join(self.path, "imu.txt")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                p = [float(x) for x in line.split()]
                out.append((p[1], np.asarray(p[5:8]), np.asarray(p[2:5])))
        return out

    def stream(self, sync_tolerance: float = 0.005) -> Iterator[tuple]:
        """The same events as ``EurocDatasetReader.stream``; stereo frames
        pair the left and right lists in order, kept when their times are
        within ``sync_tolerance``."""
        if self.num_cameras >= 2 and os.path.exists(os.path.join(self.path, "left_images.txt")):
            left = self._read_images_index("left_images.txt")
            right = self._read_images_index("right_images.txt")
            frames = [(tl, [fl, fr]) for (tl, fl), (tr, fr) in zip(left, right)
                      if abs(tl - tr) <= sync_tolerance]
        else:
            frames = [(t, [f]) for t, f in self._read_images_index("images.txt")]
        return _imu_events(self._read_imu(), frames)


class DatasetWriter:
    """Record a live stream into EuRoC folder format (the reference's
    DatasetWriter, okvis_multisensor_processing/src/DatasetWriter.cpp). Fed
    by the same ``add_images`` / ``add_imu_measurement`` calls as
    ``SlamSystem``; float images in [0, 1] are stored as
    ``clip(img * 255)`` truncated to uint8. ``close()`` ends the CSVs."""

    def __init__(self, path: str, num_cameras: int = 2):
        self.path = path
        self.num_cameras = num_cameras
        for c in range(num_cameras):
            os.makedirs(os.path.join(path, "mav0", f"cam{c}", "data"), exist_ok=True)
        os.makedirs(os.path.join(path, "mav0", "imu0"), exist_ok=True)
        self._imu_f = open(os.path.join(path, "mav0", "imu0", "data.csv"), "w")
        self._imu_f.write("#timestamp,w_x,w_y,w_z,a_x,a_y,a_z\n")
        self._cam_f = []
        for c in range(num_cameras):
            f = open(os.path.join(path, "mav0", f"cam{c}", "data.csv"), "w")
            f.write("#timestamp [ns],filename\n")
            self._cam_f.append(f)

    def add_imu_measurement(self, t: float, accel, gyro) -> bool:
        g = np.asarray(gyro)
        a = np.asarray(accel)
        self._imu_f.write(f"{int(round(t * 1e9))},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                          f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}\n")
        return True

    def add_images(self, t: float, images) -> bool:
        ts = int(round(t * 1e9))
        for c, img in enumerate(images):
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            name = f"{ts}.png"
            png.write_png(os.path.join(self.path, "mav0", f"cam{c}", "data", name), img)
            self._cam_f[c].write(f"{ts},{name}\n")
        return True

    def close(self):
        self._imu_f.close()
        for f in self._cam_f:
            f.close()
