"""The benchmark's frozen generator against the port's, at a small size and
one seed."""

import math
import os

import numpy as np
import pytest
import torch

from slambench import generator, system
from slambench.generator import Stream, Trajectory, load_json

SEED = 3


def _port_rig(name, scale):
    from okvis2_torch.config import read_config_file

    cfg = load_json("configs", name)
    params = read_config_file(os.path.join(generator.HERE, "configs", cfg["yaml"]), dtype=torch.float64,
                              device="cpu")
    cams = tuple(system._scaled(c, scale) for c in params.camera_tuple)
    return cfg, cams, params


def _traj(kind):
    if kind == "default":
        return load_json("traffic", "flight")["trajectory"]
    # the port's CircleTrajectory(2.5): radius 1.5 m, a 0.05 m heave at twice
    # the rate, 0.15 rad about y
    w = 2 * math.pi / 2.5
    return {"position": [{"sines": [[1.5, w, 0.0]]},
                         {"c": 1.5, "sines": [[1.5, w, -math.pi / 2]]},
                         {"sines": [[0.05, 2 * w, 0.0]]}],
            "rotation": {"axis": [0.0, 1.0, 0.0], "sines": [[0.15, w, 0.0]]}}


def _exact(traffic):
    """The traffic with the world drawn from the run's seed and no IMU
    noise, as the port's datasets make it."""
    traffic.pop("world_seed", None)
    traffic["imu_noise"] = False
    return traffic


@pytest.mark.parametrize("kind", ["default", "circle"])
def test_trajectory_and_imu_equal_the_ports(kind):
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.utils import synthetic

    port = synthetic if kind == "default" else synthetic.CircleTrajectory(2.5)
    ours = Trajectory(_traj(kind))
    params = ImuParameters.create(g=9.81007, device="cpu")
    for t in (0.0, 0.35, 1.7, 4.05):
        T, v = port.true_state(t, device="cpu")
        np.testing.assert_allclose(ours.pose(t), torch.cat([T.r, T.q]).numpy(), atol=1e-12)
        np.testing.assert_allclose(ours.velocity(t), v.numpy(), atol=1e-12)
        w, a = port.imu_at(torch.tensor(t, dtype=torch.float64), params)
        gyr, acc = ours.imu(t, 9.81007)
        np.testing.assert_allclose(gyr, w.numpy(), atol=1e-12)
        np.testing.assert_allclose(acc, a.numpy(), atol=1e-10)


def test_star_field_equals_the_ports_synthetic_dataset():
    from okvis2_torch.pipeline.dataset import SyntheticDataset

    cfg, cams, params = _port_rig("euroc", 0.25)
    traffic = _exact(load_json("traffic", "flight"))
    traffic["world"]["blocks"] = 1
    rig = system.scaled_rig(cfg["rig"], 0.25)
    ours = Stream(traffic, rig, SEED)
    port = SyntheticDataset(cams, params.extrinsics_list, params.imu.params, n_stars=2500,
                            duration=0.3, frame_rate=20.0, seed=SEED, device="cpu")
    np.testing.assert_array_equal(ours.world.stars, port.stars)
    events = list(port.stream())
    mine = list(ours.events(6))
    assert [e[0] for e in mine] == [e[0] for e in events]
    for a, b in zip(mine, events):
        assert a[1] == pytest.approx(b[1], abs=1e-12)
        if a[0] == "imu":
            np.testing.assert_allclose(a[2], b[2], atol=1e-10)
            np.testing.assert_allclose(a[3], b[3], atol=1e-12)
        else:
            np.testing.assert_allclose(a[3], b[3], atol=1e-12)
            for x, y in zip(a[2], b[2]):
                np.testing.assert_array_equal(x, y)


def test_textured_room_equals_the_ports_textured_world():
    from okvis2_torch.pipeline.dataset import TexturedWorldDataset

    cfg, cams, params = _port_rig("d455", 0.2)
    traffic = _exact(load_json("traffic", "walk"))
    traffic["world"] = {"kind": "textured", "segments": 1, "block_m": 16.0,
                        "occluders_per_segment": 3, "exposure_amp": 0.15}
    traffic["trajectory"] = _traj("default")
    rig = system.scaled_rig(cfg["rig"], 0.2)
    ours = Stream(traffic, rig, SEED)
    port = TexturedWorldDataset(cams, params.extrinsics_list, params.imu.params, duration=0.2,
                                frame_rate=20.0, seed=SEED, device="cpu")
    labels = []
    render = port.render_with_labels

    def keep(T):
        pairs = render(T)
        labels.append([lab for _, lab in pairs])
        return [im for im, _ in pairs]

    port.render = keep
    frames = [e for e in port.stream() if e[0] == "images"]
    for i, e in enumerate(frames):
        _t, images, _pose, lab = ours.frame(i)
        for x, y in zip(images, e[2]):
            assert np.mean(np.abs(x - y) > 1e-4) < 1e-3
        for x, y in zip(lab, labels[i]):
            assert np.mean(x != y) < 1e-3


def test_extended_worlds_keep_their_density():
    """Each further block of stars is the first block's draw pattern moved
    along x: the same count per block, no star outside its block."""
    cfg = load_json("configs", "euroc")
    traffic = load_json("traffic", "flight")
    s = Stream(traffic, cfg["rig"], SEED).world
    n = traffic["world"]["stars_per_block"]
    for b in range(traffic["world"]["blocks"]):
        x = s.stars[b * n:(b + 1) * n, 0]
        assert x.min() >= -6 + 16 * b and x.max() <= 10 + 16 * b
    walk = load_json("traffic", "walk")
    t_end = 51.0
    assert Trajectory(walk["trajectory"]).position(t_end)[0] < -6 + 16 * walk["world"]["segments"] - 4
    assert Trajectory(traffic["trajectory"]).position(t_end)[0] < 10 + 16 * (traffic["world"]["blocks"] - 1) - 4


def test_rig_in_the_configuration_file_is_the_yamls():
    for name in ("euroc", "d455"):
        cfg, cams, params = _port_rig(name, 1.0)
        for spec, cam, T in zip(cfg["rig"]["cameras"], params.camera_tuple, params.extrinsics_list):
            c = generator.Camera(spec)
            assert (c.width, c.height) == cam.image_size
            np.testing.assert_allclose(c.focal, cam.focal.numpy())
            np.testing.assert_allclose(c.center, cam.center.numpy())
            np.testing.assert_allclose(c.T_SC7[:3], T.r.numpy(), atol=1e-12)
            q = T.q.numpy()
            assert min(np.abs(c.T_SC7[3:] - q).max(), np.abs(c.T_SC7[3:] + q).max()) < 1e-9
        assert cfg["rig"]["imu"]["g"] == pytest.approx(float(params.imu.params.g))
        for k in ("sigma_g_c", "sigma_a_c"):
            assert cfg["rig"]["imu"][k] == pytest.approx(float(getattr(params.imu.params, k)))
        e = params.estimator
        assert cfg["iterations"] == {"max": e.realtime_max_iterations,
                                     "min": e.realtime_min_iterations,
                                     "enforce_realtime": e.enforce_realtime,
                                     "time_limit_s": e.realtime_time_limit}
    assert math.isclose(load_json("traffic", "flight")["frame_rate"], 20.0)


@pytest.mark.parametrize("name", ["flight", "walk"])
def test_seed_draws_the_imu_noise_and_not_the_world(name):
    """Every seed sees the same world; the seed draws the IMU's white noise,
    at the configuration's densities."""
    cfg = load_json("configs", "euroc")
    traffic = load_json("traffic", name)
    traffic["world"] = dict(traffic["world"], **({"segments": 1} if name == "walk" else {"blocks": 1}))
    rig = system.scaled_rig(cfg["rig"], 0.1)
    a, b, a2 = Stream(traffic, rig, 5), Stream(traffic, rig, 6), Stream(traffic, rig, 5)
    for x, y in zip(a.frame(3)[1], b.frame(3)[1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    ia, ib, ia2 = a.imu_until(20.0), b.imu_until(20.0), a2.imu_until(20.0)
    assert len(ia) == len(ib) == 4001
    np.testing.assert_array_equal(np.array([s[1] for s in ia]), np.array([s[1] for s in ia2]))
    exact = Trajectory(traffic["trajectory"])
    rate = traffic["imu_rate"]
    dw = np.array([s[2] - exact.imu(s[0], cfg["rig"]["imu"]["g"])[0] for s in ia])
    da = np.array([s[1] - exact.imu(s[0], cfg["rig"]["imu"]["g"])[1] for s in ia])
    assert np.std(dw) == pytest.approx(cfg["rig"]["imu"]["sigma_g_c"] * math.sqrt(rate), rel=0.05)
    assert np.std(da) == pytest.approx(cfg["rig"]["imu"]["sigma_a_c"] * math.sqrt(rate), rel=0.05)
    assert not np.allclose(np.array([s[1] for s in ia]), np.array([s[1] for s in ib]))
