"""State carried across from the JAX package, as numpy arrays.

What crosses over is the camera rig, the IMU parameters, the preintegrated
IMU segments, the window problem, the tracking state (the landmark
descriptor table), the frontend's and the estimator's configs, the
estimator's host records, and the one learned model's weights (Fast-SCNN,
from the JAX package's flattened Flax checkpoint).
Every converter takes (or gives) the JAX package's own field names, leaf
by leaf as numpy arrays, so both packages can compute on identical inputs.
Nothing here imports JAX: the caller turns the reference's objects into
dicts of ``np.asarray`` leaves.

Dtypes are kept (float64 stays float64); index leaves become ``int64``
(torch's index type) on the way in and ``int32`` (the reference's) on the
way out. ``device=None`` means the CUDA card, as everywhere in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.cameras import distortion as D
from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.frontend.detection import DetectionConfig
from okvis2_torch.graph.estimator import EstimatorConfig
from okvis2_torch.imu.preintegration import ImuParameters, Preintegrated
from okvis2_torch.models.fast_scnn import FastSCNN
from okvis2_torch.pipeline.frontend_pipeline import DeviceLandmarkTable, FrontendConfig
from okvis2_torch.solver.window_problem import WindowProblem

_DISTORTIONS = {
    cls.__name__: cls
    for cls in (D.NoDistortion, D.RadialTangentialDistortion,
                D.RadialTangentialDistortion8, D.EquidistantDistortion)
}
# WindowProblem leaves that index states, cameras or landmarks
_INDEX_FIELDS = ("obs_state", "obs_cam", "obs_lm", "imu_i", "imu_j", "rel_i", "rel_j")
_PRE_FIELDS = tuple(f.name for f in dataclasses.fields(Preintegrated))


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)


def camera_from_numpy(d: dict, device=None) -> PinholeCamera:
    """``{"focal", "center", "image_size", "distortion": class name,
    "k": distortion parameters}`` -> PinholeCamera."""
    dev = resolve_device(device)
    cls = _DISTORTIONS[d["distortion"]]
    dist = cls() if cls is D.NoDistortion else cls(k=_tensor(d["k"], dev))
    w, h = d["image_size"]
    return PinholeCamera(_tensor(d["focal"], dev), _tensor(d["center"], dev),
                         dist, (int(w), int(h)))


def imu_params_from_numpy(d: dict, device=None) -> ImuParameters:
    dev = resolve_device(device)
    return ImuParameters(*(_tensor(d[f.name], dev)
                           for f in dataclasses.fields(ImuParameters)))


def preintegrated_from_numpy(d: dict, device=None) -> Preintegrated:
    dev = resolve_device(device)
    return Preintegrated(*(_tensor(d[f], dev) for f in _PRE_FIELDS))


def problem_from_numpy(fields: dict, device=None) -> WindowProblem:
    """``WindowProblem._FIELDS`` -> numpy arrays (``imu_pre`` a dict of the
    Preintegrated fields) -> WindowProblem."""
    dev = resolve_device(device)
    kw = {}
    for f in WindowProblem._FIELDS:
        v = fields[f]
        if f == "imu_pre":
            kw[f] = preintegrated_from_numpy(v, dev)
        elif f in _INDEX_FIELDS:
            kw[f] = _tensor(np.asarray(v, np.int64), dev)
        else:
            kw[f] = _tensor(v, dev)
    return WindowProblem(**kw)


def problem_to_numpy(problem: WindowProblem) -> dict:
    """WindowProblem -> ``{field: numpy array}`` with the reference's field
    names and index dtype (int32); ``imu_pre`` is a dict."""
    out = {}
    for f in WindowProblem._FIELDS:
        v = getattr(problem, f)
        if f == "imu_pre":
            out[f] = {g: getattr(v, g).detach().cpu().numpy() for g in _PRE_FIELDS}
        elif f in _INDEX_FIELDS:
            out[f] = v.detach().cpu().numpy().astype(np.int32)
        else:
            out[f] = v.detach().cpu().numpy()
    return out


# DeviceLandmarkTable's state: the device table and the host bookkeeping
_TABLE_ARRAYS = ("slot_lid", "ring_next", "last_seen")


def landmark_table_to_numpy(table: DeviceLandmarkTable) -> dict:
    """DeviceLandmarkTable -> ``{"capacity", "n_desc", "signs" [cap,K,B],
    "valid" [cap,K], "slot_lid", "ring_next", "last_seen" [cap], "free"
    (the free-slot stack, in pop order from the end), "tick",
    "num_evictions", "upd" [(slot, ring, cam, kp)], "clear" [slot]}``.
    ``slot_of``/``lid_of`` follow from ``slot_lid``."""
    out = {"capacity": table.capacity, "n_desc": table.n_desc,
           "signs": None if table.signs is None else table.signs.detach().cpu().numpy(),
           "valid": None if table.valid is None else table.valid.detach().cpu().numpy(),
           "free": list(table.free), "tick": table.tick, "num_evictions": table.num_evictions,
           "upd": [tuple(u) for u in table._upd], "clear": list(table._clear)}
    for f in _TABLE_ARRAYS:
        out[f] = np.array(getattr(table, f))
    return out


def landmark_table_from_numpy(d: dict, device=None) -> DeviceLandmarkTable:
    """The inverse of ``landmark_table_to_numpy`` (the JAX package's
    DeviceLandmarkTable has the same attribute names)."""
    table = DeviceLandmarkTable(int(d["capacity"]), int(d["n_desc"]), device=device)
    if d["signs"] is not None:
        table.signs = _tensor(d["signs"], table.device)
        table.valid = _tensor(np.asarray(d["valid"], bool), table.device)
    table.slot_lid = np.array(d["slot_lid"], np.int64)
    table.ring_next = np.array(d["ring_next"], np.int32)
    table.last_seen = np.array(d["last_seen"], np.int64)
    table.slot_of = {int(lid): s for s, lid in enumerate(table.slot_lid) if lid >= 0}
    table.lid_of = {s: lid for lid, s in table.slot_of.items()}
    table.free = [int(s) for s in d["free"]]
    table.tick = int(d["tick"])
    table.num_evictions = int(d["num_evictions"])
    table._upd = [tuple(int(v) for v in u) for u in d["upd"]]
    table._clear = [int(s) for s in d["clear"]]
    return table


def frontend_config_from_numpy(d: dict) -> FrontendConfig:
    """``dataclasses.asdict`` of the JAX package's FrontendConfig (its
    ``detection`` a dict too) -> FrontendConfig with the same fields."""
    d = dict(d)
    det = DetectionConfig(**d.pop("detection"))
    return FrontendConfig(detection=det, **d)


def estimator_config_from_numpy(d: dict) -> EstimatorConfig:
    """``dataclasses.asdict`` of the JAX package's EstimatorConfig ->
    EstimatorConfig with the same fields."""
    return EstimatorConfig(**d)


def estimator_records_to_numpy(est) -> dict:
    """An estimator's host records as plain Python and numpy under the JAX
    package's field names; both packages' ``Estimator`` have the same
    attributes, so this reads either:

    ``{"window": [sid], "state_order": [sid], "states": {sid: {"t",
    "pose", "speed_bias", "is_keyframe", "in_window", "frozen",
    "is_pose_graph_frame", "imu_from", "n_imu", "anchor_id",
    "T_anchor7"}}, "landmarks": {lid: {"hp_W", "initialised", "quality",
    "info_scale", "obs": {(sid, cam, kp): (u, v, size)}}},
    "pose_graph_edges": [{"id_i", "id_j", "kind", "T_ij", "sqrt_info",
    "stored_obs"}]}``."""
    states = {}
    for sid, r in est.states.items():
        states[int(sid)] = {
            "t": float(r.t), "pose": np.array(r.pose), "speed_bias": np.array(r.speed_bias),
            "is_keyframe": bool(r.is_keyframe), "in_window": bool(r.in_window),
            "frozen": bool(r.frozen), "is_pose_graph_frame": bool(r.is_pose_graph_frame),
            "imu_from": r.imu_from, "n_imu": len(r.imu_dt), "anchor_id": r.anchor_id,
            "T_anchor7": None if r.T_anchor7 is None else np.array(r.T_anchor7),
        }
    landmarks = {
        int(lid): {"hp_W": np.array(lm.hp_W), "initialised": bool(lm.initialised),
                   "quality": float(lm.quality), "info_scale": float(lm.info_scale),
                   "obs": dict(lm.obs)}
        for lid, lm in est.landmarks.items()
    }
    edges = [{"id_i": e.id_i, "id_j": e.id_j, "kind": e.kind, "T_ij": np.array(e.T_ij),
              "sqrt_info": np.array(e.sqrt_info), "stored_obs": list(e.stored_obs)}
             for e in est.pose_graph_edges]
    return {"window": list(est.window), "state_order": list(est.state_order),
            "states": states, "landmarks": landmarks, "pose_graph_edges": edges}


# Flax leaf -> state_dict leaf, by (collection, leaf name)
_FLAX_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
              ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def fast_scnn_state_dict_from_flax(flat: dict) -> dict:
    """The JAX package's Fast-SCNN variables, flattened as its checkpoint
    stores them (``{"params/<module>/.../kernel": array, ...,
    "batch_stats/.../mean": array}``) -> a ``state_dict`` for
    ``models.fast_scnn.FastSCNN`` (float32 tensors on the CPU).

    Conv kernels [kh,kw,in/groups,out] become [out,in/groups,kh,kw]; the
    BatchNorm fields scale/bias/mean/var become weight/bias/running_mean/
    running_var (both packages use eps 1e-5). Strict: a key or shape the
    model does not have, or a model leaf without a key, raises."""
    expected = FastSCNN().to("meta").state_dict()
    out = {}
    for key, value in flat.items():
        coll, *mod, leaf = key.split("/")
        if (coll, leaf) not in _FLAX_LEAF or not mod:
            raise KeyError(f"fast_scnn_state_dict_from_flax: unknown key {key!r}")
        a = np.asarray(value, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1)
        name = ".".join(mod + [_FLAX_LEAF[(coll, leaf)]])
        if name not in expected or tuple(expected[name].shape) != a.shape:
            raise KeyError(f"fast_scnn_state_dict_from_flax: {key!r} -> {name!r} "
                           f"{a.shape} does not fit the model")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    for name, ref in expected.items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=ref.dtype)
        elif name not in out:
            raise KeyError(f"fast_scnn_state_dict_from_flax: no value for {name!r}")
    return out


def fast_scnn_flax_from_state_dict(sd: dict) -> dict:
    """The inverse of ``fast_scnn_state_dict_from_flax``: a ``state_dict``
    of ``models.fast_scnn.FastSCNN`` -> the JAX package's flattened Flax
    variables (``{"params/<module>/.../kernel": array, ...,
    "batch_stats/.../mean": array}``, numpy arrays in the tensors' dtype),
    as its ``save_params`` writes them.

    Conv weights [out,in/groups,kh,kw] become kernels [kh,kw,in/groups,out];
    BatchNorm weight/bias/running_mean/running_var become scale/bias/mean/
    var; ``num_batches_tracked`` is dropped. Strict: a key the model does
    not have, or a model leaf without a value, raises."""
    expected = FastSCNN().to("meta").state_dict()
    leaf_of = {v: k for k, v in _FLAX_LEAF.items() if k != ("params", "scale")}
    out = {}
    for name, value in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in expected or tuple(expected[name].shape) != tuple(value.shape):
            raise KeyError(f"fast_scnn_flax_from_state_dict: {name!r} {tuple(value.shape)} "
                           f"does not fit the model")
        *mod, leaf = name.split(".")
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if leaf == "weight" and a.ndim == 4:
            coll, flax_leaf, a = "params", "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            coll, flax_leaf = "params", "scale"
        else:
            coll, flax_leaf = leaf_of[leaf]
        out["/".join([coll, *mod, flax_leaf])] = np.ascontiguousarray(a)
    missing = [n for n in expected if not n.endswith("num_batches_tracked") and n not in sd]
    if missing:
        raise KeyError(f"fast_scnn_flax_from_state_dict: no value for {missing[0]!r}")
    return out
