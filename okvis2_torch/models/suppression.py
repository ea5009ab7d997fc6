"""CNN keypoint suppression: sky and person landmarks carry ~zero weight.

Port of ``okvis2_tpu/models/suppression.py``. On every keyframe the
reference segments each image with fast-scnn (Frontend.cpp:902-941),
classifies the keypoints (okvis_cv/src/Frame.cpp:46-147) and scales the
information of landmarks observed on sky (class 10) or person (class 11)
pixels by 1e-4 (Frontend.cpp:969-1011). Here each camera's image goes
through ``FastSCNN`` on the device, its keypoints are classified there,
and the classes of all cameras come back in one copy per keyframe; the
suppression is a per-landmark information scale that every problem
packer reads (``LandmarkRecord.info_scale``).
"""

from __future__ import annotations

import numpy as np
import torch

from okvis2_torch import interop, resolve_device
from okvis2_torch.models.fast_scnn import (
    PERSON_CLASS,
    SKY_CLASS,
    FastSCNN,
    classify_keypoints,
    load_params,
    segment_image,
)


class CnnSuppressor:
    """Keyframe-time landmark suppression from Fast-SCNN segmentation.

    ``params_or_path``: the path of a flattened Flax checkpoint (``.npz``,
    the JAX package's format, read with numpy) or its ``{key: array}``
    dict. The network runs on ``device`` (None: the CUDA card; raises
    without one) in each image's floating dtype, float32 for integer
    images, which reach it unscaled as in the JAX package."""

    def __init__(self, params_or_path, device=None):
        flat = load_params(params_or_path) if isinstance(params_or_path, str) else params_or_path
        self.device = resolve_device(device)
        model = FastSCNN()
        model.load_state_dict(interop.fast_scnn_state_dict_from_flax(flat))
        self._models = {torch.float32: model.eval().to(self.device)}
        self.num_suppressed = 0

    def model(self, dtype=torch.float32) -> FastSCNN:
        """The network with its weights in ``dtype`` (a float32 copy cast
        once per dtype)."""
        if dtype not in self._models:
            self._models[dtype] = self._models[torch.float32].to(dtype=dtype)
        return self._models[dtype]

    def classify(self, img, xy) -> torch.Tensor:
        """Segment one image ([H,W] or [H,W,3], numpy or tensor) and return
        the class of each keypoint ``xy`` [N,2], on the device."""
        img = torch.as_tensor(np.asarray(img), device=self.device)
        dtype = img.dtype if img.is_floating_point() else torch.float32
        seg = segment_image(self.model(dtype), img)
        return classify_keypoints(seg, torch.as_tensor(np.asarray(xy), device=self.device))

    def suppress(self, estimator, frames, sid: int, images) -> int:
        """Classify this keyframe's keypoints and set info_scale = 1e-4 on
        the landmarks observed at sky or person keypoints. Returns the
        number of landmarks suppressed at this keyframe."""
        classes = [self.classify(img, frames[ci]["xy"]) for ci, img in enumerate(images)]
        sizes = [len(c) for c in classes]
        classes = np.split(torch.cat(classes).cpu().numpy(), np.cumsum(sizes)[:-1])  # one fetch
        n = 0
        for (lid, ci, kp) in estimator.obs_of_state(sid):
            lm = estimator.landmarks.get(lid)
            if lm is None:
                continue
            c = int(classes[ci][kp])
            if (c == SKY_CLASS or c == PERSON_CLASS) and lm.info_scale > 1e-4:
                estimator.set_info_scale(lid, 1e-4)
                n += 1
        self.num_suppressed += n
        return n
