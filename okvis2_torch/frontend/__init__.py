from okvis2_torch.frontend.descriptor import DESCRIPTOR_BITS, describe_keypoints
from okvis2_torch.frontend.detection import (
    DetectionConfig,
    detect_keypoints,
    detect_keypoints_batch,
)
from okvis2_torch.frontend.matching import hamming_distance_matrix, match_descriptors

__all__ = [
    "detect_keypoints",
    "detect_keypoints_batch",
    "DetectionConfig",
    "describe_keypoints",
    "DESCRIPTOR_BITS",
    "hamming_distance_matrix",
    "match_descriptors",
]
