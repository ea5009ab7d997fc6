from okvis2_torch.cameras.distortion import (
    Distortion,
    EquidistantDistortion,
    NoDistortion,
    RadialTangentialDistortion,
    RadialTangentialDistortion8,
    distortion_by_name,
)
from okvis2_torch.cameras.ncamera import NCameraSystem
from okvis2_torch.cameras.pinhole import PinholeCamera

__all__ = [
    "Distortion",
    "EquidistantDistortion",
    "NoDistortion",
    "RadialTangentialDistortion",
    "RadialTangentialDistortion8",
    "distortion_by_name",
    "PinholeCamera",
    "NCameraSystem",
]
