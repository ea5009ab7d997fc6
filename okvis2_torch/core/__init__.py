from okvis2_torch.core import so3, se3, se3_np
from okvis2_torch.core.se3 import Transformation

__all__ = ["so3", "se3", "se3_np", "Transformation"]
