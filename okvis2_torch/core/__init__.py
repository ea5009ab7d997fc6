from okvis2_torch.core import so3, se3
from okvis2_torch.core.se3 import Transformation

__all__ = ["so3", "se3", "Transformation"]
