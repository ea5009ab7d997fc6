from okvis2_torch.pipeline.frontend_pipeline import Frontend, FrontendConfig
from okvis2_torch.pipeline.slam import SlamSystem

__all__ = ["Frontend", "FrontendConfig", "SlamSystem"]
