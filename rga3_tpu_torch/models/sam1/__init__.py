from .config import SAM1_VIT_B, SAM1_VIT_H, SAM1_VIT_L, Sam1Config, tiny_sam1_config  # noqa: F401
from .model import Sam1Model  # noqa: F401
