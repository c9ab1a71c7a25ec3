from .config import HieraConfig, Sam2Config, SAM2_HIERA_L, tiny_sam2_config  # noqa: F401
