from .config import (  # noqa: F401
    QWEN25_VL_3B, QWEN25_VL_7B, Qwen25VLConfig, QwenTextConfig,
    QwenVisionConfig, tiny_config,
)
