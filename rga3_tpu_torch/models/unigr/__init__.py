from .model import UniGR, UniGRConfig  # noqa: F401
