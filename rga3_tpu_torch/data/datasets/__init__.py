from .hybrid import DATASET_REGISTRY, ImgVidHybridDataset  # noqa: F401
