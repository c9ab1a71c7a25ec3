"""STOM overlay propagation with the CoTracker3 or the LK point tracker
(counterpart of `rga3_tpu/models/stom/`)."""
from .stom import STOM, default_tracker  # noqa: F401
from .tracker import LKTracker  # noqa: F401
from .cotracker3 import (  # noqa: F401
    CoTracker3Offline,
    CoTracker3Predictor,
    cotracker3_offline_config,
    cotracker3_small_config,
    load_cotracker3,
    shipped_tracker,
)
