"""STOM overlay propagation with the CoTracker3 or the LK point tracker,
CoTrackerLite, and the synthetic curriculum the trackers train and are
scored on (counterpart of `rga3_tpu/models/stom/`)."""
from .stom import STOM, default_tracker  # noqa: F401
from .tracker import LKTracker  # noqa: F401
from .cotracker3 import (  # noqa: F401
    CoTracker3Offline,
    CoTracker3Predictor,
    cotracker3_offline_config,
    cotracker3_small_config,
    load_cotracker3,
    save_cotracker3,
    shipped_tracker,
)
from .cotracker import (  # noqa: F401
    CoTrackerLite,
    CoTrackerLitePredictor,
    load_params,
    save_params,
)
