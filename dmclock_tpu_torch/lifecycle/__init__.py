"""Client lifecycle plane of the PyTorch port: dynamic slot management,
live ClientInfo control over HTTP and the churn scenario suite (the
counterpart of ``dmclock_tpu/lifecycle``; of its placement module only
the spec parsing the supervisor validates jobs with)."""

from .api import AdminAPI, mount_admin_api
from .churn import (SCENARIOS, events, init_qos, lam_vector, make_spec,
                    peak_ids, static_variant)
from .plane import (COUNTER_KEYS, LifecyclePlane, apply_op_vector,
                    wal_append)
from .runner import run_serial_churn
from .slots import SlotMap, compact_tree

__all__ = [
    "AdminAPI", "COUNTER_KEYS", "LifecyclePlane", "SCENARIOS",
    "SlotMap", "apply_op_vector", "compact_tree", "events",
    "init_qos", "lam_vector", "make_spec", "mount_admin_api",
    "peak_ids", "run_serial_churn", "static_variant", "wal_append",
]
