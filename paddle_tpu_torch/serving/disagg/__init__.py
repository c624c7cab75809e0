"""Disaggregated prefill and decode serving (counterpart of
``paddle_tpu/serving/disagg/``).

Role-typed worker processes over the process replica pool: prefill workers
chunk-prefill a prompt, publishing each finished full block to the shared
disk tier under its content hash, and emit the first token; decode workers
admit the handed-off request by restoring the published chain through the
captured restore program, prefill the short unpublished suffix and decode to
the end. :class:`DisaggReplicaPool` routes each request by its phase;
:class:`RestorePlanner` restores a waiting request's chain ahead of its
admission.
"""
from .pool import DisaggReplicaPool
from .prefetch import RestorePlanner
from .roles import (DECODE, PREFILL, UNIFIED, role_counts,
                    role_flag_overrides, role_of, shared_disk_dir)

__all__ = [
    "DisaggReplicaPool",
    "RestorePlanner",
    "PREFILL",
    "DECODE",
    "UNIFIED",
    "role_counts",
    "role_flag_overrides",
    "role_of",
    "shared_disk_dir",
]
