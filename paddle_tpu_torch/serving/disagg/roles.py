"""Worker roles and their flag profiles (counterpart of
``paddle_tpu/serving/disagg/roles.py``).

A role is routing policy, not capability: every worker boots the same whole
serving stack, so a pool whose prefill or decode side is empty degrades to
unified routing without spawning anything. What differs per role is the flag
snapshot its spawn payload carries:

* **prefill**: chunked prefill that publishes as it goes. Every finished full
  prompt block enters the radix cache (``FLAGS_serving_publish_chunks``) and
  is written through to the shared disk tier at once
  (``FLAGS_serving_tier_publish``), so the chain is restorable by other
  processes before the prefill ends, and after a kill the successor
  prefills only the unpublished suffix. The chunk size is not in the tier
  signature, so both roles name a block by the same key.
* **decode**: the prefix cache and the tiers on, publish off: a handed-off
  request's admission walks the radix tree, adopts the published content
  hashes from the shared directory as spilled nodes and restores them
  through the one captured restore program.
* **unified**: no overrides (the parent's flags).

Roles are assigned by replica index, prefill workers first, so a respawned
worker keeps its role (``ProcessReplicaPool._payload_for`` is a function of
the index). Both roles share one disk directory
(``FLAGS_serving_disk_cache_dir``, or one :func:`shared_disk_dir` mints):
content-addressed files, each writer's temporary file its own, crc-checked
on load, so sharing needs nothing beyond the directory.
"""
from __future__ import annotations

import tempfile
from typing import Optional, Tuple

from ...core import flags

PREFILL = "prefill"
DECODE = "decode"
UNIFIED = "unified"


def role_counts(prefill: Optional[int] = None,
                decode: Optional[int] = None) -> Tuple[int, int]:
    """``(n_prefill, n_decode)`` from the arguments, else from
    ``FLAGS_gateway_prefill_replicas`` / ``FLAGS_gateway_decode_replicas``;
    ``(0, 0)`` is a unified pool."""
    p = int(flags.flag("gateway_prefill_replicas")
            if prefill is None else prefill)
    d = int(flags.flag("gateway_decode_replicas")
            if decode is None else decode)
    if p < 0 or d < 0:
        raise ValueError(f"role counts must be >= 0, got prefill={p} "
                         f"decode={d}")
    return p, d


def role_of(idx: int, n_prefill: int, n_decode: int) -> str:
    """The role of replica ``idx``: prefill workers hold the low indices,
    decode workers the next band, any index past both is unified."""
    if idx < n_prefill:
        return PREFILL
    if idx < n_prefill + n_decode:
        return DECODE
    return UNIFIED


def shared_disk_dir() -> str:
    """The disk tier's directory both roles share:
    ``FLAGS_serving_disk_cache_dir`` when set, else a fresh temporary
    directory (the pool ships it to every worker in its flag snapshot; the
    parent's flag stays empty)."""
    configured = str(flags.flag("serving_disk_cache_dir"))
    if configured:
        return configured
    return tempfile.mkdtemp(prefix="paddle_disagg_kv_")


def role_flag_overrides(role: str, disk_dir: str) -> dict:
    """The flags a worker of ``role`` boots under, merged over the parent's
    snapshot."""
    base = {
        "serving_prefix_cache": True,
        "serving_kv_tiering": True,
        "serving_disk_cache_dir": str(disk_dir),
    }
    if role == PREFILL:
        base["serving_publish_chunks"] = True
        base["serving_tier_publish"] = True
        # chunked prefill makes the publish incremental: without it the
        # chain is restorable only once the whole prompt has landed
        base["serving_chunked_prefill"] = (
            int(flags.flag("serving_chunked_prefill")) or 32)
        return base
    if role == DECODE:
        return base
    return {}
