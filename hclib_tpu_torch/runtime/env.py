"""The ``HCLIB_TPU_*`` environment variables the port reads, with the
semantics of ``hclib_tpu/runtime/env.py``: every name is declared once
here, read only through the typed accessors, and malformed text raises
unless the row says otherwise (a typo must not silently change
behavior). The port reads the JAX package's own variables; it adds none
of its own.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["REGISTRY", "env_int", "env_float", "env_raw", "env_set",
           "env_bool", "env_str"]

# name -> (kind, default, doc), as the JAX package's registry rows.
REGISTRY = {
    "HCLIB_TPU_FORASYNC_WIDTH": (
        "int", "8", "default forasync device-tier batch width"),
    "HCLIB_TPU_CKPT_DIR": (
        "str", "unset",
        "BundleStore root directory: default_store() writes generations "
        "under it"),
    "HCLIB_TPU_CKPT_KEEP": (
        "int", "3",
        "BundleStore retention: generations kept after each publish (>= 1; "
        "malformed text raises)"),
    "HCLIB_TPU_CKPT_FSYNC": (
        "bool", "on",
        "fsync bundle members and directories at publish (0 = fast mode "
        "for tests; crash-safety not guaranteed)"),
    "HCLIB_TPU_TRACE": (
        "int", "0 (off)",
        "flight-recorder ring capacity (1 = default capacity; malformed "
        "text counts as 1, 0 or below is off)"),
    "HCLIB_TPU_CHECKPOINT": (
        "bool", "off", "compile the quiesce protocol into schedulers"),
    "HCLIB_TPU_QUIESCE_STRIDE": (
        "int", "1",
        "poll the quiesce word every Nth round (malformed text counts as "
        "1)"),
    "HCLIB_TPU_LANE_MAX_AGE": (
        "int", "0 (off)",
        "age-triggered lane firing policy threshold, rounds (malformed "
        "text raises)"),
    "HCLIB_TPU_PRIORITY_BUCKETS": (
        "int", "0 (off)",
        "priority-bucket dispatch tier: bucket rings per batch lane, "
        "popped lowest-nonempty-first (2..8; malformed or out-of-range "
        "text raises)"),
    "HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS": (
        "int", "2",
        "spare edge blocks pre-allocated per vertex for in-kernel edge "
        "splices (>= 1; malformed or non-positive text raises)"),
    "HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY": (
        "int", "0",
        "bucket ring the UPDATE kind routes into on priority-bucketed "
        "dyngraph builds (0 = highest, fires before queries; clipped into "
        "[0, priority_buckets); malformed text raises)"),
    "HCLIB_TPU_PREEMPT": (
        "bool", "off",
        "wrapper-script preemption request (no-signal spelling)"),
    "HCLIB_TPU_CREDIT_TIMEOUT": (
        "int", "2", "steal-credit starvation window, exchange rounds"),
    "HCLIB_TPU_HEARTBEAT_TIMEOUT": (
        "int", "2", "dead-chip heartbeat window, exchange rounds"),
    "HCLIB_TPU_TENANTS": (
        "int", "0 (off)", "enable N equal tenant lanes on streaming runs"),
    "HCLIB_TPU_MESH_TENANTS": (
        "int", "0 (off)",
        "enable N equal tenant lanes on resident inject meshes (shares the "
        "per-lane WEIGHTS/RATE/BURST/INFLIGHT/DEADLINE_S knobs; malformed "
        "text raises)"),
    "HCLIB_TPU_TENANT_WEIGHTS": (
        "list", "unset",
        "per-lane WRR weights, e.g. 4,2,1 (implies lane count)"),
    "HCLIB_TPU_TENANT_RATE": (
        "float", "unset", "per-lane token-bucket refill rate, submits/s"),
    "HCLIB_TPU_TENANT_BURST": (
        "float", "rate", "per-lane token-bucket capacity"),
    "HCLIB_TPU_TENANT_INFLIGHT": (
        "float", "unset",
        "per-lane in-flight admission budget (whole number)"),
    "HCLIB_TPU_TENANT_DEADLINE_S": (
        "float", "unset", "per-lane default admission deadline, seconds"),
    "HCLIB_TPU_EGRESS_DEPTH": (
        "int", "0 (off)",
        "completion-mailbox ring depth, rows; enables submit futures on "
        "tenant runs (malformed text raises)"),
    "HCLIB_TPU_EGRESS_BACKOFF_S": (
        "float", "0.05",
        "Future.result() bounded-backoff poll cap, seconds (malformed "
        "text raises)"),
    "HCLIB_TPU_TELEMETRY": (
        "bool", "off",
        "compile the live telemetry plane into egress-enabled streams: "
        "per-request lifecycle stamps + on-device latency histograms, "
        "scrapeable mid-run (0 forces off)"),
    "HCLIB_TPU_TELEMETRY_POLL_S": (
        "float", "0.05",
        "TelemetryPoller snapshot interval, seconds (malformed text "
        "raises)"),
}


def _lookup(name: str) -> Optional[str]:
    if name not in REGISTRY:
        raise KeyError(
            f"{name} is not in the port's env registry "
            "(hclib_tpu_torch/runtime/env.py): add a row with its type "
            "and doc line"
        )
    return os.environ.get(name)


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The text as set (empty included); unset -> ``default``."""
    v = _lookup(name)
    return default if v is None else v


def env_set(name: str) -> bool:
    """Variable present AND nonempty (any text, including '0')."""
    return bool(_lookup(name))


def env_bool(name: str, default: bool = False) -> bool:
    """Unset -> default; ''/'0' -> False; anything else -> True."""
    v = _lookup(name)
    if v is None:
        return default
    return v not in ("", "0")


def _parse(name: str, conv, malformed):
    v = _lookup(name)
    if not v:
        return None
    try:
        return conv(v)
    except (TypeError, ValueError):
        if malformed == "raise":
            raise ValueError(
                f"{name}={v!r} must be "
                f"{'an int' if conv is int else 'a number'}") from None
        return malformed


def env_int(name: str, default: Optional[int] = None, *,
            malformed="raise") -> Optional[int]:
    """Int value; unset/empty -> ``default``. Malformed text raises
    ``ValueError`` naming the variable unless ``malformed=`` supplies a
    fallback."""
    v = _parse(name, int, malformed)
    return default if v is None else v


def env_float(name: str, default: Optional[float] = None, *,
              malformed="raise") -> Optional[float]:
    """Float value, with ``env_int``'s rules."""
    v = _parse(name, float, malformed)
    return default if v is None else v


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The text; unset or empty -> ``default``."""
    v = _lookup(name)
    return default if not v else v
