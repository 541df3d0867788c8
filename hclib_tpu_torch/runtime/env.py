"""The ``HCLIB_TPU_*`` environment variables the port reads, with the
semantics of ``hclib_tpu/runtime/env.py``: every name is declared once
here, read only through the typed accessor, and malformed text raises
(a typo must not silently change behavior). The port reads the JAX
package's own variables; it adds none of its own.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["REGISTRY", "env_int"]

# name -> (kind, default, doc), as the JAX package's registry rows.
REGISTRY = {
    "HCLIB_TPU_FORASYNC_WIDTH": (
        "int", "8", "default forasync device-tier batch width"),
}


def _lookup(name: str) -> Optional[str]:
    if name not in REGISTRY:
        raise KeyError(
            f"{name} is not in the port's env registry "
            "(hclib_tpu_torch/runtime/env.py): add a row with its type "
            "and doc line"
        )
    return os.environ.get(name)


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Int value; unset/empty -> ``default``. Malformed text raises
    ``ValueError`` naming the variable."""
    v = _lookup(name)
    if not v:
        return default
    try:
        return int(v)
    except (TypeError, ValueError):
        raise ValueError(f"{name}={v!r} must be an int") from None
