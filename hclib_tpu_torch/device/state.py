"""Scheduler state as tensors, and the way in and out of numpy.

The JAX package's megakernel takes its state as numpy arrays: the
``TaskGraphBuilder.finalize()`` tuple (tasks, succ, ring, counts), the
int32 value slots and a dict of data buffers. ``from_numpy`` moves exactly
that state onto a device as tensors and ``to_numpy`` brings it back, so
both packages can be fed identical state and compared word for word.

bf16 buffers: JAX hands them out as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` does not take; they cross as 16-bit views (bits
unchanged), and come back as ``np.uint16`` arrays of the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["resolve_device", "from_numpy", "to_numpy", "tensor_of", "numpy_of"]


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the default of
    every entry point) raises on a machine without a usable GPU: the port
    never falls back to the CPU unless the caller asks for it."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return d


def tensor_of(a, device) -> torch.Tensor:
    """numpy array (int32, float32 or bfloat16 bits) -> tensor on device."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def numpy_of(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy array; bf16 comes back as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def from_numpy(tasks, succ, ring, counts, ivalues,
               data: Optional[Dict[str, np.ndarray]] = None,
               device="cuda") -> Dict[str, object]:
    dev = resolve_device(device)
    return {
        "tasks": tensor_of(np.asarray(tasks, np.int32), dev),
        "succ": tensor_of(np.asarray(succ, np.int32), dev),
        "ready": tensor_of(np.asarray(ring, np.int32), dev),
        "counts": tensor_of(np.asarray(counts, np.int32), dev),
        "ivalues": tensor_of(np.asarray(ivalues, np.int32), dev),
        "data": {k: tensor_of(v, dev) for k, v in (data or {}).items()},
    }


def to_numpy(state: Dict[str, object]):
    """(tasks, succ, ready, counts, ivalues, data) as numpy arrays."""
    return (
        numpy_of(state["tasks"]), numpy_of(state["succ"]),
        numpy_of(state["ready"]), numpy_of(state["counts"]),
        numpy_of(state["ivalues"]),
        {k: numpy_of(v) for k, v in state["data"].items()},
    )
