"""One-sided device PGAS on one card: put / active messages / wait-until on
data between mesh devices, inside the resident kernel's launch.

Port of ``hclib_tpu/device/pgas_kernel.py`` ``PGASMegakernel`` (:114):
its constructor checks (:125-167) and ``run`` (:742). A mesh device is
one co-resident CTA (``parallel.mesh.CtaMesh``); the megakernel's
``data_specs`` buffers exist on every device with identical shapes (a
symmetric heap, stacked on a leading mesh axis); a channel ``{name:
(buffer, rows)}`` is the static contract a put moves ``rows`` rows under.
Bodies reach the operations through ``ctx.pgas`` (``put``, ``am``,
``wait_until``, ``count``, ``me``, ``ndev``, ``nchan``); the protocol
(counts routed by the fold, arrivals consumed before they are read,
message counting for termination) is the resident kernel's, see
device/resident.py and csrc/mesh.cuh.

A power-of-two mesh delegates to ``ResidentKernel(steal=False,
channels=..., am_window=..., outbox=..., max_waits=...)``, as JAX's does.
Its own ring kernel (``_kernel`` :182, pallas_call at :665), which JAX
runs only on meshes whose size is not a power of two, is not ported yet:
such a mesh raises naming ROADMAP A11b.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .descriptor import TaskGraphBuilder
from .megakernel import Megakernel
from .resident import ResidentKernel

__all__ = ["PGASMegakernel"]


class PGASMegakernel:
    """Per-device resident scheduler + one-sided PGAS over a 1D mesh.

    ``channels`` maps channel name -> (data buffer name, rows per
    message); every put on a channel moves exactly that many leading-axis
    rows. ``chan_id`` gives the table index kernels use. ``am_window`` is
    the per-(source, target) inbox depth; at most ``am_window // 2`` AMs
    per target leave the outbox per round; ``outbox`` bounds the queued
    messages and ``max_waits`` the parked wait-untils of a device.
    """

    def __init__(
        self,
        mk: Megakernel,
        mesh,
        channels: Optional[Dict[str, Tuple[str, int]]] = None,
        am_window: int = 8,
        outbox: int = 64,
        max_waits: int = 64,
    ) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError("PGASMegakernel wants a 1D mesh")
        self.mk = mk
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.ndev = int(np.prod(mesh.dims))
        if self.ndev & (self.ndev - 1):
            raise NotImplementedError(
                f"PGASMegakernel on {self.ndev} devices (not a power of "
                "two) runs JAX's ring kernel, PGASMegakernel._kernel, which "
                "is not ported yet: ROADMAP A11b; use a power-of-two mesh "
                "(the resident kernel's PGAS configuration)")
        # The resident kernel checks the channels and the window and
        # parses the channels; this front keeps its view of them.
        self._resident = ResidentKernel(
            mk, mesh, steal=False, channels=dict(channels or {}),
            am_window=am_window, outbox=outbox, max_waits=max_waits,
        )
        r = self._resident
        self.channels: List[Tuple[str, int]] = r.channels
        self.chan_id: Dict[str, int] = r.chan_id
        self.nchan = r.nchan
        self.am_window, self.outbox, self.max_waits = (
            r.am_window, r.outbox, r.max_waits)

    def run(
        self,
        builders: Sequence[TaskGraphBuilder],
        data: Optional[Dict[str, np.ndarray]] = None,
        ivalues: Optional[np.ndarray] = None,
        waits: Optional[Sequence[Sequence[Tuple[int, int, int]]]] = None,
        quantum: int = 64,
        max_rounds: int = 1 << 14,
        abort=None,
    ):
        """Execute all partitions in one launch.

        ``waits[d]`` lists host-declared wait-sets for device d as
        (chan_id, need, task_index) - the named task gains one extra
        dependency satisfied when ``need`` messages have landed on the
        channel. Returns (ivalues[ndev, V], data, info); ``data`` values
        carry a leading device axis (per-device symmetric-heap
        instances). ``abort``: host abort word (truthy or per-device
        flags) - the mesh exits in lockstep with ``info['aborted']``.
        """
        return self._resident.run(
            builders, data=data, ivalues=ivalues, waits=waits,
            quantum=quantum, max_rounds=max_rounds, abort=abort,
        )
