"""Device meshes on one card: a mesh device is one co-resident CTA.

Port of ``hclib_tpu/parallel/mesh.py`` ``cpu_mesh`` (:44) for the mesh
runners (device/sharded.py, device/ici_steal.py, device/resident.py). On
the TPU a mesh is a ``jax.sharding.Mesh`` over chips joined by ICI; here
it is a ``CtaMesh``: ``ndev`` persistent CTAs of ONE launch on one card,
each holding its own slice of stacked global-memory state (the per-device
task table, ready ring, counts, value slots), with remote DMAs turned into
stores into another CTA's inbox followed by a release flag. The runners
read ``axis_names`` and ``dims`` the way JAX's read ``mesh.axis_names``
and ``mesh.devices.shape``; devices are numbered by row-major flattening
of ``dims`` (JAX's, so the low XOR hop bits flip the minor axis).
``mesh_locality_graph`` waits for ROADMAP A13.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..device.state import resolve_device

__all__ = ["CtaMesh", "cuda_mesh", "cpu_mesh"]


class CtaMesh:
    """``dims`` (1 to 3 axes, named ``axis_names``) of mesh devices on
    ``device``: CTAs of one cooperative launch on ``"cuda"``, the plain
    versions' loop over devices on ``"cpu"``."""

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str],
                 device="cuda") -> None:
        dims = tuple(int(d) for d in dims)
        axis_names = tuple(str(a) for a in axis_names)
        if not 1 <= len(dims) <= 3 or len(axis_names) != len(dims):
            raise ValueError(
                f"a mesh has 1 to 3 named axes, got dims {dims} and names "
                f"{axis_names}")
        if any(d < 1 for d in dims):
            raise ValueError(f"mesh axes must be >= 1, got {dims}")
        self.dims: Tuple[int, ...] = dims
        self.axis_names: Tuple[str, ...] = axis_names
        self.device: torch.device = resolve_device(device)
        n = 1
        for d in dims:
            n *= d
        self.ndev = n

    def __repr__(self) -> str:
        return (f"CtaMesh(dims={self.dims}, axis_names={self.axis_names}, "
                f"device={str(self.device)!r})")


def cuda_mesh(n: int, axis_name: str = "d") -> CtaMesh:
    """An ``n``-device 1D mesh of co-resident CTAs on the card."""
    return CtaMesh((n,), (axis_name,), device="cuda")


def cpu_mesh(n: int, axis_name: str = "d") -> CtaMesh:
    """An ``n``-device 1D mesh whose runners run their plain versions on
    the CPU (the counterpart of JAX's virtual CPU devices)."""
    return CtaMesh((n,), (axis_name,), device="cpu")
