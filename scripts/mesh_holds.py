"""The runs the mesh kernels are held to their plain versions on, word for
word: ``chip_smoke.py``'s ``mesh`` lines and the card tests of
``tests/test_torch_cuda.py`` run each case on the card (``device="cuda"``:
``mk_grid_kernel``, ``ici_ring_kernel`` and ``resident_steal_kernel`` of
``csrc/mesh.cuh``) and on the CPU (the plain versions) and compare what
each returns.

    from mesh_holds import CASES, run_case, compare
    compare(run_case("ring_6", "cuda"), run_case("ring_6", "cpu"))

Every case is a fib forest: FOREST_STEAL_QUICK's 24 FIB(9) roots
(3,912 tasks) on device 0 unless it says otherwise. A case returns the
value slots of every device, every device's counts row, the rounds, the
tier counters (batch-routed), the fault stats and the exchange volume
(steal kernels), and the ``info`` times (``kernel_ms``: the launches'
CUDA-event time on the card, the plain version's wall time on the CPU;
``exchange_ms``: the sharded runner's torch exchange). Cases:

- ``sharded_nosteal_8``: the roots dealt round-robin over 8 devices, one
  grid launch.
- ``sharded_steal_8``, ``sharded_steal_8_b8``: the steal rounds at
  quantum 64, window 16, scalar and with FIB routed at width 8.
- ``sharded_hop_4``: 4 devices, ``hop_order=[2, 1]``.
- ``ring_3``, ``ring_6``: the ring at 3 and 6 devices, quantum 64;
  ``ring_6_abort``: device 5's abort word set; ``ring_3_b8``: width 8;
  ``ring_1``: the one-device self-exchange (``_run_ring``).
- ``resident_2``, ``resident_4``: the resident steal-only kernel;
  ``resident_8_hops``: 8 devices, ``hop_order=[4, 1, 2]``;
  ``resident_8_abort``: device 3's abort word set; ``resident_8_b8``:
  width 8.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hclib_tpu_torch.device import stress  # noqa: E402
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder  # noqa: E402
from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel  # noqa
from hclib_tpu_torch.device.sharded import ShardedMegakernel  # noqa: E402
from hclib_tpu_torch.device.workloads import FIB  # noqa: E402
from hclib_tpu_torch.parallel.mesh import CtaMesh  # noqa: E402

ROOTS, N, CAP = (stress.FOREST_STEAL_QUICK[k] for k in ("roots", "n",
                                                        "capacity"))

# name: (runner, ndev, batch width, roots dealt round-robin, run kwargs)
CASES = {
    "sharded_nosteal_8": ("sharded", 8, 0, True, {}),
    "sharded_steal_8": ("sharded", 8, 0, False,
                        dict(steal=True, quantum=64, window=16)),
    "sharded_steal_8_b8": ("sharded", 8, 8, False,
                           dict(steal=True, quantum=64, window=16)),
    "sharded_hop_4": ("sharded", 4, 0, False,
                      dict(steal=True, quantum=64, window=16,
                           hop_order=[2, 1])),
    "ring_3": ("ici", 3, 0, False, dict(quantum=64)),
    "ring_6": ("ici", 6, 0, False, dict(quantum=64)),
    "ring_6_abort": ("ici", 6, 0, False,
                     dict(quantum=64, abort=[0, 0, 0, 0, 0, 1])),
    "ring_3_b8": ("ici", 3, 8, False, dict(quantum=64)),
    "ring_1": ("ring", 1, 0, False, dict(quantum=64)),
    "resident_2": ("ici", 2, 0, False, dict(quantum=64)),
    "resident_4": ("ici", 4, 0, False, dict(quantum=64)),
    "resident_8_hops": ("resident", 8, 0, False,
                        dict(quantum=64, hop_order=[4, 1, 2])),
    "resident_8_abort": ("ici", 8, 0, False,
                         dict(quantum=64, abort=[0, 0, 0, 1, 0, 0, 0, 0])),
    "resident_8_b8": ("ici", 8, 8, False, dict(quantum=64)),
}


def kernel_of(name: str) -> str:
    """The mesh kernel a case runs on the card (a ``_build.LAUNCHES``
    name): the ICI runner takes the resident kernel on power-of-two
    meshes and the ring on the others."""
    kind, ndev = CASES[name][:2]
    if kind == "ici":
        kind = "resident" if ndev & (ndev - 1) == 0 else "ring"
    return {"sharded": "mesh_round", "ring": "ici_ring",
            "resident": "resident_steal"}[kind]


def builders(ndev: int, dealt: bool):
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for r in range(ROOTS):
        bs[r % ndev if dealt else 0].add(FIB, args=[N], out=r)
    for b in bs:
        b.reserve_values(ROOTS)
    return bs


def run_case(name: str, device: str) -> dict:
    """One case on ``device``; returns what it is compared on."""
    kind, ndev, bw, dealt, kw = CASES[name]
    mk = stress.forest_megakernel(ROOTS, CAP, bw, device)
    mesh = CtaMesh((ndev,), ("q",), device=device)
    if kind == "sharded":
        runner = ShardedMegakernel(mk, mesh, migratable_fns=[FIB])
        iv, _, info = runner.run(builders(ndev, dealt), **kw)
    else:
        runner = ICIStealMegakernel(mk, mesh, migratable_fns=[FIB],
                                    window=8)
        if kind == "resident":
            iv, _, info = runner._resident.run(builders(ndev, dealt), **kw)
            info["steal_rounds"] = info.pop("rounds")
        elif kind == "ring":
            iv, _, info = runner._run_ring(builders(ndev, dealt), **kw)
        else:
            iv, _, info = runner.run(builders(ndev, dealt), **kw)
    if not kw.get("abort"):
        stress.check_forest(iv, info, ROOTS, N)
    ex = info.get("exchange", {})
    return {
        "iv": np.asarray(iv),
        "counts": np.asarray(info["per_device_counts"]),
        "rounds": info.get("steal_rounds"),
        "tiers": info.get("tiers"),
        "fault_stats": info.get("fault_stats"),
        "aborted": info.get("aborted"),
        "rows": ex.get("rows"),
        "stat_words": ex.get("stat_words"),
        "executed": info["executed"],
        "kernel_ms": ex.get("kernel_ms", info.get("kernel_ms")),
        "exchange_ms": info.get("exchange_ms"),
    }


TIMES = ("kernel_ms", "exchange_ms")


def compare(got: dict, want: dict, what: str = "") -> float:
    """Raise unless every output but the times agrees word for word;
    returns the largest absolute difference of the value slots (0)."""
    for k in want:
        if k in TIMES:
            continue
        a, b = got[k], want[k]
        same = (np.array_equal(a, b) if isinstance(b, np.ndarray)
                else a == b)
        if not same:
            raise AssertionError(f"mesh {what}: {k} differs from the plain "
                                 f"version: {a!r} vs {b!r}")
    return float(np.abs(got["iv"].astype(np.int64)
                        - want["iv"].astype(np.int64)).max())
