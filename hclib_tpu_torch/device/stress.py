"""Benchmark-scale multi-device workloads on one card: the forest steal.

Port of ``hclib_tpu/device/stress.py`` ``FOREST_STEAL_BENCH``,
``FOREST_STEAL_QUICK`` (:46-47) and ``forest_steal`` (:50): a maximally
skewed forest of fib roots (every root seeded on device 0) through the
bulk-synchronous sharded runner (device/sharded.py), scalar or with the
FIB kind routed through the batch tier. Roots are successor-free
descriptors, so they migrate in the steal rounds, and each stolen root
explodes into its dependency-rich subtree on the thief. The totals are
exact: executed = roots * (FIB nodes + SUM joins), and the root slots sum
to roots * fib(n) across the mesh (a migrated root writes its slot on the
thief's value buffer).

On the card a mesh device is one CTA (``parallel.mesh.cuda_mesh``); the
run is timed by the host's wall clock around a run that ends with the
copy of the results to the host (which waits for the card), after a
warm-up run. ``unified_load`` (:149) needs homed migration and the PGAS
channels of the unified resident kernel: it raises naming ROADMAP A11b.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

__all__ = ["forest_steal", "unified_load",
           "FOREST_STEAL_BENCH", "FOREST_STEAL_QUICK"]

# The benchmark-of-record forest-steal configuration (bench.py
# --multichip's headline), scalar and batched arms alike.
FOREST_STEAL_BENCH = dict(ndev=8, roots=160, n=12, capacity=4096)
FOREST_STEAL_QUICK = dict(ndev=8, roots=24, n=9, capacity=1024)


def forest_builders(ndev: int, roots: int, n: int):
    """``roots`` FIB(n) roots on device 0, out slots 0..roots-1, and the
    root slot range reserved on every device (a migrated root writes its
    slot on the thief)."""
    from .descriptor import TaskGraphBuilder
    from .workloads import FIB

    builders = [TaskGraphBuilder() for _ in range(ndev)]
    for r in range(roots):
        builders[0].add(FIB, args=[n], out=r)
    for b in builders:
        b.reserve_values(roots)
    return builders


def forest_megakernel(roots: int, capacity: int, batch_width: int = 0,
                      device="cuda"):
    """The fib table of a forest of ``roots`` roots: every row's value
    block plus the root slots (at least 64)."""
    from .megakernel import VBLOCK
    from .workloads import make_fib_megakernel

    return make_fib_megakernel(
        capacity=capacity, num_values=VBLOCK * capacity + max(64, roots),
        batch_width=batch_width or None, device=device)


def check_forest(iv, info, roots: int, n: int) -> int:
    """The forest's exact totals; returns the task count."""
    from ..models.fib import fib_seq, task_count

    per_call = task_count(n)
    per_call += (per_call - 1) // 2  # SUM joins
    expect = roots * per_call
    assert info["executed"] == expect, (info["executed"], expect)
    got = int(np.asarray(iv)[:, :roots].sum(dtype=np.int64))
    assert got == roots * fib_seq(n), (got, roots * fib_seq(n))
    assert info["pending"] == 0
    return expect


def forest_steal(
    ndev: int = 8,
    roots: int = 160,
    n: int = 12,
    quantum: int = 256,
    window: int = 16,
    capacity: int = 4096,
    batch_width: int = 0,
    device="cuda",
) -> Dict:
    """Maximally skewed fib forest through the sharded steal runner.

    ``roots`` fib(``n``) seeds all on device 0; the executed count and the
    root slots are held to their closed forms. ``batch_width`` > 0 routes
    the FIB kind through the batch tier: the returned info carries
    per-device ``tiers`` beside the totals, which stay exact. The info
    also carries the timed run's ``ivalues`` (ndev, V), so a caller can
    hold one device's run against another's (JAX's returns none)."""
    from ..parallel.mesh import CtaMesh
    from .sharded import ShardedMegakernel
    from .workloads import FIB

    mk = forest_megakernel(roots, capacity, batch_width, device)
    smk = ShardedMegakernel(mk, CtaMesh((ndev,), ("q",), device=device),
                            migratable_fns=[FIB])

    def run():
        return smk.run(forest_builders(ndev, roots, n), steal=True,
                       quantum=quantum, window=window)

    run()  # warm-up: the build and the first launches
    t0 = time.perf_counter()
    iv, _, info = run()  # returns host copies: the card has finished
    dt = time.perf_counter() - t0
    expect_tasks = check_forest(iv, info, roots, n)
    per_dev = np.asarray(info["per_device_counts"])[:, 5]
    tier_label = f" [batch w={batch_width}]" if batch_width else ""
    info = dict(info)
    info.update(
        name=f"forest_steal {roots}x fib({n}) on {ndev} devices"
        + tier_label,
        seconds=dt,
        timer="host wall clock around a synchronised run",
        tasks=expect_tasks,
        tasks_per_sec=expect_tasks / dt,
        rounds=info.get("steal_rounds"),
        devices_used=int((per_dev > 0).sum()),
        imbalance=float(per_dev.max() * ndev / max(per_dev.sum(), 1)),
        per_device_counts=np.asarray(info["per_device_counts"]).tolist(),
        ivalues=iv,
    )
    if batch_width:
        # Every device that executed work fired batch rounds, and the
        # tier totals reconcile with the executed count.
        tiers = info["tiers"]
        batched = sum(t["batch_tasks"] for t in tiers)
        scalar = sum(t["scalar_tasks"] for t in tiers)
        assert batched + scalar == expect_tasks, (batched, scalar)
        for d in range(ndev):
            if per_dev[d] > 0:
                assert tiers[d]["batch_rounds"] > 0, (d, tiers[d])
        occ = [t["batch_occupancy"] for t in tiers if t["batch_rounds"]]
        info.update(
            batch_tasks=batched,
            min_occupancy=min(occ),
            mean_occupancy=sum(occ) / len(occ),
            spilled=sum(t["spilled"] for t in tiers),
        )
    return info


def unified_load(*args, **kwargs) -> Dict:
    """Dependency-bearing migration plus PGAS under load (JAX's
    ``unified_load``): not ported yet."""
    raise NotImplementedError(
        "unified_load needs the unified resident kernel's homed migration "
        "and PGAS channels (remote fetch-adds): ROADMAP A11b; the port "
        "runs its steal-only configuration")
