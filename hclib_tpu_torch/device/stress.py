"""Benchmark-scale multi-device workloads on one card: the forest steal
and the unified load.

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
warm-up run. ``unified_load`` (:149) runs the resident kernel's
migrating configuration: a skewed fib tree whose stolen rows with links
leave home proxies (their results return as remote completions, SUM's
value args rehydrated on the thief) beside remote fetch-adds from every
device, exact, scalar or with FIB routed through the batch tier.

Beside them, the dry run's phase 0 (``dryrun0``: fib, sum, BUMP and a
remote FADD through the same configuration) and the lock workload
(``lock_megakernel``, ``lock_builders``, ``check_locks``: a LOCKER on
every device contends device 0's lock block; each critical section's
compare-swap tripwire, observed by a parked row, shows an overlap as a
nonzero TEAR; a fetch-add and a compare-swap reply their old values).

And the user-body workloads of the mesh (no JAX counterpart
module; JAX writes these bodies in its tests and its multi-chip dry run):
``bump_megakernel`` and ``put_consume_megakernel``, the dry run's
tables of its phases 2-3 and 4 (``dryrun_builders``), and the PGAS
exchange ``pgas_megakernel`` / ``pgas_builders`` / ``check_pgas``: every
device first reads the words of its landing rows that its consumer will
read (PEEK, so a stale copy of them could sit in its cache), then sends
its left neighbour the active message that starts that neighbour's SEND:
an active message BUMP to every device and ``PGAS_ROWS`` puts of its
source rows into its ring neighbour's landing rows, whose consumer waits
on (channel 0, ``PGAS_ROWS``) and reads the landed rows' words.

And the fault plans' loads: JAX's fault tests' BUMP table and builders
(``fault_megakernel``, ``fault_resident``, ``skewed_builders``,
``spread_builders``, ``check_bump``; ``tests/test_device_faults.py``),
the two fixtures ``tests/test_torch_faults.py`` holds to JAX
(``FAULT_CREDITS``, ``FAULT_DEAD``, ``fault_run``), and the full-width
loads of ``chip_smoke.py``'s phase 30: UTS depth 20 on 16 devices with
a dead device and credit faults (``uts_fault``, ``UTS_FAULT``) and the
forest steal-only with its whole queue re-homed (``forest_fault``,
``FOREST_FAULT``).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

__all__ = ["forest_steal", "unified_load",
           "FOREST_STEAL_BENCH", "FOREST_STEAL_QUICK", "bump_megakernel",
           "pgas_megakernel", "pgas_builders", "check_pgas", "PGAS_ROWS",
           "PGAS_COLS", "put_consume_megakernel", "dryrun_builders",
           "unified_megakernel", "unified_builders", "unified_resident",
           "check_unified", "dryrun0_megakernel", "dryrun0",
           "lock_megakernel", "lock_builders", "check_locks",
           "compose_inject", "five_way", "volume", "inject_forest",
           "tenant_mesh", "INJECT_128", "TENANTS_128", "heap_data",
           "fault_megakernel", "fault_resident", "skewed_builders",
           "spread_builders", "check_bump", "fault_run", "uts_fault",
           "FAULT_CREDITS", "FAULT_DEAD", "UTS_FAULT", "UTS_FAULT_NODES",
           "FOREST_FAULT", "forest_fault", "ckpt_uts_resident",
           "ckpt_uts_builders", "ckpt_waits_resident", "ckpt_waits_load",
           "ckpt_bump_megakernel", "ckpt_inject_load", "uts_ckpt",
           "CKPT_UTS_NODES", "WAITS_TABLE"]

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
                      device="cuda", **kw):
    """The fib table of a forest of ``roots`` roots: every row's value
    block plus the root slots (at least 64); ``kw``: ``trace`` or
    ``checkpoint``."""
    from .megakernel import VBLOCK
    from .workloads import make_fib_megakernel

    return make_fib_megakernel(
        capacity=capacity, num_values=VBLOCK * capacity + max(64, roots),
        batch_width=batch_width or None, device=device, **kw)


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


# ---- homed migration and the remote atomics: unified_load, the dry
# run's phase 0 and the lock workload

FIB5, SUM5, FADD5 = 0, 1, 2  # unified_load's table


def _fadd2(ctx):
    ctx.pgas.fadd(0, 2, ctx.arg(0))


FADD2_CUDA = "ctx.pgas.fadd(0, 2, ctx.arg(0));"


def unified_megakernel(capacity: int = 1024, batch_width: int = 0,
                       device="cuda"):
    """unified_load's table: the built-in fib and sum, and FADD (a
    fire-and-forget fetch-add of arg 0 into device 0's slot 2); every
    row's value block, 16 host slots and one migration result slot a
    row."""
    from .megakernel import BatchSpec, Megakernel, VBLOCK

    return Megakernel(
        ["fib", "sum", ("fadd", _fadd2, FADD2_CUDA)], capacity=capacity,
        num_values=VBLOCK * capacity + 16 + capacity, succ_capacity=64,
        uses_row_values=True,
        route={"fib": BatchSpec(batch_width)} if batch_width else None,
        device=device)


def unified_builders(ndev: int, n: int, fadds: int):
    """FIB(n) on device 0 into slot 3, and FADDs 1..fadds dealt
    round-robin over the devices; 8 host slots reserved everywhere.
    Returns the builders and the sum of the increments."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    bs[0].add(FIB5, args=[n], out=3)
    for i in range(fadds):
        bs[i % ndev].add(FADD5, args=[i + 1])
    for b in bs:
        b.reserve_values(8)
    return bs, fadds * (fadds + 1) // 2


def unified_resident(mk, ndev: int, window: int = 8, device="cuda"):
    """The resident kernel of unified_load and the dry run's phase 0:
    homed migration of FIB, and of SUM with its two value args."""
    from ..parallel.mesh import CtaMesh
    from .resident import ResidentKernel

    return ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                          migratable_fns={FIB5: (), SUM5: (0, 1)},
                          window=window, am_window=8)


def check_unified(iv, info, n: int, fadds: int, total: int) -> int:
    """unified_load's exact totals; returns the task count: fib(n) in
    device 0's slot 3 (the root runs at home before the first
    exchange), every fetch-add applied once at the owner, executed the
    tree's FIB and SUM rows plus the FADDs, no proxy left."""
    from ..models.fib import fib_seq, task_count

    iv = np.asarray(iv)
    expect = task_count(n)
    expect += (expect - 1) // 2 + fadds
    if (info["pending"] != 0 or int(iv[:, 3].sum()) != fib_seq(n)
            or int(iv[0, 2]) != total or info["executed"] != expect
            or any(info["proxies"])):
        raise AssertionError(
            f"unified fib({n}) + {fadds} fetch-adds: slot 3 "
            f"{iv[:, 3].tolist()}, slot 2 {int(iv[0, 2])} (want "
            f"{total}), executed {info['executed']} (want {expect}), "
            f"pending {info['pending']}, proxies {info['proxies']}")
    return expect


def unified_load(
    ndev: int = 8,
    n: int = 10,
    fadds: int = 32,
    capacity: int = 1024,
    quantum: int = 32,
    window: int = 8,
    batch_width: int = 0,
    device="cuda",
) -> Dict:
    """Dependency-bearing migration and remote atomics under load in one
    resident kernel a device (JAX's ``unified_load``): a skewed fib(``n``)
    tree on device 0 (stolen rows with links leave home proxies, their
    results return as remote completions) and ``fadds`` fire-and-forget
    fetch-adds of device 0's slot 2 from every device. Totals exact.
    ``batch_width`` routes FIB through the batch tier inside the
    resident kernel; the info then carries per-device ``tiers``. A
    warm-up run on a tiny graph first (the build and the first launch);
    the timed run's host wall time, and its ``ivalues``."""
    mk = unified_megakernel(capacity, batch_width, device)
    rk = unified_resident(mk, ndev, window, device)
    wb, _ = unified_builders(ndev, 2, ndev)
    rk.run(wb, quantum=quantum)
    builders, total = unified_builders(ndev, n, fadds)
    t0 = time.perf_counter()
    iv, _, info = rk.run(builders, quantum=quantum)
    dt = time.perf_counter() - t0
    expect = check_unified(iv, info, n, fadds, total)
    per_dev = np.asarray(info["per_device_counts"])[:, 5]
    if batch_width:
        tiers = info["tiers"]
        batched = sum(t["batch_tasks"] for t in tiers)
        scalar = sum(t["scalar_tasks"] for t in tiers)
        assert batched + scalar == expect, (batched, scalar, expect)
        assert batched > 0, tiers
    info = dict(info)
    info.update(
        name=f"unified_load fib({n}) + {fadds} remote fetch-adds "
        f"on {ndev} devices"
        + (f" [batch w={batch_width}]" if batch_width else ""),
        seconds=dt,
        timer="host wall clock around a synchronised run",
        tasks=expect,
        tasks_per_sec=expect / dt,
        devices_used=int((per_dev > 0).sum()),
        imbalance=float(per_dev.max() * ndev / max(per_dev.sum(), 1)),
        per_device_counts=np.asarray(info["per_device_counts"]).tolist(),
        ivalues=iv,
    )
    return info


def dryrun0_megakernel(device="cuda"):
    """The multi-chip dry run's phase 0 table (__graft_entry__.py :95-112):
    fib, sum, BUMP (slot 0 += arg 0) and FADD (device 0's slot 2 +=
    arg 0, remotely); capacity 512, VBLOCK * 512 + 16 + 512 value slots
    (the row blocks, 16 host slots, the migration result slots)."""
    from .megakernel import Megakernel, VBLOCK

    return Megakernel(
        ["fib", "sum", ("bump", _bump0, BUMP0_CUDA),
         ("fadd", _fadd2, FADD2_CUDA)],
        capacity=512, num_values=VBLOCK * 512 + 16 + 512, succ_capacity=64,
        uses_row_values=True, device=device)


def dryrun0(ndev: int = 8, device="cuda"):
    """The dry run's phase 0 literally: fib(9) on device 0 into slot 3
    and FADD 7 on device 1 through the homed resident kernel (window 8,
    am_window 8, quantum 32); raises unless fib(9) = 34 landed home and
    the fetch-add at its owner. Returns (ivalues, info)."""
    from .descriptor import TaskGraphBuilder

    rk = unified_resident(dryrun0_megakernel(device), ndev, 8, device)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    bs[0].add(0, args=[9], out=3)
    bs[1 % ndev].add(3, args=[7])
    for b in bs:
        b.reserve_values(8)
    iv, _, info = rk.run(bs, quantum=32)
    if (info["pending"] != 0 or int(iv[0, 3]) != 34
            or int(iv[0, 2]) != 7):
        raise AssertionError(f"dry run phase 0: slot 3 {int(iv[0, 3])}, "
                             f"slot 2 {int(iv[0, 2])}")
    return iv, info


# The lock workload (JAX's test_resident_volume_stress_on_tpu lock part,
# and test_remote_atomics_and_lock's asker and swapper): one LOCKER on
# every device contends device 0's lock block.
LOCKER, CSECT, OBSERVE, ASKER, CONSUME_R, SWAPPER = range(6)
LK_X, LK_Y, LK_OCC, LK_TEAR, LK_RSLOT, LK_LBASE = 4, 5, 10, 11, 20, 32


def _locker(ctx):
    row = ctx.spawn(CSECT, args=[ctx.arg(0)], dep_count=1)
    ctx.pgas.lock(0, LK_LBASE, row, ctx.pgas.ndev)


def _csect(ctx):
    # The occupancy tripwire: cswap OCC 0 -> 1 on entry, observed by a
    # parked OBSERVE; the messages to device 0 are FIFO, so OCC is back
    # to 0 before the unlock grants the next waiter.
    s = ctx.arg(0)
    obs = ctx.spawn(OBSERVE, args=[s], dep_count=1)
    ctx.pgas.cswap(0, LK_OCC, 0, 1, obs, s)
    ctx.pgas.fadd(0, LK_X, 1)
    ctx.pgas.fadd(0, LK_Y, 1)
    ctx.pgas.fadd(0, LK_OCC, -1)
    ctx.pgas.unlock(0, LK_LBASE, ctx.pgas.ndev)


def _observe(ctx):
    ctx.pgas.fadd(0, LK_TEAR, ctx.value(ctx.arg(0)))


def _asker(ctx):
    row = ctx.spawn(CONSUME_R, args=[3], dep_count=1)
    ctx.pgas.fadd_get(0, 6, 10, row, 3)


def _consume_r(ctx):
    ctx.set_value(4, ctx.value(ctx.arg(0)))


def _swapper(ctx):
    row = ctx.spawn(CONSUME_R, args=[3], dep_count=1)
    ctx.pgas.cswap(0, 12, 55, 77, row, 3)


LOCK_TABLE = (
    ("locker", _locker, f"""
  const int a = ctx.arg(0);
  const int row = ctx.spawn({CSECT}, &a, 1, 1);
  ctx.pgas.lock(0, {LK_LBASE}, row, ctx.pgas.ndev);"""),
    ("csect", _csect, f"""
  const int s = ctx.arg(0);
  const int obs = ctx.spawn({OBSERVE}, &s, 1, 1);
  ctx.pgas.cswap(0, {LK_OCC}, 0, 1, obs, s);
  ctx.pgas.fadd(0, {LK_X}, 1);
  ctx.pgas.fadd(0, {LK_Y}, 1);
  ctx.pgas.fadd(0, {LK_OCC}, -1);
  ctx.pgas.unlock(0, {LK_LBASE}, ctx.pgas.ndev);"""),
    ("observe", _observe,
     f"ctx.pgas.fadd(0, {LK_TEAR}, ctx.value(ctx.arg(0)));"),
    ("asker", _asker, f"""
  const int a = 3;
  const int row = ctx.spawn({CONSUME_R}, &a, 1, 1);
  ctx.pgas.fadd_get(0, 6, 10, row, 3);"""),
    ("consume_r", _consume_r, "ctx.set_value(4, ctx.value(ctx.arg(0)));"),
    ("swapper", _swapper, f"""
  const int a = 3;
  const int row = ctx.spawn({CONSUME_R}, &a, 1, 1);
  ctx.pgas.cswap(0, 12, 55, 77, row, 3);"""),
)


def lock_megakernel(capacity: int = 64, device="cuda"):
    """The lock workload's table; the lock block of a 128-device mesh
    (lock_block_slots(128) slots at LK_LBASE) fits its 512 value
    slots."""
    from .megakernel import Megakernel

    return Megakernel(list(LOCK_TABLE), capacity=capacity, num_values=512,
                      succ_capacity=8, device=device)


def lock_builders(ndev: int):
    """A LOCKER on every device (reply slot LK_RSLOT), an ASKER on device
    1 and a SWAPPER on device 2 (meshes of three or more); the lock
    block reserved, and device 0's slots 6 and 12 preset to 100 and 55.
    Returns the builders and the value slots."""
    from .descriptor import TaskGraphBuilder
    from .resident import lock_block_slots

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for b in bs:
        b.add(LOCKER, args=[LK_RSLOT])
        b.reserve_values(LK_LBASE + lock_block_slots(ndev))
    bs[1 % ndev].add(ASKER)
    if ndev >= 3:
        bs[2].add(SWAPPER)
    iv = np.zeros((ndev, 512), np.int32)
    iv[0, 6], iv[0, 12] = 100, 55
    return bs, iv


def check_locks(iv, info, ndev: int) -> None:
    """Raise unless every critical section ran alone and once (X = Y =
    ndev, no observer saw OCC held, OCC back to 0), the lock ended
    released with its queue empty, the fetch-add and the compare-swap
    replied the old values, and the task count is exact."""
    iv = np.asarray(iv)
    ok = (iv[0, LK_X] == ndev and iv[0, LK_Y] == ndev
          and iv[0, LK_TEAR] == 0 and iv[0, LK_OCC] == 0
          and iv[0, LK_LBASE] == 0 and iv[0, LK_LBASE + 1] == 0
          and iv[0, 6] == 110 and iv[1 % ndev, 4] == 100
          and (ndev < 3 or (iv[0, 12] == 77 and iv[2, 4] == 55))
          and info["pending"] == 0
          and info["executed"] == 3 * ndev + 2 + 2 * (ndev >= 3))
    if not ok:
        raise AssertionError(
            f"locks on {ndev} devices: device 0 slots {iv[0, :16].tolist()}"
            f", lock block {iv[0, LK_LBASE:LK_LBASE + 3].tolist()}, "
            f"executed {info['executed']}")


# ---- user-body workloads: the dry run's bump table and the PGAS exchange

def _bump0(ctx):
    ctx.set_value(0, ctx.value(0) + ctx.arg(0))


BUMP0_CUDA = "ctx.set_value(0, ctx.value(0) + ctx.arg(0));"


def bump_megakernel(device="cuda", capacity: int = 256):
    """The multi-chip dry run's phases 2 and 3 table (__graft_entry__.py
    :162): one user body, BUMP (F_FN 0), adding arg 0 into value slot 0;
    capacity 256, 4 value slots."""
    from .megakernel import Megakernel

    return Megakernel([("bump", _bump0, BUMP0_CUDA)], capacity=capacity,
                      num_values=4, succ_capacity=8, device=device)


# The heap a device: PGAS_ROWS source rows, then PGAS_ROWS rows the left
# neighbour's puts land in (disjoint, so no put reads a row another
# writes: the SHMEM contract JAX's put keeps).
def _put_k(ctx):
    ctx.pgas.put(ctx.arg(0), 0, 0, 0)
    ctx.pgas.am(ctx.arg(0), 1, args=[1])


def _consume_k(ctx):
    ctx.set_value(ctx.arg(0), ctx.pgas.count(0))


def put_consume_megakernel(device="cuda"):
    """The multi-chip dry run's phase 4 table (__graft_entry__.py :192):
    PUT (F_FN 0: put my heap row 0 into device arg0's row 0 on channel 0,
    then AM a CONSUME [1] there) and CONSUME (slot arg0 = channel 0's
    count); a (4, 128) int32 heap, capacity 64, 8 value slots."""
    import torch

    from .megakernel import Megakernel

    return Megakernel(
        [("put", _put_k, "ctx.pgas.put(ctx.arg(0), 0, 0, 0);\n"
          "  const int a = 1;\n  ctx.pgas.am(ctx.arg(0), 1, &a, 1);"),
         ("consume", _consume_k,
          "ctx.set_value(ctx.arg(0), ctx.pgas.count(0));")],
        data_specs={"heap": ((4, 128), torch.int32)}, capacity=64,
        num_values=8, succ_capacity=8, device=device)


def dryrun_builders(phase: int, ndev: int):
    """The dry run's builders of phase 2 or 3 (8 * ndev BUMPs 1, 2, ...
    on device 0; returns the builders) or 4 (every device a PUT at its
    right neighbour and a CONSUME [0] parked on (channel 0, 1); returns
    the builders, the waits and the zero heap)."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    if phase in (2, 3):
        for i in range(8 * ndev):
            bs[0].add(0, args=[i + 1])
        return bs
    waits = []
    for d, b in enumerate(bs):
        b.add(0, args=[(d + 1) % ndev])
        waits.append([(0, 1, b.add(1, args=[0]))])
    return bs, waits, np.zeros((ndev, 4, 128), np.int32)


PGAS_ROWS, PGAS_COLS = 16, 128
SEND, PBUMP, CONSUME, BURST, PEEK = 0, 1, 2, 3, 4


def _send(ctx):
    p = ctx.pgas
    for d in range(p.ndev):
        p.am(d, PBUMP, args=[0, 1 + p.me])
    for r in range(PGAS_ROWS):
        p.put((p.me + 1) % p.ndev, 0, PGAS_ROWS + r, r)


def _pbump(ctx):
    ctx.set_value(ctx.arg(0), ctx.value(ctx.arg(0)) + ctx.arg(1))


def _landed_sum(ctx) -> int:
    h = ctx.data["heap"]
    return sum(int(h[PGAS_ROWS + r, r]) for r in range(PGAS_ROWS))


def _consume(ctx):
    ctx.set_value(1, ctx.pgas.count(0))
    ctx.set_value(2, _landed_sum(ctx))


def _peek(ctx):
    ctx.set_value(5, _landed_sum(ctx))
    ctx.pgas.am((ctx.pgas.me - 1) % ctx.pgas.ndev, SEND)


def _burst(ctx):
    for i in range(6):
        ctx.pgas.am(ctx.arg(0), PBUMP, args=[3, 1 + i])


PGAS_TABLE = (
    ("send", _send, f"""
  for (int d = 0; d < ctx.pgas.ndev; ++d) {{
    const int a[2] = {{0, 1 + ctx.pgas.me}};
    ctx.pgas.am(d, {PBUMP}, a, 2);
  }}
  const int right = (ctx.pgas.me + 1) % ctx.pgas.ndev;
  for (int r = 0; r < {PGAS_ROWS}; ++r)
    ctx.pgas.put(right, 0, {PGAS_ROWS} + r, r);"""),
    ("bump", _pbump,
     "ctx.set_value(ctx.arg(0), ctx.value(ctx.arg(0)) + ctx.arg(1));"),
    ("consume", _consume, f"""
  const int* h = ctx.data(0);
  int s = 0;
  for (int r = 0; r < {PGAS_ROWS}; ++r)
    s += h[({PGAS_ROWS} + r) * {PGAS_COLS} + r];
  ctx.set_value(1, ctx.pgas.count(0));
  ctx.set_value(2, s);"""),
    ("burst", _burst, f"""
  for (int i = 0; i < 6; ++i) {{
    const int a[2] = {{3, 1 + i}};
    ctx.pgas.am(ctx.arg(0), {PBUMP}, a, 2);
  }}"""),
    ("peek", _peek, f"""
  const int* h = ctx.data(0);
  int s = 0;
  for (int r = 0; r < {PGAS_ROWS}; ++r)
    s += h[({PGAS_ROWS} + r) * {PGAS_COLS} + r];
  ctx.set_value(5, s);
  const int n = ctx.pgas.ndev;
  ctx.pgas.am((ctx.pgas.me + n - 1) % n, {SEND});"""),
)


def pgas_megakernel(capacity: int = 512, device="cuda", trace=None):
    """The PGAS exchange's table: SEND (an active message BUMP [0, 1 +
    me] to every device, then PGAS_ROWS one-row puts of my rows r ->
    my ring neighbour's row PGAS_ROWS + r on channel 0), BUMP (slot arg0
    += arg1), CONSUME (slot 1 = channel 0's count, slot 2 = the sum of
    word r of each landed row PGAS_ROWS + r), BURST (six BUMPs of slot 3
    at device arg0) and PEEK (slot 5 = the sum CONSUME reads, taken
    before any put lands, then an active message SEND to my left
    neighbour, the device whose puts land here); a (2 PGAS_ROWS,
    PGAS_COLS) int32 heap a device. On the card PEEK's plain loads leave
    the landing rows' lines in its SM's cache, so CONSUME's sum shows
    whether the receive drain's acquire makes the landed words visible.
    ``trace``: a recorder of that many records a device."""
    import torch

    from .megakernel import Megakernel

    return Megakernel(list(PGAS_TABLE),
                      data_specs={"heap": ((2 * PGAS_ROWS, PGAS_COLS),
                                           torch.int32)},
                      capacity=capacity, num_values=8, succ_capacity=8,
                      trace=trace, device=device)


def pgas_builders(ndev: int, burst: bool = False, bumps: int = 0):
    """Every device: PEEK, and CONSUME parked on (channel 0, PGAS_ROWS)
    (the host waits, returned beside the builders); with ``burst``, a
    BURST at the last device on device 0; with ``bumps``, that many
    BUMPs of slot 4 (1, 2, ...) on device 0 (a load to steal). Also the
    heap: device d's row r holds 1000 * d + r."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    waits = []
    for d, b in enumerate(bs):
        b.add(PEEK)
        waits.append([(0, PGAS_ROWS, b.add(CONSUME))])
        b.reserve_values(6)
    if burst:
        bs[0].add(BURST, args=[ndev - 1])
    for i in range(bumps):
        bs[0].add(PBUMP, args=[4, i + 1])
    heap = (1000 * np.arange(ndev, dtype=np.int32)[:, None, None]
            + np.arange(2 * PGAS_ROWS, dtype=np.int32)[None, :, None]
            + np.zeros((1, 1, PGAS_COLS), np.int32))
    return bs, waits, heap


def check_pgas(iv, heap_out, info, ndev: int, burst: bool = False,
               bumps: int = 0) -> None:
    """Raise unless the PGAS exchange is exact: every device's slot 0 the
    sum of every sender's 1 + me, its consumer's count PGAS_ROWS and its
    sum that of its left neighbour's rows, its PEEK's sum that of its
    own landing rows before the puts, its landing rows the neighbour's
    source rows and its own rows untouched, the burst's and the bumps'
    totals, and the message and put counts."""
    iv = np.asarray(iv)
    want0 = ndev * (ndev + 1) // 2
    for d in range(ndev):
        src = (d - 1) % ndev
        tri = PGAS_ROWS * (PGAS_ROWS - 1) // 2
        if iv[d, 0] != want0 or iv[d, 1] != PGAS_ROWS or iv[d, 2] != (
                PGAS_ROWS * 1000 * src + tri) or iv[d, 5] != (
                PGAS_ROWS * (1000 * d + PGAS_ROWS) + tri):
            raise AssertionError(f"pgas device {d}: slots {iv[d, :6]}")
        rows = np.arange(PGAS_ROWS)[:, None]
        if not ((heap_out[d, PGAS_ROWS:] == 1000 * src + rows).all()
                and (heap_out[d, :PGAS_ROWS] == 1000 * d + rows).all()):
            raise AssertionError(f"pgas device {d}: heap not its "
                                 "neighbour's rows")
    if burst and iv[ndev - 1, 3] != 21:
        raise AssertionError(f"pgas burst: {iv[ndev - 1, 3]}")
    if int(iv[:, 4].sum()) != bumps * (bumps + 1) // 2:
        raise AssertionError(f"pgas bumps: {iv[:, 4].tolist()}")
    ex = info["exchange"]
    if sum(ex["ams"]) != ndev * ndev + ndev + 6 * burst or sum(
            ex["puts"]) != ndev * PGAS_ROWS:
        raise AssertionError(f"pgas messages {ex['ams']}, puts {ex['puts']}")
    if info["pending"] != 0:
        raise AssertionError(f"pgas pending {info['pending']}")


# ---- the injection ring and mesh tenancy: JAX's three resident
# compositions that inject (tests/test_resident.py :238, :420, :472) and
# the full-width forest and tenant loads of chip_smoke.py's phase 29.

HEAP_ROWS, HEAP_COLS = 8, 128  # tests/test_resident.py ROWS, COLS
CBUMP, CPUT, CCONSUME = range(3)  # the composition's table


def _cbump(ctx):
    ctx.set_value(0, ctx.value(0) + ctx.arg(0))


def _cput(ctx):
    ctx.pgas.put(ctx.arg(0), 0, ctx.arg(1), ctx.arg(2))


def _cconsume(ctx):
    ctx.set_value(ctx.arg(0), ctx.pgas.count(0))


COMPOSE_TABLE = (
    ("bump", _cbump, BUMP0_CUDA),
    ("put", _cput, "ctx.pgas.put(ctx.arg(0), 0, ctx.arg(1), ctx.arg(2));"),
    ("consume", _cconsume, "ctx.set_value(ctx.arg(0), ctx.pgas.count(0));"),
)


def heap_data(ndev: int) -> np.ndarray:
    """tests/test_resident.py _heap: row r of device d holds 1000 d + r."""
    h = np.zeros((ndev, HEAP_ROWS, HEAP_COLS), np.int32)
    for d in range(ndev):
        h[d] = 1000 * d + np.arange(HEAP_ROWS, dtype=np.int32)[:, None]
    return h


def _heap_spec():
    import torch

    return {"heap": ((HEAP_ROWS, HEAP_COLS), torch.int32)}


def compose_inject(ndev: int = 4, ntasks: int = 24, device="cuda"):
    """test_steal_pgas_and_injection_coexist: steal, a put with its
    parked consumer and injected stream rows in one kernel a device (24
    skewed BUMPs on device 0 migrate homed; device 0 puts its heap row 2
    into device 1's row 3; BUMPs 1000, 2000 and 3000 injected on devices
    0, 2 and 3). Held to JAX's assertions; returns (ivalues, data,
    info)."""
    from ..parallel.mesh import CtaMesh
    from .descriptor import TaskGraphBuilder
    from .megakernel import Megakernel
    from .resident import ResidentKernel

    mk = Megakernel(list(COMPOSE_TABLE), data_specs=_heap_spec(),
                    capacity=128, num_values=512, succ_capacity=8,
                    device=device)
    rk = ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                        migratable_fns=[CBUMP], channels={"c0": ("heap", 1)},
                        inject=True, window=4)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for i in range(ntasks):
        bs[0].add(CBUMP, args=[i + 1])
    bs[0].add(CPUT, args=[1, 3, 2])
    t = bs[1].add(CCONSUME, args=[1])
    waits = [[] for _ in range(ndev)]
    waits[1] = [(0, 1, t)]
    rows = [[] for _ in range(ndev)]
    for d, v in ((0, 1000), (2, 2000), (3, 3000)):
        rows[d % ndev].append((CBUMP, [v]))
    iv, data, info = rk.run(bs, data={"heap": heap_data(ndev)}, waits=waits,
                            inject_rows=rows, quantum=4)
    iv = np.asarray(iv)
    heap = data["heap"].cpu().numpy()
    per_dev = np.asarray(info["per_device_counts"])[:, 5]
    ok = (info["pending"] == 0
          and int(iv[:, 0].sum()) == ntasks * (ntasks + 1) // 2 + 6000
          and (heap[1, 3] == 2).all() and iv[1, 1] == 1
          and int((per_dev > 0).sum()) >= min(3, ndev))
    if not ok:
        raise AssertionError(
            f"compose on {ndev}: slot 0 {iv[:, 0].tolist()}, consumer "
            f"{iv[1, 1]}, executed per device {per_dev.tolist()}")
    return iv, data, info


FW_LBASE, FW_QCAP, FW_BUMP = 16, 2, 2  # the five-way composition


def _fw_start(ctx):
    ctx.pgas.fadd(0, 5, 7)
    row = ctx.spawn(1, dep_count=1)
    ctx.pgas.lock(0, FW_LBASE, row, FW_QCAP)
    ctx.pgas.put(0, 0, 3, 2)  # self-put row 2 -> row 3


def _fw_csect(ctx):
    ctx.pgas.fadd(0, 5, 30)
    ctx.pgas.unlock(0, FW_LBASE, FW_QCAP)


def _fw_bump(ctx):
    ctx.set_value(6, ctx.value(6) + ctx.arg(0))


FIVE_WAY_TABLE = (
    ("start", _fw_start, f"""
  ctx.pgas.fadd(0, 5, 7);
  const int row = ctx.spawn(1, nullptr, 0, 1);
  ctx.pgas.lock(0, {FW_LBASE}, row, {FW_QCAP});
  ctx.pgas.put(0, 0, 3, 2);"""),
    ("csect", _fw_csect, f"""
  ctx.pgas.fadd(0, 5, 30);
  ctx.pgas.unlock(0, {FW_LBASE}, {FW_QCAP});"""),
    ("bump", _fw_bump, "ctx.set_value(6, ctx.value(6) + ctx.arg(0));"),
)


def five_way(device="cuda"):
    """test_resident_compiles_and_runs_on_tpu (JAX runs it only on a
    TPU): steal, a self-put, a fetch-add, a lock and an injected stream
    in one kernel on one device; iv[0, 5] == 37, iv[0, 6] == 42, the put
    landed. Returns (ivalues, data, info)."""
    from ..parallel.mesh import CtaMesh
    from .descriptor import TaskGraphBuilder
    from .megakernel import Megakernel
    from .resident import ResidentKernel, lock_block_slots

    mk = Megakernel(list(FIVE_WAY_TABLE), data_specs=_heap_spec(),
                    capacity=64, num_values=256, succ_capacity=8,
                    device=device)
    rk = ResidentKernel(mk, CtaMesh((1,), ("q",), device=device),
                        channels={"c0": ("heap", 1)}, steal=True,
                        migratable_fns=[0], inject=True)
    b = TaskGraphBuilder()
    b.add(0)
    b.reserve_values(FW_LBASE + lock_block_slots(FW_QCAP))
    iv, data, info = rk.run(
        [b], data={"heap": heap_data(1)}, quantum=8,
        inject_rows=[[(FW_BUMP, [41]), (FW_BUMP, [1])]])
    iv = np.asarray(iv)
    if not (iv[0, 5] == 37 and iv[0, 6] == 42
            and (data["heap"].cpu().numpy()[0, 3] == 2).all()
            and info["pending"] == 0):
        raise AssertionError(f"five-way: slots {iv[0, :8].tolist()}")
    return iv, data, info


# The volume stress test (test_resident_volume_stress_on_tpu).
(VFIB, VSUM, VBUMP, VFADDER, VLOCKER, VCSECT, VPUT, VCONSUME,
 VOBS) = range(9)
V_QCAP, V_LBASE, V_FADD_SLOT, V_X, V_Y, V_OCC, V_TEAR, V_RS0 = (
    8, 32, 2, 4, 5, 10, 11, 20)
V_FADDERS, V_PER_FADDER, V_LOCKERS, V_INJECT, V_PUTS = 16, 4, 8, 64, 4


def _v_fadder(ctx):
    for _ in range(V_PER_FADDER):
        ctx.pgas.fadd(0, V_FADD_SLOT, ctx.arg(0))


def _v_locker(ctx):
    row = ctx.spawn(VCSECT, args=[ctx.arg(0)], dep_count=1)
    ctx.pgas.lock(0, V_LBASE, row, V_QCAP)


def _v_csect(ctx):
    s = ctx.arg(0)
    obs = ctx.spawn(VOBS, args=[s], dep_count=1)
    ctx.pgas.cswap(0, V_OCC, 0, 1, obs, s)
    ctx.pgas.fadd(0, V_X, 1)
    ctx.pgas.fadd(0, V_Y, 1)
    ctx.pgas.fadd(0, V_OCC, -1)
    ctx.pgas.unlock(0, V_LBASE, V_QCAP)


def _v_observe(ctx):
    ctx.pgas.fadd(0, V_TEAR, ctx.value(ctx.arg(0)))


def _v_put(ctx):
    ctx.pgas.put(0, 0, ctx.arg(0), 0)  # my row 0 -> row arg0


def _v_consume(ctx):
    ctx.set_value(6, ctx.pgas.count(0))


def _v_bump(ctx):
    ctx.set_value(7, ctx.value(7) + ctx.arg(0))


VOLUME_TABLE = (
    "fib", "sum",
    ("bump", _v_bump, "ctx.set_value(7, ctx.value(7) + ctx.arg(0));"),
    ("fadder", _v_fadder, f"""
  for (int i = 0; i < {V_PER_FADDER}; ++i)
    ctx.pgas.fadd(0, {V_FADD_SLOT}, ctx.arg(0));"""),
    ("locker", _v_locker, f"""
  const int a = ctx.arg(0);
  const int row = ctx.spawn({VCSECT}, &a, 1, 1);
  ctx.pgas.lock(0, {V_LBASE}, row, {V_QCAP});"""),
    ("csect", _v_csect, f"""
  const int s = ctx.arg(0);
  const int obs = ctx.spawn({VOBS}, &s, 1, 1);
  ctx.pgas.cswap(0, {V_OCC}, 0, 1, obs, s);
  ctx.pgas.fadd(0, {V_X}, 1);
  ctx.pgas.fadd(0, {V_Y}, 1);
  ctx.pgas.fadd(0, {V_OCC}, -1);
  ctx.pgas.unlock(0, {V_LBASE}, {V_QCAP});"""),
    ("put", _v_put, "ctx.pgas.put(0, 0, ctx.arg(0), 0);"),
    ("consume", _v_consume, "ctx.set_value(6, ctx.pgas.count(0));"),
    ("observe", _v_observe,
     f"ctx.pgas.fadd(0, {V_TEAR}, ctx.value(ctx.arg(0)));"),
)


def volume(n: int = 14, device="cuda"):
    """test_resident_volume_stress_on_tpu (JAX runs it only on a TPU):
    fib(n) through a 512-row table (homed FIB and SUM with its value
    args), 64 fetch-adds from 16 senders through the outbox pacer, 8
    lockers contending one lock FIFO whose critical sections trip a
    compare-swap occupancy wire (TEAR stays 0), a consumer parked on 4
    self-puts and a 64-row injected stream, on one device; every JAX
    assertion, the executed count exact. Returns (ivalues, data,
    info)."""
    from ..models.fib import fib_seq, task_count
    from ..parallel.mesh import CtaMesh
    from .descriptor import TaskGraphBuilder
    from .megakernel import VBLOCK, Megakernel
    from .resident import ResidentKernel, lock_block_slots

    cap = 512
    mk = Megakernel(list(VOLUME_TABLE), data_specs=_heap_spec(),
                    capacity=cap, num_values=VBLOCK * cap + 64 + cap,
                    succ_capacity=64, uses_row_values=True, device=device)
    rk = ResidentKernel(mk, CtaMesh((1,), ("q",), device=device),
                        migratable_fns={VFIB: (), VSUM: (0, 1)},
                        channels={"c0": ("heap", 1)}, inject=True,
                        window=8, am_window=8, outbox=128)
    b = TaskGraphBuilder()
    b.add(VFIB, args=[n], out=3)
    for i in range(V_FADDERS):
        b.add(VFADDER, args=[i + 1])
    for i in range(V_LOCKERS):
        b.add(VLOCKER, args=[V_RS0 + i])
    for r in range(V_PUTS):
        b.add(VPUT, args=[2 + r])
    t = b.add(VCONSUME)
    b.reserve_values(V_LBASE + lock_block_slots(V_QCAP))
    iv, data, info = rk.run(
        [b], data={"heap": heap_data(1)}, waits=[[(0, V_PUTS, t)]],
        inject_rows=[[(VBUMP, [j + 1]) for j in range(V_INJECT)]],
        quantum=4)
    iv = np.asarray(iv)
    heap = data["heap"].cpu().numpy()
    t_n = task_count(n)
    ok = (info["pending"] == 0 and int(iv[0, 3]) == fib_seq(n)
          and int(iv[0, V_FADD_SLOT]) == V_PER_FADDER * V_FADDERS * (
              V_FADDERS + 1) // 2
          and int(iv[0, V_X]) == V_LOCKERS and int(iv[0, V_Y]) == V_LOCKERS
          and int(iv[0, V_TEAR]) == 0 and int(iv[0, V_OCC]) == 0
          and int(iv[0, V_LBASE]) == 0 and int(iv[0, V_LBASE + 1]) == 0
          and int(iv[0, 7]) == V_INJECT * (V_INJECT + 1) // 2
          and int(iv[0, 6]) == V_PUTS
          and all((heap[0, 2 + r] == 0).all() for r in range(V_PUTS))
          and info["executed"] == (t_n + (t_n - 1) // 2 + V_FADDERS
                                   + 3 * V_LOCKERS + V_PUTS + 1 + V_INJECT))
    if not ok:
        raise AssertionError(f"volume: slots {iv[0, :12].tolist()}, "
                             f"executed {info['executed']}")
    return iv, data, info


INJECT_128 = dict(ndev=128, roots=160, n=12, per_dev=256, n_inj=4,
                  capacity=4096)


def inject_forest(ndev: int = 128, roots: int = 160, n: int = 12,
                  per_dev: int = 256, n_inj: int = 4, capacity: int = 4096,
                  quantum: int = 64, window: int = 8, device="cuda",
                  quiesce=None):
    """The forest of ``roots`` FIB(n) roots on device 0 through the
    resident kernel steal-only (homed=False), and ``per_dev`` FIB(n_inj)
    rows on every device's injection ring, row j of device d writing host
    slot roots + d * per_dev + j (a migrated row writes it on the
    thief). With ``quiesce`` (a checkpoint build) the run is quiesced
    there, every device's consumed cursor plus its ring residue must
    equal the rows published, and the exported state is resumed (its
    info under the resumed run's ``quiesce_run``). The forest and the
    injected totals exact. Returns (ivalues, info)."""
    from ..models.fib import fib_seq, task_count
    from ..parallel.mesh import CtaMesh
    from .descriptor import TaskGraphBuilder
    from .megakernel import VBLOCK
    from .resident import ResidentKernel
    from .workloads import FIB, make_fib_megakernel

    nv = roots + ndev * per_dev
    mk = make_fib_megakernel(capacity,
                             num_values=VBLOCK * capacity + max(64, nv),
                             checkpoint=quiesce is not None, device=device)
    rk = ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                        migratable_fns=[FIB], homed=False, window=window,
                        inject=True, ring_capacity=per_dev)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for r in range(roots):
        bs[0].add(FIB, args=[n], out=r)
    for b in bs:
        b.reserve_values(nv)
    rows = [[(FIB, [n_inj], roots + d * per_dev + j) for j in range(per_dev)]
            for d in range(ndev)]
    if quiesce is None:
        iv, _, info = rk.run(bs, inject_rows=rows, quantum=quantum)
    else:
        _, _, info_q = rk.run(bs, inject_rows=rows, quantum=quantum,
                              quiesce=quiesce)
        ic, res = info_q["inject_ctl"], info_q["state"]["ictl"][:, 0]
        if not info_q["quiesced"] or (ic[:, 2] + res != ic[:, 0]).any():
            raise AssertionError(
                f"inject forest quiesced at {quiesce}: consumed "
                f"{ic[:, 2].tolist()} + residue {res.tolist()} != "
                f"published {ic[:, 0].tolist()}")
        iv, _, info = rk.run(resume_state=info_q["state"], quantum=quantum)
        info["quiesce_run"] = info_q
    iv = np.asarray(iv)

    def per(k):
        t = task_count(k)
        return t + (t - 1) // 2

    want = roots * per(n) + ndev * per_dev * per(n_inj)
    got_f = int(iv[:, :roots].sum(dtype=np.int64))
    got_i = int(iv[:, roots:nv].sum(dtype=np.int64))
    if (info["pending"] != 0 or info["executed"] != want
            or got_f != roots * fib_seq(n)
            or got_i != ndev * per_dev * fib_seq(n_inj)):
        raise AssertionError(
            f"inject forest on {ndev}: executed {info['executed']} (want "
            f"{want}), forest {got_f}, injected {got_i}")
    return iv, info


# (tenant, weight, admissions on 128 devices): the last one's deadline
# lapses before the launch (tests/test_tenants.py :1051, first half,
# scaled, with a late lane).
TENANTS_128 = (("gold", 4, 3072), ("std", 2, 2048), ("bg", 1, 1024),
               ("late", 1, 512))


def tenant_mesh(ndev: int = 128, lanes=TENANTS_128, ring_capacity: int = 128,
                capacity: int = 256, quantum: int = 8, window: int = 4,
                device="cuda"):
    """Mesh tenancy through the resident kernel steal-only (homed=False,
    BUMP migratable): a MeshTenantTable on a fake clock routes every
    lane's admissions (BUMP of lane index + 1) over the devices; the last
    lane's rows (BUMP 1 << 16, deadline 1 s) are published by an earlier
    pump and the clock passes their deadline before the launch, so the
    launch's pump marks them TEN_EXPIRED and the card's poll drops them.
    Every other admission installs once (the BUMP total exact) and per
    tenant accepted == completed + expired + dropped + backlog. One BUMP
    0 seeds every device. Returns (ivalues, info)."""
    from ..parallel.mesh import CtaMesh
    from .descriptor import RING_ROW, TaskGraphBuilder
    from .resident import ResidentKernel
    from .tenants import MeshTenantTable, TenantSpec

    rk = ResidentKernel(bump_megakernel(device, capacity),
                        CtaMesh((ndev,), ("q",), device=device),
                        migratable_fns=[0], homed=False, window=window,
                        inject=True, ring_capacity=ring_capacity,
                        tenants=[TenantSpec(t, weight=w)
                                 for t, w, _ in lanes])
    now = [100.0]
    table = MeshTenantTable(rk.tenant_specs, ndev, rk.region_rows,
                            clock=lambda: now[0])
    late, n_late = lanes[-1][0], lanes[-1][2]
    for _ in range(n_late):
        if not table.submit(late, 0, args=[1 << 16], deadline_s=1.0):
            raise AssertionError(f"tenant {late}: admission refused")
    table.pump(np.zeros((ndev, rk.ring_capacity, RING_ROW), np.int32))
    now[0] += 2.0
    total = 0
    for i, (tid, _, n) in enumerate(lanes[:-1]):
        for _ in range(n):
            if not table.submit(tid, 0, args=[i + 1]):
                raise AssertionError(f"tenant {tid}: admission refused")
        total += n * (i + 1)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for b in bs:
        b.add(0, args=[0])
    iv, _, info = rk.run(bs, quantum=quantum, tenant_table=table)
    iv = np.asarray(iv)
    ten = info["tenants"]
    bad = [t for t, s in ten.items()
           if s["accepted"] != s["completed"] + s["expired"] + s["dropped"]
           + s["backlog"]]
    exp = sum(f["tenant_expired"] for f in info["fault_stats"])
    if (bad or info["pending"] != 0 or int(iv[:, 0].sum()) != total
            or exp != n_late or ten[late]["expired"] != n_late
            or any(ten[t]["completed"] != n for t, _, n in lanes[:-1])):
        raise AssertionError(
            f"tenants on {ndev}: total {int(iv[:, 0].sum())} (want {total}),"
            f" expired on the card {exp}, unbalanced {bad}, stats {ten}")
    return iv, info


# ---- fault plans: JAX's device-fault tests' table and loads
# (tests/test_device_faults.py), and UTS under a dead device at full width

# The two fixtures of tests/test_torch_faults.py, each the fewest rounds
# that show its faults: 13 BUMPs on device 0 of 2 with a credit dropped
# at (1, 0, 1), one duplicated at (0, 0, 1) and delays (5 rounds, the
# drop regenerated at round 4); 6 BUMPs on device 1 of 4, which dies at
# round 1 (3 rounds, a row re-homed, quarantined at round 2).
FAULT_CREDITS = dict(ndev=2, ntasks=13, dev=0, capacity=128, plan=dict(
    seed=3, drop_credit_at=[(1, 0, 1)], dup_credit_at=[(0, 0, 1)],
    delay_xfer_rate=0.25, credit_timeout=2))
FAULT_DEAD = dict(ndev=4, ntasks=6, dev=1, capacity=64, plan=dict(
    seed=7, dead_device=1, dead_round=1, heartbeat_timeout=2))
# Row 1's UTS tree (max_depth 20, seed 19, q 440, m 4: 498,965 nodes from
# its one root on device 0) on the widest power-of-two mesh a plan allows
# (31 devices at most, so 16 CTAs; uts_fault): device 0 dies at round 2
# holding queued rows, and every round's credits may drop, double or
# delay (the plan).
UTS_FAULT_NODES = 498965
UTS_FAULT = dict(seed=29, drop_credit_rate=0.001, dup_credit_rate=0.001,
                 delay_xfer_rate=0.01, dead_device=0, dead_round=2,
                 credit_timeout=2, heartbeat_timeout=2)


def fault_megakernel(capacity: int = 128, device="cuda"):
    """JAX's fault tests' table (``_bump_mk``): one user body, BUMP (F_FN
    0), adding arg 0 into value slot 0; 1,024 value slots."""
    from .megakernel import Megakernel

    return Megakernel([("bump", _bump0, BUMP0_CUDA)], capacity=capacity,
                      num_values=1024, succ_capacity=8, device=device)


def fault_resident(ndev: int, plan=None, capacity: int = 192,
                   window: int = 4, device="cuda"):
    """JAX's ``_mesh_rk``: BUMP migratable under homed migration (the
    migrating configuration), window 4, ``plan`` a DeviceFaultPlan."""
    from ..parallel.mesh import CtaMesh
    from .resident import ResidentKernel

    return ResidentKernel(fault_megakernel(capacity, device),
                          CtaMesh((ndev,), ("q",), device=device),
                          migratable_fns=[0], window=window, fault_plan=plan)


def skewed_builders(ndev: int, ntasks: int, dev: int = 0):
    """``ntasks`` BUMPs of 1..ntasks on device ``dev`` (JAX's
    ``_skewed``)."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for i in range(ntasks):
        bs[dev].add(0, args=[i + 1])
    return bs


def spread_builders(ndev: int, per: int):
    """``per`` BUMPs on every device, numbered 1.. in device order (JAX's
    dead-chip test); returns (builders, their sum)."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    v = 0
    for b in bs:
        for _ in range(per):
            v += 1
            b.add(0, args=[v])
    return bs, v * (v + 1) // 2


def check_bump(iv, info, ntasks: int, total: int) -> None:
    """JAX's totals: drained, every task once, every effect landed once."""
    got = int(np.asarray(iv)[:, 0].sum())
    if info["pending"] != 0 or info["executed"] != ntasks or got != total:
        raise AssertionError(
            f"bump under faults: pending {info['pending']}, executed "
            f"{info['executed']} (want {ntasks}), total {got} (want {total})")


def fault_run(name: str, device="cuda"):
    """The fixture ``name`` (``"credits"``: FAULT_CREDITS, ``"dead"``:
    FAULT_DEAD) on ``device``, exact; returns (ivalues, info)."""
    from ..runtime.resilience import DeviceFaultPlan

    cfg = FAULT_CREDITS if name == "credits" else FAULT_DEAD
    rk = fault_resident(cfg["ndev"], DeviceFaultPlan(**cfg["plan"]),
                        cfg["capacity"], device=device)
    n = cfg["ntasks"]
    iv, _, info = rk.run(skewed_builders(cfg["ndev"], n, cfg["dev"]),
                         quantum=2, max_rounds=4096)
    check_bump(iv, info, n, n * (n + 1) // 2)
    return iv, info


def uts_fault(ndev: int = 16, max_depth: int = 20, quantum: int = 64,
              window: int = 8, plan=None, device="cuda"):
    """Row 1's UTS tree from its root on device 0 under ``plan`` (a dict
    of DeviceFaultPlan arguments; UTS_FAULT by default), UTS_NODE
    migratable under homed migration: its rows are link-free (slot 0, the
    node count, is a host slot), so each moves whole and may move again,
    and a dead device's queue re-homes. (Steal-only, ``homed=False``,
    only builder-made rows migrate, in JAX as here: a spawned row keeps
    F_HOME 0, so the tree would stay on device 0.) Returns (ivalues,
    info)."""
    from ..parallel.mesh import CtaMesh
    from ..runtime.resilience import DeviceFaultPlan
    from .descriptor import TaskGraphBuilder
    from .megakernel import Megakernel
    from .resident import ResidentKernel
    from .workloads import UTS_NODE

    plan = DeviceFaultPlan(**(UTS_FAULT if plan is None else plan))
    cap = 1024
    # make_uts_megakernel's table, with one migration result slot a row.
    mk = Megakernel(kernels=["uts_node"], capacity=cap, num_values=16 + cap,
                    succ_capacity=8,
                    params={"seed": 19, "q_millis": 440, "m_children": 4,
                            "max_depth": max_depth}, device=device)
    rk = ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                        migratable_fns=[UTS_NODE], window=window,
                        fault_plan=plan)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    bs[0].add(UTS_NODE, args=[1, 0])
    for b in bs:
        b.reserve_values(1)
    iv, _, info = rk.run(bs, quantum=quantum)
    return iv, info


# FOREST_STEAL_BENCH's forest steal-only through ICIStealMegakernel on 16
# CTAs (forest_fault): device 0, which holds every root, dies at round 0
# and re-homes its whole queue (builder-made roots migrate steal-only),
# under the same credit faults as UTS_FAULT (the plan).
FOREST_FAULT = dict(UTS_FAULT, dead_round=0)


def forest_fault(ndev: int = 16, roots: int = 160, n: int = 12,
                 capacity: int = 4096, quantum: int = 64, plan=None,
                 device="cuda"):
    """The forest steal-only (``ICIStealMegakernel``, FIB migratable,
    window 8) under ``plan`` (FOREST_FAULT by default), exact; returns
    (ivalues, info)."""
    from ..parallel.mesh import CtaMesh
    from ..runtime.resilience import DeviceFaultPlan
    from .ici_steal import ICIStealMegakernel
    from .workloads import FIB

    plan = DeviceFaultPlan(**(FOREST_FAULT if plan is None else plan))
    sk = ICIStealMegakernel(forest_megakernel(roots, capacity, 0, device),
                            CtaMesh((ndev,), ("q",), device=device),
                            migratable_fns=[FIB], fault_plan=plan)
    iv, _, info = sk.run(forest_builders(ndev, roots, n), quantum=quantum)
    info["rounds"] = info["steal_rounds"]
    check_forest(iv, info, roots, n)
    return iv, info


# The quiesce, resume and flight-recorder loads (ROADMAP A11b.6): the
# shapes of JAX's mesh checkpoint tests (tests/test_checkpoint.py :480
# ``_mesh_uts_rk``, :712 the pending-waits round trip, :798 the injection
# residue; tests/test_tenants.py :1051 the tenant quiesce), and phase 31's
# full-width tree (``uts_ckpt``).
CKPT_UTS_NODES = 498965  # UTS depth 20 (seed 19, q 440, m 4), one root


def ckpt_uts_resident(ndev: int, max_depth: int = 6, capacity: int = 256,
                      trace=None, batch_width=None, checkpoint=True,
                      device="cuda"):
    """JAX's ``_mesh_uts_rk``: the UTS table (``checkpoint=True``, depth
    ``max_depth``) under the resident kernel steal-only, UTS_NODE
    migratable with homed=False, window 4."""
    from ..parallel.mesh import CtaMesh
    from .resident import ResidentKernel
    from .workloads import UTS_NODE, make_uts_megakernel

    mk = make_uts_megakernel(max_depth=max_depth, capacity=capacity,
                             checkpoint=checkpoint, trace=trace,
                             batch_width=batch_width, device=device)
    return ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                          migratable_fns=[UTS_NODE], window=4, homed=False)


def ckpt_uts_builders(ndev: int):
    """JAX's ``_mesh_uts_builders``: one UTS root a device, seed d + 1."""
    from .descriptor import TaskGraphBuilder
    from .workloads import UTS_NODE

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for d, b in enumerate(bs):
        b.add(UTS_NODE, args=[d + 1, 0])
    return bs


def _wbump(ctx):
    ctx.set_value(0, ctx.value(0) + ctx.arg(0))


def _wput(ctx):
    ctx.pgas.put(ctx.arg(0), 0, ctx.arg(1), ctx.arg(2))


def _wconsume(ctx):
    ctx.set_value(ctx.arg(0), ctx.pgas.count(0))


WAITS_ROWS, WAITS_COLS = 8, 128
WAITS_TABLE = (
    ("bump", _wbump, "ctx.set_value(0, ctx.value(0) + ctx.arg(0));"),
    ("put", _wput, "ctx.pgas.put(ctx.arg(0), 0, ctx.arg(1), ctx.arg(2));"),
    ("consume", _wconsume, "ctx.set_value(ctx.arg(0), ctx.pgas.count(0));"),
)


def ckpt_waits_resident(trace=None, device="cuda", ndev: int = 2):
    """The pending-waits round trip's mesh (tests/test_checkpoint.py
    :712): BUMP, PUT (put my heap row 0 into device arg0's row arg1 ...)
    and CONSUME (slot arg0 = channel 0's count) on ``ndev`` devices (2
    there), channel c0 one heap row, window 4, ``checkpoint=True``."""
    import torch

    from ..parallel.mesh import CtaMesh
    from .megakernel import Megakernel
    from .resident import ResidentKernel

    mk = Megakernel(list(WAITS_TABLE),
                    data_specs={"heap": ((WAITS_ROWS, WAITS_COLS),
                                         torch.int32)},
                    capacity=128, num_values=64, succ_capacity=64,
                    checkpoint=True, trace=trace, device=device)
    return ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                          channels={"c0": ("heap", 1)}, window=4)


def ckpt_waits_load(chain: int = 20, ndev: int = 2):
    """Its load, on each pair of devices (2k, 2k + 1) of ``ndev`` (one
    pair there): a chain of ``chain + 1`` BUMPs on device 2k hides the
    PUT [2k + 1, 3, 2] behind it, device 2k + 1's CONSUME waits on (c0,
    1); returns (builders, waits, heap)."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    waits = [[] for _ in range(ndev)]
    for d in range(0, ndev, 2):
        prev = bs[d].add(0, args=[1])
        for i in range(chain):
            prev = bs[d].add(0, args=[i + 2], deps=[prev])
        bs[d].add(1, args=[d + 1, 3, 2], deps=[prev])
        waits[d + 1].append((0, 1, bs[d + 1].add(2, args=[1])))
    heap = np.zeros((ndev, WAITS_ROWS, WAITS_COLS), np.int32)
    for d in range(ndev):
        for r in range(WAITS_ROWS):
            heap[d, r, :] = 1000 * d + r
    return bs, waits, heap


def ckpt_bump_megakernel(capacity: int = 256, num_values: int = 1024,
                         trace=None, device="cuda"):
    """The BUMP table of JAX's injection-residue and tenant quiesce tests
    (``checkpoint=True``; capacity 256 and 1,024 value slots there, 128
    and 4 in the tenant test)."""
    from .megakernel import Megakernel

    return Megakernel([("bump", _bump0, BUMP0_CUDA)], capacity=capacity,
                      num_values=num_values, succ_capacity=8,
                      checkpoint=True, trace=trace, device=device)


def ckpt_inject_load(ndev: int = 4):
    """The injection-residue test's load: 2 BUMPs a device and 6 BUMP
    rows on every ring, numbered 1.. in that order; returns (builders,
    inject_rows, their sum, the count)."""
    from .descriptor import TaskGraphBuilder

    bs = [TaskGraphBuilder() for _ in range(ndev)]
    v = 0
    for b in bs:
        for _ in range(2):
            v += 1
            b.add(0, args=[v])
    rows = []
    for _ in range(ndev):
        rows.append([(0, [v + j + 1]) for j in range(6)])
        v += 6
    return bs, rows, v * (v + 1) // 2, v


def uts_ckpt(ndev: int = 128, max_depth: int = 20, trace=None,
             checkpoint: bool = True, device="cuda"):
    """Phase 31's mesh: row 1's UTS tree (seed 19, q 440, m 4) from one
    root on device 0, UTS_NODE migratable under homed migration (as
    ``uts_fault`` builds it, with ``checkpoint=True`` and ``trace``):
    the scheduler keeps home links, so a spawned row carries no home and
    moves again, and a quiesced state re-homes onto another mesh size.
    (Under homed=False a spawned row keeps the stale F_HOME of its slot,
    so the tree would stay on device 0 and reshard would refuse every
    spawned row as home-linked, in JAX as here.) Returns (the mesh, its
    builders)."""
    from ..parallel.mesh import CtaMesh
    from .descriptor import TaskGraphBuilder
    from .megakernel import Megakernel
    from .resident import ResidentKernel
    from .workloads import UTS_NODE

    cap = 1024
    mk = Megakernel(kernels=["uts_node"], capacity=cap, num_values=16 + cap,
                    succ_capacity=8,
                    params={"seed": 19, "q_millis": 440, "m_children": 4,
                            "max_depth": max_depth},
                    checkpoint=checkpoint, trace=trace, device=device)
    rk = ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                        migratable_fns=[UTS_NODE], window=8)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    bs[0].add(UTS_NODE, args=[1, 0])
    for b in bs:
        b.reserve_values(1)
    return rk, bs
