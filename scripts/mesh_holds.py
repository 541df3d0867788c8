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
- ``user_sharded_8``, ``user_resident_8``: the multi-chip dry run's
  phases 2 and 3 (64 user-body BUMPs on device 0, through the sharded
  steal at quantum 4, window 8, and through the ICI steal at window 32,
  quantum 16: the user library's ``mk_user_kernel`` and its resident
  kernel steal-only).
- ``pgas_2``, ``pgas_4``, ``pgas_8``: the resident kernel's PGAS
  configuration (``PGASMegakernel``) on ``stress.pgas_builders``' exchange
  (every device reads its landing words, then starts its left
  neighbour's SEND, which AMs a BUMP at every device and puts 16 rows
  into its ring neighbour's heap, whose consumer waits for them and
  reads their words),
  at am_window 2, 2 and 8, the last two with a 6-message burst at one
  target; ``pgas_steal_8``: the same with 32 BUMPs on device 0 stolen
  over the same hops (steal with channels, window 4, quantum 4). These
  also return the heap and the messages and puts sent.
- ``homed_2``, ``homed_8``, ``homed_3d``, ``homed_8_b8``: the resident
  kernel's migrating configuration (``resident_homed``) on JAX's homed
  fib tests: fib(8) on 2 devices (window 16, quantum 4), fib(9) on 8
  (window 8, quantum 16; and with FIB routed at width 8), fib(6) on a
  2x2x2 mesh (quantum 4); FIB migratable, SUM with its two value args.
- ``atomics_4``: the lock workload (``stress.lock_builders``) on 4
  devices, steal=False: a LOCKER a device, a fetch-add with its reply,
  a compare-swap with its reply. These return the proxies, their peak
  and the built-in messages each device applied.
- the resident kernel's injecting instances (``resident_inject``):
  ``inject_steal_8``, the forest with 16 FIB(4) rows on every device's
  ring (steal-only); ``inject_pgas_4`` and ``inject_pgas_steal_8``, the
  PGAS exchange with 4 BUMPs of slot 3 on every ring (without steal, and
  with 32 BUMPs stolen beside it); ``compose_4``, ``five_way_1`` and
  ``volume_1``, JAX's three resident compositions that inject
  (``stress.compose_inject``, ``five_way``, ``volume``: the migrating
  configuration with channels); ``tenants_4``, mesh tenancy
  (``stress.tenant_mesh`` on 4 devices: four lanes at 4:2:1:1, the last
  one's rows expired on the ring). These also return the heap and, on
  the tenant mesh, the tctl echo.
- the fault layer (``resident_fault``, a ``DeviceFaultPlan``), one case
  an instance: ``fault_steal_8`` and ``fault_steal_8_b8``, the forest
  steal-only (``ICIStealMegakernel``, scalar and width 8) with device 0
  dead from round 0, so it re-homes every root, and credits dropped,
  doubled and delayed (``FOREST_DEAD``); ``fault_user_steal_4``, the dry
  run's BUMPs steal-only, and ``fault_pgas_steal_8``, the PGAS exchange
  with 32 BUMPs stolen, both under ``CREDIT_FAULTS``;
  ``fault_credits_2`` and ``fault_dead_4``, ``tests/test_torch_faults.py``'s
  two fixtures (the migrating configuration); ``fault_wedge_2``, JAX's
  credit_timeout=0 plan, whose StallError's stats and message are
  compared. ``PHASE30`` / ``run_fault_arm`` are chip_smoke.py's phase 30:
  JAX's fault tests at their shapes and the two 16-CTA loads.

``RING_CASES`` (``run_ring_case``, ``ring_run``, ``ring_result``) hold
PGASMegakernel's ring kernel (``pgas_ring_kernel``, a mesh whose size is
not a power of two) at 3 and 6 devices: the PGAS exchange with its burst,
traced and not and cut by an abort, the dry run's phase 4, and the fan
(active messages of FIB roots to every device, FIB routed at width 8);
they also return the heap, the messages, puts and stat words sent and
each device's decoded records. ``chip_smoke.py``'s phase 32 runs
``ring_run`` at full width.

``USER_CASES`` hold the user library's scheduler (``mk_user_kernel``) on
one device (``run_user_case``), each on ``USER_TABLE`` (the built-in fib
and sum, a user BUMP, the alloc/free chain, fib as user bodies: one
library): tests/test_device.py's alloc/free chain of 200 tasks through a
16-slot value buffer (``chain_free``), the built-in fib beside user
BUMPs (``mixed``: fib(16) and 32 BUMPs) and the user-written fib
(``ufib``: UFIB(14)). They return the whole state after one launch.
``user_forest`` runs a UFIB forest through the sharded runner.
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
from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel  # noqa: E402
from hclib_tpu_torch.device.resident import ResidentKernel  # noqa: E402
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
    "user_sharded_8": ("user_sharded", 8, 0, False,
                       dict(steal=True, quantum=4, window=8)),
    "user_resident_8": ("user_ici", 8, 0, False, dict(quantum=16)),
    "pgas_2": ("pgas", 2, 0, False, dict(am_window=2)),
    "pgas_4": ("pgas", 4, 0, True, dict(am_window=2)),
    "pgas_8": ("pgas", 8, 0, True, dict(am_window=8)),
    "pgas_steal_8": ("pgas_steal", 8, 0, True, dict(am_window=8)),
    # JAX's homed tests (tests/test_resident.py) at their shapes: (fib n,
    # capacity, window, quantum, mesh dims).
    "homed_2": ("homed", 2, 0, False, dict(n=8, cap=96, window=16,
                                          quantum=4)),
    "homed_8": ("homed", 8, 0, False, dict(n=9, cap=160, window=8,
                                          quantum=16)),
    "homed_3d": ("homed", 8, 0, False, dict(n=6, cap=64, window=8,
                                           quantum=4, dims=(2, 2, 2))),
    "homed_8_b8": ("homed", 8, 8, False, dict(n=9, cap=160, window=8,
                                             quantum=16)),
    "atomics_4": ("atomics", 4, 0, False, {}),
    "inject_steal_8": ("inject", 8, 0, False, {}),
    "inject_pgas_4": ("inject_pgas", 4, 0, False, dict(steal=False)),
    "inject_pgas_steal_8": ("inject_pgas", 8, 0, False, dict(steal=True)),
    "compose_4": ("compose", 4, 0, False, {}),
    "five_way_1": ("five_way", 1, 0, False, {}),
    "volume_1": ("volume", 1, 0, False, {}),
    "tenants_4": ("tenants", 4, 0, False, {}),
    # The fault layer (resident_kernel<.., kFault>), one case an instance:
    # the forest steal-only with device 0, which holds every root, dead
    # from round 0 and credits dropped, doubled and delayed (megakernel.cu,
    # scalar and with FIB at width 8); the dry run's BUMPs steal-only
    # (user library, variant 0) and the PGAS exchange with steal (variant
    # 1), both under credit faults; the two fixtures of
    # tests/test_torch_faults.py (the migrating configuration, variant 2);
    # JAX's credit_timeout=0 plan, which raises.
    "fault_steal_8": ("fault", 8, 0, False, dict(load="forest")),
    "fault_steal_8_b8": ("fault", 8, 8, False, dict(load="forest")),
    "fault_user_steal_4": ("fault", 4, 0, False, dict(load="user")),
    "fault_pgas_steal_8": ("fault", 8, 0, True, dict(load="pgas")),
    "fault_credits_2": ("fault", 2, 0, False, dict(load="credits")),
    "fault_dead_4": ("fault", 4, 0, False, dict(load="dead")),
    "fault_wedge_2": ("fault", 2, 0, False, dict(load="wedge")),
}
# The credit faults of the fault cases (and, with FOREST's dead device,
# of the forest ones).
CREDIT_FAULTS = dict(seed=5, drop_credit_rate=0.02, dup_credit_rate=0.02,
                     delay_xfer_rate=0.1, credit_timeout=2)
FOREST_DEAD = dict(CREDIT_FAULTS, dead_device=0, dead_round=0,
                   heartbeat_timeout=2)
INJECT_KINDS = ("inject", "inject_pgas", "compose", "five_way", "volume",
                "tenants")
# tenants_4's lanes: (tenant, weight, admissions on 4 devices).
TENANTS_4 = (("gold", 4, 96), ("std", 2, 64), ("bg", 1, 32), ("late", 1, 16))


def kernel_of(name: str) -> str:
    """The mesh kernel a case runs on the card (a ``_build.LAUNCHES``
    name): the ICI runner takes the resident kernel on power-of-two
    meshes and the ring on the others."""
    kind, ndev = CASES[name][:2]
    if kind in INJECT_KINDS:
        return "resident_inject"
    if kind == "fault":
        return "resident_fault"
    if kind == "ici":
        kind = "resident" if ndev & (ndev - 1) == 0 else "ring"
    return {"sharded": "mesh_round", "ring": "ici_ring",
            "resident": "resident_steal", "user_sharded": "mk_user",
            "user_ici": "resident_steal", "pgas": "resident_pgas",
            "pgas_steal": "resident_pgas", "homed": "resident_homed",
            "atomics": "resident_pgas"}[kind]


def builders(ndev: int, dealt: bool):
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for r in range(ROOTS):
        bs[r % ndev if dealt else 0].add(FIB, args=[N], out=r)
    for b in bs:
        b.reserve_values(ROOTS)
    return bs


def _user_case(kind, ndev, burst, kw, device):
    """A user-body case: the dry run's BUMP load, or the PGAS exchange."""
    mesh = CtaMesh((ndev,), ("q",), device=device)
    if kind.startswith("user"):
        mk = stress.bump_megakernel(device)
        bs = stress.dryrun_builders(2, ndev)
        if kind == "user_sharded":
            iv, data, info = ShardedMegakernel(
                mk, mesh, migratable_fns=[0]).run(bs, **kw)
        else:
            iv, data, info = ICIStealMegakernel(
                mk, mesh, migratable_fns=[0], window=32).run(bs, **kw)
        want = 8 * ndev * (8 * ndev + 1) // 2
        if int(np.asarray(iv)[:, 0].sum()) != want:
            raise AssertionError(f"{kind}: bump total {iv[:, 0].sum()}")
        return iv, data, info
    bumps = 32 if kind == "pgas_steal" else 0
    mk = stress.pgas_megakernel(device=device)
    bs, waits, heap = stress.pgas_builders(ndev, burst, bumps)
    if kind == "pgas":
        runner = PGASMegakernel(mk, mesh, channels={"c0": ("heap", 1)},
                                **kw)
        iv, data, info = runner.run(bs, data={"heap": heap}, waits=waits)
    else:
        runner = ResidentKernel(mk, mesh, migratable_fns=[stress.PBUMP],
                                homed=False, channels={"c0": ("heap", 1)},
                                window=4, **kw)
        iv, data, info = runner.run(bs, data={"heap": heap}, waits=waits,
                                    quantum=4)
    stress.check_pgas(iv, data["heap"].cpu().numpy(), info, ndev, burst,
                      bumps)
    return iv, data, info


def homed_megakernel(cap: int, bw: int, device, **kw):
    """JAX's homed tests' fib table: every row's value block, 16 host
    slots and one migration result slot a row (a library of built-in
    bodies alone on the card); ``kw``: ``trace`` or ``checkpoint``."""
    from hclib_tpu_torch.device.megakernel import VBLOCK
    from hclib_tpu_torch.device.workloads import make_fib_megakernel

    return make_fib_megakernel(cap, num_values=VBLOCK * cap + 16 + cap,
                               batch_width=bw or None, device=device, **kw)


def _homed_case(kind, ndev, bw, kw, device):
    """A homed fib (FIB and SUM migratable, SUM's two value args) or the
    lock workload; raises unless its totals are exact."""
    from hclib_tpu_torch.models.fib import fib_seq, task_count

    if kind == "atomics":
        bs, iv0 = stress.lock_builders(ndev)
        rk = ResidentKernel(stress.lock_megakernel(device=device),
                            CtaMesh((ndev,), ("q",), device=device),
                            steal=False)
        iv, data, info = rk.run(bs, ivalues=iv0, quantum=8)
        stress.check_locks(iv, info, ndev)
        return iv, data, info
    dims = kw.get("dims", (ndev,))
    mesh = CtaMesh(dims, ("x", "y", "z")[:len(dims)], device=device)
    rk = ResidentKernel(homed_megakernel(kw["cap"], bw, device), mesh,
                        migratable_fns={FIB: (), FIB + 1: (0, 1)},
                        window=kw["window"], am_window=8)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    bs[0].add(FIB, args=[kw["n"]], out=0)
    iv, data, info = rk.run(bs, quantum=kw["quantum"])
    t = task_count(kw["n"])
    if (int(np.asarray(iv)[:, 0].sum()) != fib_seq(kw["n"])
            or info["executed"] != t + (t - 1) // 2
            or info["pending"] != 0 or any(info["proxies"])):
        raise AssertionError(f"homed fib({kw['n']}): {iv[:, 0].tolist()}, "
                             f"executed {info['executed']}")
    return iv, data, info


def _inject_case(kind, ndev, kw, device):
    """An injecting case; raises unless its totals are exact."""
    if kind == "inject":
        iv, info = stress.inject_forest(ndev, ROOTS, N, 16, 4, CAP,
                                        device=device)
        return iv, {}, info
    if kind == "tenants":
        iv, info = stress.tenant_mesh(ndev, TENANTS_4, capacity=16,
                                      device=device)
        return iv, {}, info
    if kind != "inject_pgas":
        return {"compose": stress.compose_inject, "five_way": stress.five_way,
                "volume": stress.volume}[kind](device=device)
    bumps = 32 if kw["steal"] else 0
    mk = stress.pgas_megakernel(device=device)
    bs, waits, heap = stress.pgas_builders(ndev, False, bumps)
    rk = ResidentKernel(mk, CtaMesh((ndev,), ("q",), device=device),
                        migratable_fns=[stress.PBUMP], homed=False,
                        channels={"c0": ("heap", 1)}, window=4, inject=True,
                        ring_capacity=8, **kw)
    rows = [[(stress.PBUMP, [3, 1 + d + j]) for j in range(4)]
            for d in range(ndev)]
    iv, data, info = rk.run(bs, data={"heap": heap}, waits=waits,
                            inject_rows=rows, quantum=4)
    stress.check_pgas(iv, data["heap"].cpu().numpy(), info, ndev, False,
                      bumps)
    want = sum(1 + d + j for d in range(ndev) for j in range(4))
    if int(np.asarray(iv)[:, 3].sum()) != want:
        raise AssertionError(f"inject_pgas: slot 3 {iv[:, 3].tolist()}")
    return iv, data, info


def _fault_case(ndev, bw, dealt, kw, device):
    """A case of the fault layer; raises unless its totals are exact (the
    wedge: unless it raises naming the starved channel). Returns what it
    is compared on."""
    from hclib_tpu_torch.runtime.resilience import DeviceFaultPlan

    load = kw["load"]
    mesh = CtaMesh((ndev,), ("q",), device=device)
    if load in ("credits", "dead"):
        iv, info = stress.fault_run(load, device)
        return _resident_result(iv, {}, info)
    if load == "wedge":
        return run_fault_arm("wedge_2", device)
    if load == "forest":
        mk = stress.forest_megakernel(ROOTS, CAP, bw, device)
        sk = ICIStealMegakernel(mk, mesh, migratable_fns=[FIB], window=8,
                                fault_plan=DeviceFaultPlan(**FOREST_DEAD))
        iv, data, info = sk.run(builders(ndev, False), quantum=64)
        info["rounds"] = info.pop("steal_rounds")
        stress.check_forest(iv, info, ROOTS, N)
        return _resident_result(iv, data, info)
    plan = DeviceFaultPlan(**CREDIT_FAULTS)
    if load == "user":
        sk = ICIStealMegakernel(stress.bump_megakernel(device), mesh,
                                migratable_fns=[0], window=4,
                                fault_plan=plan)
        iv, data, info = sk.run(stress.dryrun_builders(2, ndev), quantum=2)
        info["rounds"] = info.pop("steal_rounds")
        n = 8 * ndev
        stress.check_bump(iv, info, n, n * (n + 1) // 2)
        return _resident_result(iv, data, info)
    bs, waits, heap = stress.pgas_builders(ndev, dealt, 32)
    rk = ResidentKernel(stress.pgas_megakernel(device=device), mesh,
                        migratable_fns=[stress.PBUMP], homed=False,
                        channels={"c0": ("heap", 1)}, window=4,
                        am_window=8, fault_plan=plan)
    iv, data, info = rk.run(bs, data={"heap": heap}, waits=waits,
                            quantum=4)
    stress.check_pgas(iv, data["heap"].cpu().numpy(), info, ndev, dealt, 32)
    return _resident_result(iv, data, info)


# chip_smoke.py's phase 30 (``faults``): JAX's fault tests at their
# shapes (tests/test_device_faults.py: 40 BUMPs on device 0 of 2 under a
# dropped, a duplicated and a delayed credit plan and the credit_timeout=0
# plan; 6 BUMPs a device on 8 with device 3 dead at round 2), then the
# full width: UTS_FAULT (16 CTAs) and FOREST_FAULT (16 CTAs, steal-only).
PHASE30 = ("drop_2", "dup_2", "delay_2", "wedge_2", "dead_8", "uts_16",
           "forest_16")
JAX_FAULT_PLANS = {
    "drop_2": dict(seed=3, drop_credit_at=[(1, 0, 1)], credit_timeout=2),
    "dup_2": dict(seed=5, dup_credit_at=[(1, 0, 1)], credit_timeout=2),
    "delay_2": dict(seed=11, delay_xfer_rate=0.5, credit_timeout=2),
    "wedge_2": dict(seed=3, drop_credit_at=[(1, 0, 1)], credit_timeout=0),
    "dead_8": dict(seed=7, dead_device=3, dead_round=2, heartbeat_timeout=2),
}
# The message JAX's test matches the wedge's StallError against.
WEDGE_MATCH = r"hop-0 .*granter device 1"


def run_fault_arm(name: str, device: str) -> dict:
    """Phase-30 arm ``name`` on ``device``, exact by JAX's assertions (the
    wedge: raising JAX's StallError, whose stats it returns, with the
    message under ``stall``); returns what it is compared on."""
    import re

    from hclib_tpu_torch.runtime.resilience import DeviceFaultPlan, StallError

    if name == "uts_16":
        iv, info = stress.uts_fault(device=device)
        if int(np.asarray(iv)[:, 0].sum()) != stress.UTS_FAULT_NODES or (
                info["executed"] != stress.UTS_FAULT_NODES):
            raise AssertionError(f"uts_16: {int(iv[:, 0].sum())} nodes")
        return _resident_result(iv, {}, info)
    if name == "forest_16":
        iv, info = stress.forest_fault(device=device)
        return _resident_result(iv, {}, info)
    plan = DeviceFaultPlan(**JAX_FAULT_PLANS[name])
    if name == "dead_8":
        rk = stress.fault_resident(8, plan, 256, device=device)
        bs, total = stress.spread_builders(8, 6)
        iv, _, info = rk.run(bs, quantum=2, max_rounds=4096)
        stress.check_bump(iv, info, 48, total)
        return _resident_result(iv, {}, info)
    rk = stress.fault_resident(2, plan, 128, device=device)
    bs = stress.skewed_builders(2, 40)
    if name != "wedge_2":
        iv, _, info = rk.run(bs, quantum=2, max_rounds=4096)
        stress.check_bump(iv, info, 40, 820)
        return _resident_result(iv, {}, info)
    try:
        rk.run(bs, quantum=2, max_rounds=4096)
    except StallError as e:
        if not re.search(WEDGE_MATCH, str(e)):
            raise
        out = _resident_result(np.zeros((2, 1), np.int32), {}, e.stats)
        out["stall"] = str(e)
        return out
    raise AssertionError("wedge_2: credit_timeout=0 did not raise")


# chip_smoke.py's phase 29 (``inject``): JAX's three compositions that
# inject, the forest with 256 injected rows a device and the four tenant
# lanes on 128 CTAs.
PHASE29 = ("compose_4", "five_way_1", "volume_1", "inject_128",
           "tenants_128")


def run_arm(name: str, device: str) -> dict:
    """Phase-29 arm ``name`` on ``device``, exact or raising; returns what
    it is compared on (``run_case``'s fields)."""
    if name in CASES:
        return run_case(name, device)
    if name == "inject_128":
        iv, info = stress.inject_forest(**stress.INJECT_128, device=device)
    else:
        iv, info = stress.tenant_mesh(device=device)
    return _resident_result(iv, {}, info)


def _resident_result(iv, data, info) -> dict:
    """What a resident-kernel case is compared on."""
    ex = info["exchange"]
    return {
        "iv": np.asarray(iv),
        "counts": np.asarray(info["per_device_counts"]),
        "rounds": info["rounds"],
        "tiers": info.get("tiers"),
        "fault_stats": info["fault_stats"],
        "aborted": info["aborted"],
        "rows": ex["rows"], "stat_words": ex["stat_words"],
        "ams": ex["ams"], "puts": ex["puts"],
        "proxies": info.get("proxies"),
        "proxies_peak": info.get("proxies_peak"),
        "builtin_ams": info.get("builtin_ams"),
        "data": {k: v.cpu().numpy() for k, v in data.items()},
        "tenant_ctl": info.get("tenant_ctl"),
        "tenants": info.get("tenants"),
        "executed": info["executed"],
        "pending": info["pending"],
        "kernel_ms": ex["kernel_ms"],
        "exchange_ms": None,
    }


def run_case(name: str, device: str) -> dict:
    """One case on ``device``; returns what it is compared on."""
    kind, ndev, bw, dealt, kw = CASES[name]
    if kind == "fault":
        return _fault_case(ndev, bw, dealt, kw, device)
    if kind in INJECT_KINDS:
        return _resident_result(*_inject_case(kind, ndev, kw, device))
    if kind in ("homed", "atomics"):
        return _resident_result(*_homed_case(kind, ndev, bw, kw, device))
    if kind.startswith(("user", "pgas")):
        iv, data, info = _user_case(kind, ndev, dealt, kw, device)
        ex = info.get("exchange", {})
        return {
            "iv": np.asarray(iv),
            "counts": np.asarray(info["per_device_counts"]),
            "rounds": info.get("steal_rounds", info.get("rounds")),
            "fault_stats": info.get("fault_stats"),
            "aborted": info.get("aborted"),
            "rows": ex.get("rows"),
            "stat_words": ex.get("stat_words"),
            "ams": ex.get("ams"),
            "puts": ex.get("puts"),
            "data": {k: v.cpu().numpy() for k, v in data.items()},
            "executed": info["executed"],
            "kernel_ms": ex.get("kernel_ms", info.get("kernel_ms")),
            "exchange_ms": info.get("exchange_ms"),
        }
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


# The observed instances (``resident_obs``, ``ici_ring_obs``: kObs, the
# flight recorder and the quiesce word), one case or more an instance,
# on the CPU tests' fixtures' shapes and at 8 CTAs. A case with a quiesce
# runs it, then resumes the exported state on the same mesh; both runs
# are compared (every state array, the wait table, the ring residue and
# ictl, each device's decoded records). name: (load, ndev, trace
# capacity, quiesce, run kwargs).
OBS_CASES = {
    # the built-in steal-only instances (megakernel.cu): JAX's
    # _mesh_uts_rk at 2 devices (fixture (a)) and 8, a wrapping ring, the
    # batch tier at width 4, and the forest traced without a checkpoint
    "obs_uts_2": ("uts", 2, 256, 2, {}),
    "obs_uts_8": ("uts", 8, 512, 2, {}),
    "obs_uts_wrap_2": ("uts", 2, 16, 2, {}),
    "obs_uts_b4_4": ("uts", 4, 512, 2, dict(batch_width=4)),
    "obs_forest_8": ("forest", 8, 4096, None, {}),
    # the ring (ici_ring_kernel observed), scalar and at width 8
    "obs_ring_3": ("ring", 3, 4096, None, {}),
    "obs_ring_3_b8": ("ring", 3, 4096, None, dict(batch_width=8)),
    # the built-in steal-only instances with the fault layer: the forest
    # with device 0 dead and credit faults, checkpoint-built (its stat
    # vector carries the quiesce sum after the heartbeats)
    "obs_fault_steal_8": ("fault_forest", 8, 4096, None, {}),
    "obs_fault_steal_8_b8": ("fault_forest", 8, 4096, None,
                             dict(batch_width=8)),
    # the user libraries: PGAS with a parked wait (variant 1, fixture
    # (b)), the migrating homed fib (variant 2), injection (fixture (c))
    # and tenancy, and the migrating instance with the fault layer
    # (stress.FAULT_CREDITS)
    "obs_waits_2": ("waits", 2, 128, 2, {}),
    "obs_homed_2": ("homed", 2, 1024, 3, {}),
    "obs_inject_4": ("inject", 4, 256, True, {}),
    "obs_inject_q2_4": ("inject", 4, 256, 2, {}),
    "obs_tenants_4": ("tenants", 4, 256, 1, {}),
    "obs_fault_credits_2": ("fault_credits", 2, 256, None, {}),
    # the same variants at 8 CTAs (four parked waits at the cut), and the
    # fault variant checkpoint-built and quiesced (its quiesce sum after
    # the routed heartbeats)
    "obs_waits_8": ("waits", 8, 128, 2, {}),
    "obs_inject_8": ("inject", 8, 256, 2, {}),
    "obs_tenants_8": ("tenants", 8, 256, 1, {}),
    "obs_fault_credits_8": ("fault_credits", 8, 256, None, {}),
    "obs_fault_credits_ckpt_8": ("fault_credits", 8, 256, 2,
                                 dict(checkpoint=True)),
}


def _ring_result(iv, info) -> dict:
    """What a ring run is compared on (the observed ring's fields)."""
    return _obs_fields({"iv": np.asarray(iv),
                        "counts": np.asarray(info["per_device_counts"]),
                        "rounds": info["rounds"], "tiers": info.get("tiers"),
                        "rows": info["exchange"]["rows"],
                        "stat_words": info["exchange"]["stat_words"],
                        "executed": info["executed"],
                        "pending": info["pending"],
                        "kernel_ms": info["exchange"]["kernel_ms"]}, info)


def _obs_fields(out: dict, info, pre: str = "") -> dict:
    """An observed run's own outputs, flattened for ``compare``: the
    quiesce, the exported state, the ictl echo and each device's decoded
    records."""
    out[pre + "quiesced"] = info.get("quiesced")
    for k, v in (info.get("state") or {}).items():
        if k == "data":
            for n, a in v.items():
                out[f"{pre}state/data/{n}"] = np.asarray(a)
        else:
            out[f"{pre}state/{k}"] = np.asarray(v)
    if "inject_ctl" in info:
        out[pre + "inject_ctl"] = np.asarray(info["inject_ctl"])
    for d, ring in enumerate((info.get("trace") or {}).get("rings", ())):
        out[f"{pre}trace/{d}/written"] = ring["written"]
        out[f"{pre}trace/{d}/records"] = np.asarray(ring["records"])
    return out


def _obs_mesh(load, ndev, cap, kw, device):
    """The mesh (and its first run's arguments) of an observed case."""
    from hclib_tpu_torch.device.megakernel import Megakernel
    from hclib_tpu_torch.device.tenants import MeshTenantTable
    from hclib_tpu_torch.runtime.resilience import DeviceFaultPlan

    mesh = CtaMesh((ndev,), ("q",), device=device)
    bw = kw.get("batch_width", 0)
    if load == "uts":
        rk = stress.ckpt_uts_resident(ndev, trace=cap, batch_width=bw or None,
                                      device=device)
        return rk, dict(builders=stress.ckpt_uts_builders(ndev), quantum=8,
                        max_rounds=4096)
    if load in ("forest", "ring", "fault_forest"):
        mk = stress.forest_megakernel(ROOTS, CAP, bw, device, trace=cap,
                                      checkpoint=load == "fault_forest")
        plan = (DeviceFaultPlan(**FOREST_DEAD) if load == "fault_forest"
                else None)
        return (ICIStealMegakernel(mk, mesh, migratable_fns=[FIB], window=8,
                                   fault_plan=plan),
                dict(builders=builders(ndev, False), quantum=64))
    if load == "waits":
        rk = stress.ckpt_waits_resident(trace=cap, device=device, ndev=ndev)
        bs, waits, heap = stress.ckpt_waits_load(ndev=ndev)
        return rk, dict(builders=bs, waits=waits, data={"heap": heap},
                        quantum=2, max_rounds=4096)
    if load == "homed":
        mk = homed_megakernel(96, 0, device, trace=cap, checkpoint=True)
        rk = ResidentKernel(mk, mesh, migratable_fns={FIB: (), FIB + 1: (0, 1)},
                            window=16, am_window=8)
        bs = [TaskGraphBuilder() for _ in range(ndev)]
        bs[0].add(FIB, args=[8], out=0)
        return rk, dict(builders=bs, quantum=4)
    if load == "inject":
        rk = ResidentKernel(stress.ckpt_bump_megakernel(trace=cap,
                                                        device=device),
                            mesh, migratable_fns=[0], window=4, homed=False,
                            inject=True)
        bs, rows, _, _ = stress.ckpt_inject_load(ndev)
        return rk, dict(builders=bs, inject_rows=rows, quantum=4,
                        max_rounds=4096)
    if load == "tenants":
        rk = ResidentKernel(stress.ckpt_bump_megakernel(128, 4, cap, device),
                            mesh, migratable_fns=[0], homed=False, window=4,
                            inject=True, tenants=["gold", "std", "bg"],
                            ring_capacity=96)
        table = MeshTenantTable(rk.tenant_specs, ndev, rk.region_rows)
        for i, (tid, n) in enumerate((("gold", 10), ("std", 6), ("bg", 4))):
            for _ in range(n):
                table.submit(tid, 0, args=[i + 1])
        bs = [TaskGraphBuilder() for _ in range(ndev)]
        for b in bs:
            b.add(0, args=[0])
        return rk, dict(builders=bs, tenant_table=table, quantum=1,
                        max_rounds=4096)
    cfg = stress.FAULT_CREDITS
    mk = Megakernel([("bump", stress._bump0, stress.BUMP0_CUDA)],
                    capacity=cfg["capacity"], num_values=1024, succ_capacity=8,
                    trace=cap, checkpoint=kw.get("checkpoint", False),
                    device=device)
    rk = ResidentKernel(mk, mesh, migratable_fns=[0], window=4,
                        fault_plan=DeviceFaultPlan(**cfg["plan"]))
    return rk, dict(builders=stress.skewed_builders(ndev, cfg["ntasks"]),
                    quantum=2, max_rounds=4096)


def run_obs_case(name: str, device: str) -> dict:
    """Observed case ``name`` on ``device``: its run (quiesced where the
    case says, then resumed from the exported state); returns what it is
    compared on."""
    from hclib_tpu_torch.device.tenants import MeshTenantTable

    load, ndev, cap, quiesce, kw = OBS_CASES[name]
    rk, args = _obs_mesh(load, ndev, cap, kw, device)
    if load == "ring":
        iv, data, info = rk._run_ring(**args)
        info["rounds"] = info.pop("steal_rounds")
        stress.check_forest(iv, info, ROOTS, N)
        return _ring_result(iv, info)
    if quiesce is not None:
        args["quiesce"] = quiesce
    iv, data, info = rk.run(**args)
    if isinstance(rk, ICIStealMegakernel):
        info["rounds"] = info.pop("steal_rounds")
    out = _obs_fields(_resident_result(iv, data, info), info)
    if quiesce is None:
        return out
    if not info["quiesced"]:
        raise AssertionError(f"{name}: the mesh did not quiesce")
    rkw = {k: args[k] for k in ("quantum", "max_rounds") if k in args}
    if load == "tenants":
        rkw["tenant_table"] = MeshTenantTable(rk.tenant_specs, ndev,
                                              rk.region_rows)
    iv, data, info = rk.run(resume_state=info["state"], **rkw)
    if info["pending"] != 0:
        raise AssertionError(f"{name}: the resume left {info['pending']}")
    res = _obs_fields(_resident_result(iv, data, info), info)
    out.update({"resume/" + k: v for k, v in res.items()})
    return out


def compare(got: dict, want: dict, what: str = "") -> float:
    """Raise unless every output but the times agrees word for word;
    returns the largest absolute difference of the value slots (0)."""
    for k in want:
        if k.rpartition("/")[2] in TIMES:
            continue
        a, b = got[k], want[k]
        if isinstance(b, dict) and k.rpartition("/")[2] == "data":
            same = all(np.array_equal(a[n], b[n]) for n in b)
        else:
            same = (np.array_equal(a, b) if isinstance(b, np.ndarray)
                    else a == b)
        if not same:
            raise AssertionError(f"mesh {what}: {k} differs from the plain "
                                 f"version: {a!r} vs {b!r}")
    return float(np.abs(got["iv"].astype(np.int64)
                        - want["iv"].astype(np.int64)).max())


# The one-device user tables share one table of bodies (so one library):
# the built-in fib and sum, a user BUMP, tests/test_device.py's alloc/free
# chain, and fib written as user bodies (UFIB, its continuation USUM: the
# built-in fib's spawn order, through ctx).
BUILTIN_FIB, BUILTIN_SUM, BUMP, CHAIN, UFIB, USUM = range(6)


def _bump1(ctx):
    ctx.set_value(1, ctx.value(1) + ctx.arg(0))


def _chain_free(ctx):
    base = ctx.alloc_values(2)
    ctx.set_value(base, ctx.arg(0))
    ctx.free_values(base)
    if ctx.arg(0) > 0:
        ctx.spawn(CHAIN, [ctx.arg(0) - 1])


CHAIN_FREE_CUDA = f"""
  const int base = ctx.alloc_values(2);
  ctx.set_value(base, ctx.arg(0));
  ctx.free_values(base);
  if (ctx.arg(0) > 0) {{
    const int a = ctx.arg(0) - 1;
    ctx.spawn({CHAIN}, &a, 1);
  }}"""


def _ufib(ctx):
    n = ctx.arg(0)
    if n < 2:
        ctx.set_out(n)
        return
    s = ctx.spawn(USUM, dep_count=2, out=ctx.out_slot)
    ctx.take_continuation(s)
    base = ctx.row_values(s)
    ctx.set_arg(s, 0, base)
    ctx.set_arg(s, 1, base + 1)
    ctx.spawn(UFIB, [n - 1], succ0=s, out=base)
    ctx.spawn(UFIB, [n - 2], succ0=s, out=base + 1)


UFIB_CUDA = f"""
  const int n = ctx.arg(0);
  if (n < 2) {{
    ctx.set_out(n);
    return;
  }}
  const int s = ctx.spawn({USUM}, nullptr, 0, 2, NO_TASK, NO_TASK,
                          ctx.out_slot());
  ctx.take_continuation(s);
  const int base = ctx.row_values(s);
  ctx.set_arg(s, 0, base);
  ctx.set_arg(s, 1, base + 1);
  int a = n - 1;
  ctx.spawn({UFIB}, &a, 1, 0, s, NO_TASK, base);
  a = n - 2;
  ctx.spawn({UFIB}, &a, 1, 0, s, NO_TASK, base + 1);"""


def _usum(ctx):
    ctx.set_out(ctx.value(ctx.arg(0)) + ctx.value(ctx.arg(1)))


USER_TABLE = [
    "fib", "sum",
    ("bump", _bump1, "ctx.set_value(1, ctx.value(1) + ctx.arg(0));"),
    ("chain", _chain_free, CHAIN_FREE_CUDA),
    ("ufib", _ufib, UFIB_CUDA),
    ("usum", _usum,
     "ctx.set_out(ctx.value(ctx.arg(0)) + ctx.value(ctx.arg(1)));"),
]


def user_megakernel(capacity: int, device, num_values=None):
    """USER_TABLE with every row's value block (fib and UFIB write their
    children's values there) plus 16 host slots."""
    from hclib_tpu_torch.device.megakernel import VBLOCK, Megakernel

    return Megakernel(
        USER_TABLE, capacity=capacity,
        num_values=num_values or VBLOCK * capacity + 16, succ_capacity=8,
        uses_row_values=True, device=device)


def _user_tables(device):
    from hclib_tpu_torch.device.megakernel import Megakernel

    return {"chain_free": Megakernel(USER_TABLE, capacity=16, num_values=16,
                                     succ_capacity=8, device=device),
            "mixed": user_megakernel(1024, device),
            "ufib": user_megakernel(256, device)}


def user_sources():
    """The generated sources of every user library these holds and
    ``chip_smoke.py`` build: USER_TABLE's, the dry run's tables, the PGAS
    exchange's, the lock workload's, and the migrating configuration's
    of the homed fib (scalar and width 8), unified_load's table (scalar
    and width 8) and the dry run's phase 0; and the injecting libraries:
    the fib forest's (steal-only), the PGAS exchange's, the bump
    table's (tenants) and those of JAX's three compositions that inject
    (migrating); and those with the fault layer: the bump table's
    steal-only and migrating, the PGAS exchange's with steal, and a table
    of built-in bodies alone migrating (UTS_FAULT's); and the observed
    ones (``OBS_CASES`` and phase 31); and the ring kernel's traced PGAS
    exchange and fan (``RING_CASES`` and phase 32)."""
    from hclib_tpu_torch.device.megakernel import Megakernel
    from hclib_tpu_torch.device.workloads import make_fib_megakernel

    def table(rows, **kw):
        return Megakernel(list(rows), capacity=16, num_values=64,
                          succ_capacity=8, device="cpu", **kw)

    return [user_megakernel(16, "cpu").user_source(),
            stress.bump_megakernel("cpu").user_source(),
            stress.pgas_megakernel(device="cpu").user_source(),
            stress.put_consume_megakernel("cpu").user_source(),
            stress.lock_megakernel(device="cpu").user_source(),
            homed_megakernel(64, 0, "cpu").user_source(True, home=True),
            homed_megakernel(64, 8, "cpu").user_source(True, home=True),
            stress.unified_megakernel(64, 0, "cpu").user_source(
                True, home=True),
            stress.unified_megakernel(64, 8, "cpu").user_source(
                True, home=True),
            stress.dryrun0_megakernel("cpu").user_source(True, home=True),
            make_fib_megakernel(16, device="cpu").user_source(
                False, inject=True),
            stress.pgas_megakernel(device="cpu").user_source(
                True, inject=True),
            stress.bump_megakernel("cpu").user_source(False, inject=True),
            table(stress.COMPOSE_TABLE).user_source(True, True, True),
            table(stress.FIVE_WAY_TABLE).user_source(True, True, True),
            table(stress.VOLUME_TABLE).user_source(True, True, True),
            stress.fault_megakernel(64, "cpu").user_source(False,
                                                           fault=True),
            stress.fault_megakernel(64, "cpu").user_source(True, True,
                                                           fault=True),
            stress.pgas_megakernel(device="cpu").user_source(True,
                                                             fault=True),
            make_fib_megakernel(16, device="cpu").user_source(True, True,
                                                              fault=True),
            # the observed instances (HCLIB_USER_OBS): the parked-wait
            # table (PGAS), a table of built-in bodies alone migrating
            # (the homed fib, phase 31's UTS) and injecting (phase 31's
            # forest), the bump table injecting (injection and tenancy)
            # and migrating with the fault layer
            stress.ckpt_waits_resident(device="cpu").mk.user_source(
                True, obs=True),
            make_fib_megakernel(16, device="cpu").user_source(
                True, True, obs=True),
            make_fib_megakernel(16, device="cpu").user_source(
                False, inject=True, obs=True),
            stress.bump_megakernel("cpu").user_source(False, inject=True,
                                                      obs=True),
            stress.bump_megakernel("cpu").user_source(True, True, fault=True,
                                                      obs=True),
            # the ring kernel's (RING_CASES): the PGAS exchange traced,
            # and the fan (built-in fib routed at width 8, PGAS)
            stress.pgas_megakernel(device="cpu").user_source(True, obs=True),
            fan_megakernel("cpu").user_source(True)]


USER_CASES = ("chain_free", "mixed", "ufib")


def user_builder(name: str, n: int = 14) -> TaskGraphBuilder:
    """The graph of user case ``name`` (``ufib``: UFIB(n) into slot 0)."""
    b = TaskGraphBuilder()
    if name == "chain_free":
        b.add(CHAIN, args=[200])
    elif name == "mixed":
        b.add(BUILTIN_FIB, args=[16], out=0)
        for i in range(32):
            b.add(BUMP, args=[i + 1])
        b.reserve_values(2)
    else:
        b.add(UFIB, args=[n], out=0)
        b.reserve_values(1)
    return b


def run_user_case(name: str, device: str) -> dict:
    """One single-device user table on ``device``: the state after one
    launch (task table, ready ring, counts, value slots)."""
    mk = _user_tables(device)[name]
    st = mk.state(user_builder(name))
    mk.fold_dispatches(mk.launch(st))
    return {k: st[k].cpu().numpy() for k in ("tasks", "ready", "counts",
                                             "ivalues")}


def user_forest(ndev: int, roots: int, n: int, device: str):
    """``roots`` UFIB(n) roots dealt round-robin over ``ndev`` devices
    through the sharded runner without steal (one grid launch of the
    user library's scheduler); raises unless the totals are exact.
    Returns (ivalues, info)."""
    from hclib_tpu_torch.device.megakernel import VBLOCK
    from hclib_tpu_torch.models.fib import fib_seq, task_count

    cap = 64 + 4 * n + roots // ndev
    mk = user_megakernel(cap, device, VBLOCK * cap + roots)
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    for r in range(roots):
        bs[r % ndev].add(UFIB, args=[n], out=r)
    for b in bs:
        b.reserve_values(roots)
    iv, _, info = ShardedMegakernel(
        mk, CtaMesh((ndev,), ("q",), device=device)).run(bs)
    per_root = task_count(n) + (task_count(n) - 1) // 2
    got = int(np.asarray(iv)[:, :roots].sum(dtype=np.int64))
    if info["executed"] != roots * per_root or got != roots * fib_seq(n):
        raise AssertionError(f"user forest: executed {info['executed']}, "
                             f"sum {got}")
    return iv, info


# PGASMegakernel's ring kernel (``pgas_ring_kernel``, counter
# ``pgas_ring``: row 6, a mesh whose size is not a power of two) against
# its plain version. name: (load, ndev, run kwargs). ``pgas``: the PGAS
# exchange (stress.pgas_builders with the burst; its table traced with
# ``trace``, cut by ``abort``); ``dryrun4``: the multi-chip dry run's
# phase 4 literally (stress.dryrun_builders(4, ndev)); ``fan``: every
# device's FAN sends every device an active message FIB(FAN_N) whose
# result lands in slot me, FIB routed at width 8 (the messages install
# between rounds, after the lanes' spill).
RING_CASES = {
    "ring_pgas_3": ("pgas", 3, dict(am_window=2)),
    "ring_pgas_6": ("pgas", 6, {}),
    "ring_pgas_3_traced": ("pgas", 3, dict(am_window=2, trace=256)),
    "ring_pgas_6_traced": ("pgas", 6, dict(trace=256)),
    "ring_abort_6": ("pgas", 6, dict(abort=[0, 0, 1, 0, 0, 0])),
    "ring_dryrun4_3": ("dryrun4", 3, {}),
    "ring_dryrun4_6": ("dryrun4", 6, {}),
    "ring_fan_6_b8": ("fan", 6, {}),
}
FAN, FAN_N = 2, 9


def _fan(ctx):
    p = ctx.pgas
    for d in range(p.ndev):
        p.am(d, FIB, args=[ctx.arg(0)], out=p.me)


FAN_CUDA = f"""
  for (int d = 0; d < ctx.pgas.ndev; ++d) {{
    const int a = ctx.arg(0);
    ctx.pgas.am(d, {FIB}, &a, 1, ctx.pgas.me);
  }}"""


def fan_megakernel(device, capacity: int = 1024):
    """The fan's table: the built-in fib and sum (FIB routed at width 8,
    every row's value block) and FAN, plus 64 host slots."""
    from hclib_tpu_torch.device.megakernel import VBLOCK, Megakernel
    from hclib_tpu_torch.device.workloads import batch_of

    return Megakernel(["fib", "sum", ("fan", _fan, FAN_CUDA)],
                      capacity=capacity, num_values=VBLOCK * capacity + 64,
                      succ_capacity=8, uses_row_values=True,
                      route=batch_of("fib", 8), device=device)


def ring_run(load: str, ndev: int, device: str, trace=None, abort=None,
             capacity: int = 512, **kw):
    """One run of the ring kernel's ``load`` on ``ndev`` devices (``kw``:
    PGASMegakernel's ``am_window`` / ``outbox``), exact or raising
    (an aborted run: ``info['aborted']``). Returns (ivalues, data,
    info)."""
    if ndev & (ndev - 1) == 0:
        raise ValueError(f"{ndev} devices run the resident kernel")
    mesh = CtaMesh((ndev,), ("q",), device=device)
    if load == "fan":
        from hclib_tpu_torch.models.fib import fib_seq, task_count

        bs = [TaskGraphBuilder() for _ in range(ndev)]
        for b in bs:
            b.add(FAN, args=[FAN_N])
            b.reserve_values(ndev)
        iv, data, info = PGASMegakernel(fan_megakernel(device), mesh,
                                        **kw).run(bs, quantum=64)
        tasks = task_count(FAN_N) + (task_count(FAN_N) - 1) // 2
        if info["executed"] != ndev * (1 + ndev * tasks) or not (
                np.asarray(iv)[:, :ndev] == fib_seq(FAN_N)).all():
            raise AssertionError(f"ring fan: executed {info['executed']}, "
                                 f"slots {np.asarray(iv)[:, :ndev]}")
        return iv, data, info
    if load == "dryrun4":
        mk = stress.put_consume_megakernel(device)
        bs, waits, heap = stress.dryrun_builders(4, ndev)
    else:
        mk = stress.pgas_megakernel(capacity, device, trace=trace)
        bs, waits, heap = stress.pgas_builders(ndev, True)
    pg = PGASMegakernel(mk, mesh, channels={"c0": ("heap", 1)}, **kw)
    iv, data, info = pg.run(bs, data={"heap": heap}, waits=waits,
                            abort=abort)
    if abort is not None:
        if not info["aborted"]:
            raise AssertionError(f"ring {load}: the abort did not cut it")
    elif load == "dryrun4":
        if info["pending"] != 0 or not (np.asarray(iv)[:, :2] == 1).all():
            raise AssertionError(f"ring dry run phase 4: {iv[:, :2]}")
    else:
        stress.check_pgas(iv, data["heap"].cpu().numpy(), info, ndev, True)
    return iv, data, info


def ring_result(iv, data, info) -> dict:
    """What a ring-kernel run is compared on: every device's value slots
    and counts row, the rounds, the tier counters, aborted, the messages,
    puts and stat words sent, the data buffers and each device's decoded
    records."""
    ex = info["exchange"]
    return _obs_fields({
        "iv": np.asarray(iv),
        "counts": np.asarray(info["per_device_counts"]),
        "rounds": info["rounds"], "tiers": info.get("tiers"),
        "aborted": info["aborted"], "stat_words": ex["stat_words"],
        "ams": ex["ams"], "puts": ex["puts"],
        "data": {k: v.cpu().numpy() for k, v in data.items()},
        "executed": info["executed"], "pending": info["pending"],
        "kernel_ms": ex["kernel_ms"]}, info)


def run_ring_case(name: str, device: str) -> dict:
    """Ring case ``name`` on ``device``; returns what it is compared
    on."""
    load, ndev, kw = RING_CASES[name]
    return ring_result(*ring_run(load, ndev, device, **kw))


# chip_smoke.py's phase 31 (``mesh_ckpt``): quiesce, resume and the flight
# recorder at full width. UTS depth 20 (498,965 nodes from one root) on
# 128 CTAs under homed migration (stress.uts_ckpt): without the quiesce
# word (the unobserved instance), checkpoint-built, traced; quiesced at
# half its rounds, bundled, saved, loaded and restored on 128 CTAs, then
# resharded onto 64; the traced run quiesced at the same round on the
# card and on the plain version (word for word); the injected forest
# (stress.INJECT_128) cut at round 0 (every ring row residue) and at half
# its rounds; and the forest traced on the ring at 6 CTAs.
PHASE31_TRACE = 8192  # records a device: UTS depth 20 on 128 CTAs writes ~2,200


def _state_bytes(state) -> int:
    """Bytes of an exported state (every array, data included)."""
    n = sum(np.asarray(v).nbytes for k, v in state.items() if k != "data")
    return n + sum(np.asarray(v).nbytes for v in state["data"].values())


def _uts_nodes(iv) -> int:
    return int(np.asarray(iv)[:, 0].sum(dtype=np.int64))


def _hold(iv, info) -> dict:
    """A resident run's outputs, for ``compare``."""
    return _obs_fields(_resident_result(iv, {}, info), info)


def _cut_hold(iv, info) -> dict:
    """stress.inject_forest's quiesced run (``info['quiesce_run']``, its
    ivalues from the exported state) and its resume, for ``compare``."""
    qi = info["quiesce_run"]
    out = _hold(iv, info)
    out.update({"quiesce/" + k: v
                for k, v in _hold(qi["state"]["ivalues"], qi).items()})
    return out


def ckpt_uts_arm(device: str, quiesce=None, trace=None, ndev: int = 128,
                 depth: int = 20):
    """One run of phase 31's tree (a fresh mesh); returns (the mesh,
    ivalues, info)."""
    rk, bs = stress.uts_ckpt(ndev, depth, trace=trace, device=device)
    iv, _, info = rk.run(bs, quantum=64, quiesce=quiesce)
    return rk, iv, info


def ckpt_phase(device: str, tmp: str, ndev: int = 128, depth: int = 20,
               inject=None, ring=(6, 160, 12)) -> dict:
    """Phase 31's arms on ``device`` (each warmed up; the card's times by
    CUDA events), exact or raising: the tree at ``depth`` on ``ndev``
    devices, the injected forest ``inject`` (stress.inject_forest's
    arguments; INJECT_128 by default) and the ring's forest ``ring`` (its
    devices, roots and n). Returns {arm: measurements} under ``arms``;
    under ``holds`` every run ``ckpt_plain_holds`` holds to its plain
    version (the tree's quiesce, traced and not, its restore on ``ndev``
    and its reshard onto half, both of the forest's cuts with their
    resumes, the traced ring), and under ``bundle`` the bundle the
    restores read."""
    import os
    import time

    from hclib_tpu_torch.runtime import checkpoint as ck

    inject = stress.INJECT_128 if inject is None else inject
    arms: dict = {}
    holds: dict = {}

    def run_twice(fn):
        fn()
        return fn()

    def uts_exact(name, iv, info, executed=None):
        if _uts_nodes(iv) != N or info["executed"] != (executed or N) or (
                info["pending"] != 0):
            raise AssertionError(f"{name}: {_uts_nodes(iv)} nodes, executed "
                                 f"{info['executed']}, {info['pending']} "
                                 "pending")

    # (i) the tree without the quiesce word, then checkpoint-built.
    rk0, bs0 = stress.uts_ckpt(ndev, depth, checkpoint=False, device=device)
    iv, _, info = run_twice(lambda: rk0.run(bs0, quantum=64))
    N = _uts_nodes(iv)
    uts_exact("uts_noobs", iv, info)
    arms["uts_noobs"] = {"kernel_ms": info["exchange"]["kernel_ms"],
                         "rounds": info["rounds"], "tasks": info["executed"]}
    _, iv, info = run_twice(lambda: ckpt_uts_arm(device, ndev=ndev,
                                                 depth=depth))
    uts_exact("uts", iv, info)
    full = info
    R = info["rounds"]
    arms["uts"] = {"kernel_ms": info["exchange"]["kernel_ms"], "rounds": R,
                   "tasks": info["executed"],
                   "quiesced": info["quiesced"]}
    # Quiesced at half the rounds; bundled, saved, loaded, restored.
    q = R // 2
    rk, iv, info_q = run_twice(lambda: ckpt_uts_arm(device, quiesce=q,
                                                    ndev=ndev, depth=depth))
    holds["uts_quiesce"] = _hold(iv, info_q)
    if not info_q["quiesced"] or info_q["pending"] == 0:
        raise AssertionError(f"uts quiesced at {q}: {info_q['pending']}")
    arm = {"quiesce_round": q, "kernel_ms": info_q["exchange"]["kernel_ms"],
           "rounds": info_q["rounds"], "executed": info_q["executed"],
           "pending": info_q["pending"],
           "state_bytes": _state_bytes(info_q["state"])}
    t = time.perf_counter()
    bundle = ck.snapshot_resident(rk, info_q)
    arm["snapshot_s"] = time.perf_counter() - t
    path = os.path.join(tmp, "uts128")
    t = time.perf_counter()
    bundle.save(path)
    arm["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loaded = ck.CheckpointBundle.load(path)
    arm["load_s"] = time.perf_counter() - t
    rk128, _ = stress.uts_ckpt(ndev, depth, device=device)
    t = time.perf_counter()
    iv, _, info = ck.restore_resident(loaded, rk128, quantum=64)
    arm["restore_s"] = time.perf_counter() - t
    uts_exact(f"uts restored on {ndev}", iv, info, full["executed"])
    holds["uts_restore"] = _hold(iv, info)
    arm["resume_kernel_ms"] = info["exchange"]["kernel_ms"]
    arm["resume_rounds"] = info["rounds"]
    arms["uts_quiesce"] = arm
    # Resharded onto half the CTAs.
    t = time.perf_counter()
    half = loaded.reshard(ndev // 2)
    reshard_s = time.perf_counter() - t
    rk64, _ = stress.uts_ckpt(ndev // 2, depth, device=device)
    iv, _, info = ck.restore_resident(half, rk64, quantum=64)
    uts_exact(f"uts resharded onto {ndev // 2}", iv, info, full["executed"])
    holds["uts_reshard"] = _hold(iv, info)
    arms["uts_reshard"] = {"ndev": ndev // 2, "reshard_s": reshard_s,
                           "kernel_ms": info["exchange"]["kernel_ms"],
                           "rounds": info["rounds"]}
    # (ii) traced, at a capacity that does not wrap.
    _, iv, info = run_twice(lambda: ckpt_uts_arm(
        device, trace=PHASE31_TRACE, ndev=ndev, depth=depth))
    uts_exact("uts traced", iv, info)
    rings = info["trace"]["rings"]
    recs = [np.asarray(r["records"]) for r in rings]
    n_tag = [{tag: int((r[:, 0] == tag).sum()) if r.size else 0
              for tag in (1, 2, 3, 9)} for r in recs]
    if any(r["dropped"] for r in rings) or any(
            n[1] != info["rounds"] or n[2] != info["rounds"] for n in n_tag):
        raise AssertionError("uts traced: a ring wrapped, or its round "
                             "records differ from the rounds")
    fires = sum(n[3] for n in n_tag)
    xfer = [int(r[r[:, 0] == 9, 3].sum()) if r.size else 0 for r in recs]
    if fires != info["executed"] or xfer != info["exchange"]["rows"]:
        raise AssertionError(f"uts traced: {fires} fire records, xfer rows "
                             f"{sum(xfer)} vs {sum(info['exchange']['rows'])}")
    arms["uts_traced"] = {
        "kernel_ms": info["exchange"]["kernel_ms"], "rounds": info["rounds"],
        "tasks": info["executed"], "records": int(sum(len(r) for r in recs)),
        "max_records": int(max(len(r) for r in recs)),
        "rows_exported": sum(info["exchange"]["rows"]),
        "recorder_us_a_round": 1e3 * (info["exchange"]["kernel_ms"]
                                      - arms["uts"]["kernel_ms"]) / R}
    # The traced run quiesced at the same round: what the plain version
    # is held to, word for word.
    _, iv, info = ckpt_uts_arm(device, quiesce=q, trace=PHASE31_TRACE,
                               ndev=ndev, depth=depth)
    holds["uts_traced_quiesce"] = _hold(iv, info)
    arms["uts_traced_quiesce"] = {"kernel_ms": info["exchange"]["kernel_ms"],
                                  "executed": info["executed"],
                                  "pending": info["pending"]}
    # (iii) the injected forest cut at round 0 and at half its rounds.
    for name, qq in (("inject_q0", True), ("inject_half", None)):
        if qq is None:
            qq = arms["inject_q0"]["resume_rounds"] // 2
        iv, info = run_twice(lambda: stress.inject_forest(
            **inject, device=device, quiesce=qq))
        qi = info["quiesce_run"]
        holds[name] = _cut_hold(iv, info)
        arms[name] = {
            "quiesce_round": 0 if qq is True else qq,
            "kernel_ms": qi["exchange"]["kernel_ms"],
            "executed_at_cut": qi["executed"], "pending": qi["pending"],
            "residue": int(qi["state"]["ictl"][:, 0].sum()),
            "consumed": int(qi["inject_ctl"][:, 2].sum()),
            "published": int(qi["inject_ctl"][:, 0].sum()),
            "resume_kernel_ms": info["exchange"]["kernel_ms"],
            "resume_rounds": info["rounds"], "tasks": info["executed"],
            "state_bytes": _state_bytes(qi["state"])}
    # The ring observed: FOREST_STEAL_BENCH's forest traced on 6 CTAs.
    rn, roots, n = ring
    mk = stress.forest_megakernel(roots, 4096, 0, device,
                                  trace=PHASE31_TRACE)
    ring_k = ICIStealMegakernel(mk, CtaMesh((rn,), ("q",), device=device),
                                migratable_fns=[FIB], window=8)
    bs = stress.forest_builders(rn, roots, n)
    iv, _, info = run_twice(lambda: ring_k.run(bs, quantum=64))
    info["rounds"] = info.pop("steal_rounds")
    stress.check_forest(iv, info, roots, n)
    arms["ring_6_traced"] = {
        "kernel_ms": info["exchange"]["kernel_ms"], "rounds": info["rounds"],
        "tasks": info["executed"],
        "records": int(sum(r["written"] for r in info["trace"]["rings"])),
        "records_kept": int(sum(len(r["records"])
                                for r in info["trace"]["rings"])),
        "rows_exported": sum(info["exchange"]["rows"])}
    holds["ring_6_traced"] = _ring_result(iv, info)
    return {"arms": arms, "holds": holds, "bundle": loaded}


def ckpt_plain_holds(ck: dict, ndev: int = 128, depth: int = 20,
                     inject=None, ring=(6, 160, 12)) -> dict:
    """The plain runs of ``ckpt_phase``'s result ``ck`` (same arguments):
    the traced tree quiesced at its round (the untraced cut is held to
    the same run, less its records), restored on ``ndev`` and resharded
    onto half from the card's bundle, the injected forest cut where the
    card cut it and resumed, and the traced forest on the ring. Returns
    them under ``holds`` and their wall times under ``plain_ms``."""
    import time

    from hclib_tpu_torch.runtime import checkpoint as ck_mod

    inject = stress.INJECT_128 if inject is None else inject
    arms = ck["arms"]
    holds, ms = {}, {}

    def timed(name, fn):
        t = time.perf_counter()
        holds[name] = fn()
        ms[name] = (time.perf_counter() - t) * 1e3

    q = arms["uts_quiesce"]["quiesce_round"]
    timed("uts_traced_quiesce", lambda: _hold(*ckpt_uts_arm(
        "cpu", quiesce=q, trace=PHASE31_TRACE, ndev=ndev, depth=depth)[1:]))
    holds["uts_quiesce"] = {k: v for k, v in
                            holds["uts_traced_quiesce"].items()
                            if not k.startswith("trace/")}
    for name, n in (("uts_restore", ndev), ("uts_reshard", ndev // 2)):
        rk, _ = stress.uts_ckpt(n, depth, device="cpu")
        timed(name, lambda rk=rk: _hold(*ck_mod.restore_resident(
            ck["bundle"], rk, quantum=64)[::2]))
    for name in ("inject_q0", "inject_half"):
        qq = arms[name]["quiesce_round"] or True
        timed(name, lambda qq=qq: _cut_hold(*stress.inject_forest(
            **inject, device="cpu", quiesce=qq)))
    rn, roots, n = ring
    mk = stress.forest_megakernel(roots, 4096, 0, "cpu", trace=PHASE31_TRACE)
    ring_k = ICIStealMegakernel(mk, CtaMesh((rn,), ("q",), device="cpu"),
                                migratable_fns=[FIB], window=8)

    def ring_run():
        iv, _, info = ring_k.run(stress.forest_builders(rn, roots, n),
                                 quantum=64)
        info["rounds"] = info.pop("steal_rounds")
        return _ring_result(iv, info)
    timed("ring_6_traced", ring_run)
    return {"holds": holds, "plain_ms": ms}
