"""The port's mesh runners (hclib_tpu_torch/device/{sharded,ici_steal,
resident,stress}.py, a mesh device being one CTA on the card) held to the
JAX package's on the same seeded fib forests, word for word: the value
slots of every device, every device's counts row, the rounds, the tier
counters and the fault stats.

The port runs its plain versions (``cpu_mesh``); JAX runs its sharded
runner over ``make_fib_megakernel(interpret=True)`` on the suite's
virtual CPU devices, and its in-kernel runners in Mosaic's interpret
mode - one run each (the 3-device ring, the 4-device resident steal in a
hop order that sends a row on over two hops), shared through module
fixtures and kept to a few tasks, because the interpreter costs seconds
a task. The rest is held to exact totals and to
the plain versions' own invariants: the abort word's lockstep exit, the
one-device self-exchange, a 4x2 mesh, the batch-routed ring, and the
refusals of what this slice does not run yet.
"""


import numpy as np
import pytest
import torch

from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.ici_steal import ICIStealMegakernel as JIci
from hclib_tpu.device.resident import ResidentKernel as JResident
from hclib_tpu.device.sharded import ShardedMegakernel as JSharded
from hclib_tpu.parallel.mesh import cpu_mesh as jax_mesh
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import stress as tstress
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel as TIci
from hclib_tpu_torch.device.resident import ResidentKernel
from hclib_tpu_torch.device.sharded import ShardedMegakernel as TSharded
from hclib_tpu_torch.device.sharded import abort_words
from hclib_tpu_torch.models.fib import fib_seq, task_count
from hclib_tpu_torch.parallel.mesh import CtaMesh, cpu_mesh
from hclib_tpu_torch.runtime.resilience import DeviceFaultPlan

FIB = 0


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


def forest(B, ndev, sizes, devices=None):
    """A fib forest: root r is FIB(sizes[r]) with out slot r, on device
    devices[r] (default 0); the root slots are reserved everywhere."""
    bs = [B() for _ in range(ndev)]
    for r, n in enumerate(sizes):
        bs[devices[r] if devices else 0].add(FIB, args=[n], out=r)
    for b in bs:
        b.reserve_values(len(sizes))
    return bs


def seeded_sizes(seed, roots, lo, hi):
    return [int(x) for x in np.random.default_rng(seed).integers(lo, hi + 1,
                                                                roots)]


def makers(cap, roots, batch_width=0):
    nv = tw.VBLOCK * cap + max(64, roots)
    return (
        lambda: jw.make_fib_megakernel(capacity=cap, interpret=True,
                                       num_values=nv,
                                       batch_width=batch_width or None),
        lambda: tw.make_fib_megakernel(capacity=cap, num_values=nv,
                                       batch_width=batch_width or None,
                                       device="cpu"),
    )


def expected(sizes):
    tasks = sum(task_count(n) + (task_count(n) - 1) // 2 for n in sizes)
    return tasks, sum(fib_seq(n) for n in sizes)


def assert_same(jout, tout, keys):
    jiv, _, ji = jout
    tiv, _, ti = tout
    np.testing.assert_array_equal(np.asarray(jiv), tiv)
    np.testing.assert_array_equal(np.asarray(ji["per_device_counts"]),
                                  ti["per_device_counts"])
    for k in keys:
        assert ji.get(k) == ti.get(k), (k, ji.get(k), ti.get(k))


# ------------------------------------------------ the sharded runner vs JAX

SHARDED = {
    # name: (ndev, roots' sizes, devices, capacity, batch width, run kw)
    "nosteal_4": (4, seeded_sizes(1, 12, 4, 8), [r % 4 for r in range(12)],
                  64, 0, {}),
    "steal_8_skewed": (8, seeded_sizes(2, 24, 5, 8), None, 64, 0,
                       dict(steal=True, quantum=16, window=8)),
    "hop_order_4": (4, seeded_sizes(3, 12, 4, 7), None, 64, 0,
                    dict(steal=True, quantum=16, window=8,
                         hop_order=[2, 1])),
    "batch8_8": (8, seeded_sizes(4, 24, 5, 8), None, 256, 8,
                 dict(steal=True, quantum=16, window=8)),
    "forest_quick": (tstress.FOREST_STEAL_QUICK["ndev"],
                     [tstress.FOREST_STEAL_QUICK["n"]]
                     * tstress.FOREST_STEAL_QUICK["roots"], None,
                     tstress.FOREST_STEAL_QUICK["capacity"], 0,
                     dict(steal=True, quantum=256, window=16)),
}


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_equals_jax(name):
    ndev, sizes, devices, cap, bw, kw = SHARDED[name]
    jmk, tmk_ = makers(cap, len(sizes), bw)
    jout = JSharded(jmk(), jax_mesh(ndev, axis_name="q"),
                    migratable_fns=[FIB]).run(
        forest(JBuilder, ndev, sizes, devices), **kw)
    tout = TSharded(tmk_(), cpu_mesh(ndev, axis_name="q"),
                    migratable_fns=[FIB]).run(
        forest(TBuilder, ndev, sizes, devices), **kw)
    assert_same(jout, tout, ("executed", "pending", "overflow",
                             "steal_rounds", "tiers"))
    tasks, total = expected(sizes)
    assert tout[2]["executed"] == tasks
    assert int(tout[0][:, :len(sizes)].sum()) == total
    if kw.get("steal"):
        assert int((tout[2]["per_device_counts"][:, 5] > 0).sum()) >= 3


# ------------------------- the in-kernel runners vs JAX's Mosaic interpreter

# Two FIB(2) roots on device 0 and a quantum of one root's subtree (4
# tasks): round 0 runs one root and moves the other, round 1 runs it on
# the thief, which spawns its subtree there. On the ring (3 devices) the
# root moves once; on the resident kernel (4 devices, hop order [2, 1])
# it moves twice in round 0: to device 2 on the first hop, then, imported
# there, on to device 3 on the second, after the stat fold of both hops.
MOSAIC_SIZES, MOSAIC_QUANTUM, MOSAIC_CAP = [2, 2], 4, 16
RESIDENT_HOPS = [2, 1]


def _mosaic_pair(ndev, hop_order=None):
    jmk, tmk_ = makers(MOSAIC_CAP, len(MOSAIC_SIZES))
    kw = dict(quantum=MOSAIC_QUANTUM)
    if hop_order is None:  # the ICI runner: the ring on 3 devices
        jm = JIci(jmk(), jax_mesh(ndev, axis_name="q"),
                  migratable_fns=[FIB], window=8)
        tm = TIci(tmk_(), cpu_mesh(ndev, axis_name="q"),
                  migratable_fns=[FIB], window=8)
    else:
        kw["hop_order"] = hop_order
        jm = JResident(jmk(), jax_mesh(ndev, axis_name="q"),
                       migratable_fns=[FIB], homed=False, window=8)
        tm = ResidentKernel(tmk_(), cpu_mesh(ndev, axis_name="q"),
                            migratable_fns=[FIB], homed=False, window=8)
    return (jm.run(forest(JBuilder, ndev, MOSAIC_SIZES), **kw),
            tm.run(forest(TBuilder, ndev, MOSAIC_SIZES), **kw))


@pytest.fixture(scope="module")
def ring3():
    return _mosaic_pair(3)


@pytest.fixture(scope="module")
def resident4():
    return _mosaic_pair(4, RESIDENT_HOPS)


def test_ring_equals_jax_at_3_devices(ring3):
    jout, tout = ring3
    assert_same(jout, tout, ("executed", "pending", "overflow",
                             "steal_rounds", "aborted"))
    per_dev = tout[2]["per_device_counts"][:, 5]
    assert per_dev[1] > 0 and tout[2]["steal_rounds"] >= 2


def test_resident_steal_equals_jax_at_4_devices(resident4):
    """Two XOR hops in hop order [2, 1]: the root exported on the first
    hop is exported again on the second, and runs on device 3."""
    jout, tout = resident4
    assert_same(jout, tout, ("executed", "pending", "overflow", "rounds",
                             "aborted", "fault_stats"))
    assert tout[2]["per_device_counts"][:, 5].tolist() == [4, 0, 0, 4]


# ------------------------- exact totals and the plain versions' invariants


def _fib_mk(cap=256, roots=64, batch_width=0):
    return makers(cap, roots, batch_width)[1]()


@pytest.mark.parametrize("ndev", [3, 4])
def test_abort_exits_the_mesh_in_lockstep(ndev):
    """An abort word set on one device exits every device after the round
    that folds it: one round, quantum tasks on the seeded device, the
    fault stats' abort round 0 on every device (resident)."""
    sizes = [10] * 4
    m = TIci(_fib_mk(), cpu_mesh(ndev), migratable_fns=[FIB])
    flags = [0] * ndev
    flags[-1] = 1
    _, _, info = m.run(forest(TBuilder, ndev, sizes), quantum=8,
                       abort=flags)
    assert info["aborted"] and info["steal_rounds"] == 1
    assert info["executed"] == 8 and info["pending"] > 0
    if ndev == 4:  # power of two: the resident kernel
        assert [f["abort_round"] for f in info["fault_stats"]] == [0] * 4
    assert abort_words(True, ndev)[:, 0].tolist() == [1] * ndev
    with pytest.raises(ValueError, match="per-device flags"):
        abort_words([1], ndev)


def test_one_device_ring_self_exchange():
    """A one-device ring exchanges with itself (hop distance 0): nothing
    moves, the run completes, one round a quantum."""
    sizes = [7, 6]
    _, total = expected(sizes)
    m = TIci(_fib_mk(), cpu_mesh(1), migratable_fns=[FIB])
    iv, _, info = m._run_ring(forest(TBuilder, 1, sizes), quantum=16)
    tasks, _ = expected(sizes)
    assert info["executed"] == tasks and int(iv[0, :2].sum()) == total
    assert info["steal_rounds"] == -(-tasks // 16)


def test_4x2_mesh_is_the_8_device_hypercube():
    """A 4x2 mesh numbers its devices row-major, so its XOR hops (minor
    axis first) are the 8-device 1D mesh's: the same result word for
    word, exact totals."""
    sizes = seeded_sizes(5, 16, 6, 9)
    runs = []
    for mesh in (CtaMesh((4, 2), ("x", "y"), device="cpu"), cpu_mesh(8)):
        rk = ResidentKernel(_fib_mk(), mesh, migratable_fns=[FIB],
                            homed=False)
        runs.append(rk.run(forest(TBuilder, 8, sizes), quantum=16))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][2]["per_device_counts"],
                                  runs[1][2]["per_device_counts"])
    tasks, total = expected(sizes)
    assert runs[0][2]["executed"] == tasks
    assert int(runs[0][0][:, :16].sum()) == total
    assert int((runs[0][2]["per_device_counts"][:, 5] > 0).sum()) == 8
    hop = ResidentKernel(_fib_mk(), cpu_mesh(8), migratable_fns=[FIB],
                         homed=False).run(forest(TBuilder, 8, sizes),
                                          quantum=16, hop_order=[4, 1, 2])
    assert hop[2]["executed"] == tasks
    assert int(hop[0][:, :16].sum()) == total


def test_batch_routed_ring_exact():
    """The ring with FIB batch-routed at width 8: lanes spill before every
    exchange, totals exact, the tier counters reconcile with executed."""
    sizes = seeded_sizes(6, 12, 6, 9)
    m = TIci(_fib_mk(cap=512, batch_width=8), cpu_mesh(3),
             migratable_fns=[FIB])
    iv, _, info = m.run(forest(TBuilder, 3, sizes), quantum=16)
    tasks, total = expected(sizes)
    assert info["executed"] == tasks and int(iv[:, :12].sum()) == total
    tiers = info["tiers"]
    assert sum(t["batch_tasks"] + t["scalar_tasks"] for t in tiers) == tasks
    assert sum(t["spilled"] for t in tiers) > 0
    assert all(t["batch_rounds"] > 0 for t, n in
               zip(tiers, info["per_device_counts"][:, 5]) if n > 0)


def test_forest_steal_quick_exact():
    """stress.forest_steal on FOREST_STEAL_QUICK, scalar and at width 8:
    exact totals, every device used by the scalar arm, the info keys."""
    q = tstress.FOREST_STEAL_QUICK
    info = tstress.forest_steal(**q, device="cpu")
    assert info["tasks"] == 3912 and info["devices_used"] == q["ndev"]
    for k in ("seconds", "tasks_per_sec", "rounds", "imbalance",
              "per_device_counts", "timer"):
        assert k in info
    b = tstress.forest_steal(**q, batch_width=8, device="cpu")
    assert b["tasks"] == 3912 and b["batch_tasks"] > 0
    assert 0 < b["mean_occupancy"] <= 1


# --------------------------------------------------------------- refusals


# A plan that drops, doubles and delays credits; "fault_plan" adds a dead
# device 1 (which holds no work).
_PLAN = DeviceFaultPlan(seed=5, drop_credit_rate=0.2, dup_credit_rate=0.2,
                        delay_xfer_rate=0.2, credit_timeout=2)
REFUSED_INIT = {
    # Homed migration, value args, channels, the injection ring and mesh
    # tenancy run (tests/test_torch_homed.py, test_torch_pgas.py,
    # test_torch_inject_mesh.py), and so do fault plans on the steal
    # configurations (tests/test_torch_faults.py): "fault_plan" and
    # "homed_faults" build and run under a plan. Each other key keeps
    # naming its feature, beside the fault plan that still refuses there
    # (ROADMAP A11b.5).
    "homed_faults": dict(migratable_fns=[FIB], fault_plan=_PLAN),
    "value_args_tenants": dict(migratable_fns={FIB: (0,)}, homed=False,
                               inject=True, tenants=2, fault_plan=_PLAN),
    "channels_homed_inject": dict(channels={"c": ("x", 1)},
                                  migratable_fns=[FIB], inject=True,
                                  fault_plan=_PLAN),
    "inject": dict(inject=True, fault_plan=_PLAN),
    "tenants": dict(inject=True, tenants=2, fault_plan=_PLAN),
    "fault_plan": dict(fault_plan=DeviceFaultPlan(
        seed=5, drop_credit_rate=0.2, dead_device=1, dead_round=0,
        credit_timeout=2)),
    "pgas_inject": dict(steal=False, channels={"c": ("x", 1)}, inject=True,
                        fault_plan=_PLAN),
}


@pytest.mark.parametrize("name", sorted(REFUSED_INIT))
def test_resident_refuses_what_is_not_ported(name):
    kw = REFUSED_INIT[name]
    if name in ("fault_plan", "homed_faults"):
        # Ported: the plan builds and a forest runs exact under it (homed
        # migration: one result slot a row above the value region).
        mk = tw.make_fib_megakernel(
            capacity=256, num_values=tw.VBLOCK * 256 + 64 + 256,
            device="cpu")
        rk = ResidentKernel(mk, cpu_mesh(2), **kw)
        assert rk.plan is kw["fault_plan"]
        sizes = [8] * 4
        iv, _, info = rk.run(forest(TBuilder, 2, sizes), quantum=8)
        tasks, total = expected(sizes)
        assert info["executed"] == tasks and info["pending"] == 0
        assert int(iv[:, :4].sum()) == total
        fs = info["fault_stats"]
        assert sum(f["credits_dropped"] for f in fs) > 0
        if name == "fault_plan":
            assert fs[0]["quarantined"] == [1] and fs[1]["heartbeat"] == 0
        else:
            assert info["per_device_counts"][1, 5] > 0
        return
    with pytest.raises(NotImplementedError, match="A11b.5"):
        ResidentKernel(_fib_mk(), cpu_mesh(2), **kw)
    # The same configuration without the fault plan builds.
    if "channels" not in kw:
        kw = {k: v for k, v in kw.items() if k != "fault_plan"}
        rk = ResidentKernel(_fib_mk(), cpu_mesh(2), **kw)
        assert rk.inject == bool(kw.get("inject"))


REFUSED_RUN = {
    # Each key keeps the name of a run that refused until the mesh's
    # quiesce and resume were ported (ROADMAP A11b.6): a PGAS body's
    # atomics, inject_rows=, a plain forest, resume_state= and
    # tenant_table=. Each now quiesces, exports its state and resumes it.
    "pgas_quiesce": None,
    "inject_rows": dict(inject_rows=[[(FIB, [3], 1)], []], quiesce=True),
    "quiesce": dict(quiesce=True),
    "resume_state": dict(quiesce=1),
    "tenant_table": dict(tenant_table=True, quiesce=1),
}


def _ckpt_fib_mk():
    return tw.make_fib_megakernel(capacity=256, num_values=tw.VBLOCK * 256
                                  + 64, checkpoint=True, device="cpu")


@pytest.mark.parametrize("name", sorted(REFUSED_RUN))
def test_resident_run_refuses_what_is_not_ported(name):
    """The runs these cases refused before the quiesce was ported: each
    now quiesces (a checkpoint build; without one quiesce= refuses with
    JAX's message), exports its state and resumes it to the exact totals
    of the uninterrupted run."""
    if REFUSED_RUN[name] is None:
        def fadd(ctx):
            ctx.pgas.fadd(1, 2, 3)

        data = {"x": np.zeros((2, 2, 4), np.int32)}
        for ckpt in (False, True):
            mk = tmk.Megakernel([("fadd", fadd)],
                                data_specs={"x": ((2, 4), torch.int32)},
                                capacity=16, num_values=8, succ_capacity=8,
                                checkpoint=ckpt, device="cpu")
            rk = ResidentKernel(mk, cpu_mesh(2), steal=False,
                                channels={"c": ("x", 1)})
            bs = [TBuilder() for _ in range(2)]
            bs[0].add(0)
            if not ckpt:
                with pytest.raises(ValueError, match="checkpoint=True"):
                    rk.run(bs, data=data, quiesce=True)
                continue
            _, _, q = rk.run(bs, data=data, quiesce=True)
            assert q["quiesced"] and q["pending"] == 1
            iv, _, info = rk.run(resume_state=q["state"])
            assert info["pending"] == 0 and int(iv[1, 2]) == 3
        return
    kw = dict(REFUSED_RUN[name])
    tenants = None
    if kw.get("tenant_table"):
        from hclib_tpu_torch.device.tenants import MeshTenantTable, TenantSpec

        tenants = [TenantSpec("a"), TenantSpec("b")]
    rk = ResidentKernel(_ckpt_fib_mk(), cpu_mesh(2), migratable_fns=[FIB],
                        homed=False, inject=True, tenants=tenants)
    table = (lambda: MeshTenantTable(tenants, 2, rk.region_rows)) \
        if tenants else None
    if tenants:
        kw["tenant_table"] = table()
    bs = forest(TBuilder, 2, [7])
    for b in bs:
        b.reserve_values(2)  # slot 1: the injected root's
    _, _, q = rk.run(bs, quantum=4, **kw)
    assert q["quiesced"] and q["pending"] > 0
    if "inject_rows" in kw:
        # Cut at round 0: the ring row is residue, with its cursor.
        assert q["state"]["ictl"][:, 0].tolist() == [1, 0]
        assert q["inject_ctl"][:, :3].tolist() == [[1, 1, 0], [0, 1, 0]]
    rkw = {"tenant_table": table()} if tenants else {}
    iv, _, info = rk.run(resume_state=q["state"], quantum=4, **rkw)
    sizes = [7, 3] if "inject_rows" in kw else [7]
    assert info["pending"] == 0 and info["executed"] == expected(sizes)[0]
    assert int(iv[:, :len(sizes)].sum()) == expected(sizes)[1]


@pytest.mark.parametrize("option", ["trace", "checkpoint"])
def test_mesh_refuses_observed_builds(option):
    """A traced or checkpoint-built table runs on the resident kernel and
    the ring (the recorder on both; the ring reads no quiesce word, as
    JAX's never reads mk.checkpoint); the sharded runner still refuses
    it, as JAX's does."""
    mk = tw.make_fib_megakernel(256, device="cpu", **{option: True})
    sizes = [6, 5]
    for rk in (ResidentKernel(mk, cpu_mesh(2), migratable_fns=[FIB],
                              homed=False),
               TIci(mk, cpu_mesh(3), migratable_fns=[FIB])):
        iv, _, info = rk.run(forest(TBuilder, rk.ndev, sizes), quantum=8)
        assert info["executed"] == expected(sizes)[0]
        assert int(iv[:, :2].sum()) == expected(sizes)[1]
        if option == "trace":
            assert len(info["trace"]["rings"]) == rk.ndev
        assert info.get("quiesced", False) is False
    with pytest.raises(ValueError, match=option.replace("trace",
                                                        "trace ring")):
        TSharded(mk, cpu_mesh(2))


def test_sharded_builds_untraced_under_env(monkeypatch):
    """HCLIB_TPU_TRACE from the environment: the sharded runner runs
    untraced (its own launches) and the Megakernel keeps its ring."""
    monkeypatch.setenv("HCLIB_TPU_TRACE", "1")
    mk = tw.make_fib_megakernel(256, device="cpu")
    assert mk.trace is not None and mk.trace_from_env
    iv, _, info = TSharded(mk, cpu_mesh(2), migratable_fns=[FIB]).run(
        forest(TBuilder, 2, [6, 5]), steal=True, quantum=8)
    assert info["executed"] == expected([6, 5])[0]
    assert mk.trace is not None


def test_mesh_shape_and_argument_errors():
    with pytest.raises(ValueError, match="power-of-two"):
        ResidentKernel(_fib_mk(), cpu_mesh(3), homed=False)
    with pytest.raises(ValueError, match="power-of-two device counts"):
        TIci(_fib_mk(), CtaMesh((3, 2), ("a", "b"), device="cpu"))
    with pytest.raises(ValueError, match="permutation"):
        ResidentKernel(_fib_mk(), cpu_mesh(4), migratable_fns=[FIB],
                       homed=False).run(forest(TBuilder, 4, [3]),
                                        hop_order=[1, 1])
    with pytest.raises(ValueError, match="1D mesh"):
        TSharded(_fib_mk(), CtaMesh((2, 2), ("a", "b"), device="cpu"))
    with pytest.raises(ValueError, match="hop_order"):
        TSharded(_fib_mk(), cpu_mesh(4), migratable_fns=[FIB]).run(
            forest(TBuilder, 4, [3]), steal=True, hop_order=[4])
    with pytest.raises(ValueError, match="outside the kernel table"):
        TSharded(_fib_mk(), cpu_mesh(2), migratable_fns=[5])
    with pytest.raises(ValueError, match="non-pof2 ring"):
        TIci(_fib_mk(), cpu_mesh(3), fault_plan=_PLAN)
    with pytest.raises(ValueError, match="1 to 3"):
        CtaMesh((2, 2, 2, 2), ("a", "b", "c", "d"), device="cpu")


def test_unified_load_runs_exact():
    """unified_load (homed migration and remote fetch-adds) at 4 devices:
    its totals are held inside; the tree spread and no proxy is left."""
    info = tstress.unified_load(ndev=4, n=7, fadds=8, capacity=128,
                                device="cpu")
    assert info["tasks"] == expected([7])[0] + 8
    assert info["devices_used"] >= 2 and info["proxies"] == [0] * 4


def test_mesh_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from hclib_tpu_torch.parallel.mesh import cuda_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cuda_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstress.forest_steal(**tstress.FOREST_STEAL_QUICK)
    assert tmk.MESH_KINDS == ("mesh_round", "ici_ring", "resident_steal")
