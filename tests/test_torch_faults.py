"""The resident kernel's fault plans (hclib_tpu_torch/device/resident.py
under a DeviceFaultPlan: dropped, duplicated and delayed steal credits
with regeneration, a dead device with heartbeat detection, quarantine
and re-homing) held to the JAX package.

Two runs of JAX's Mosaic-interpreted resident kernel (module fixtures; a
Mosaic round costs seconds here, so each is sized to the fewest rounds
that show its faults, ``stress.FAULT_CREDITS`` and ``FAULT_DEAD``): 13
BUMPs on device 0 of 2 with a credit dropped at (1, 0, 1), one doubled
at (0, 0, 1) and delay_xfer_rate 0.25 (5 rounds: the pair is down for
rounds 2 and 3 and device 0 regenerates the credit at round 4), and 6
BUMPs on device 1 of 4, which dies at round 1 (3 rounds: it re-homes a
row and every survivor quarantines it at round 2). Each is compared word
for word with the port's plain run: value slots, per_device_counts,
rounds, executed and every device's fault_stats. The plan's checks, the
refusals, both StallErrors, determinism and JAX's larger shapes run on
the port alone, held to JAX's assertions.
"""

import numpy as np
import pytest

from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.megakernel import Megakernel as JMegakernel
from hclib_tpu.device.resident import ResidentKernel as JResident
from hclib_tpu.parallel.mesh import cpu_mesh as jax_mesh
from hclib_tpu.runtime.resilience import DeviceFaultPlan as JPlan
from hclib_tpu_torch import DeviceFaultPlan, StallError
from hclib_tpu_torch.device import stress
from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
from hclib_tpu_torch.device.resident import (
    FP_MAX_AT,
    ResidentKernel,
    fault_plan_words,
)
from hclib_tpu_torch.parallel.mesh import cpu_mesh
from hclib_tpu_torch.runtime import env as tenv

pytestmark = pytest.mark.chaos

BUMP = 0


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


def _jax_bump(ctx):
    ctx.set_value(0, ctx.value(0) + ctx.arg(0))


def _jax_run(cfg):
    """JAX's ``_mesh_rk`` run of fixture ``cfg`` in Mosaic interpret
    mode."""
    mk = JMegakernel(kernels=[("bump", _jax_bump)], capacity=cfg["capacity"],
                     num_values=1024, succ_capacity=8, interpret=True)
    rk = JResident(mk, jax_mesh(cfg["ndev"], axis_name="q"),
                   migratable_fns=[BUMP], window=4,
                   fault_plan=JPlan(**cfg["plan"]))
    bs = [JBuilder() for _ in range(cfg["ndev"])]
    for i in range(cfg["ntasks"]):
        bs[cfg["dev"]].add(BUMP, args=[i + 1])
    return rk.run(bs, quantum=2, max_rounds=4096)


def assert_same(jout, tout):
    jiv, _, ji = jout
    tiv, ti = tout
    np.testing.assert_array_equal(np.asarray(jiv), tiv)
    np.testing.assert_array_equal(np.asarray(ji["per_device_counts"]),
                                  ti["per_device_counts"])
    assert ji["rounds"] == ti["rounds"]
    assert ji["executed"] == ti["executed"]
    assert ji["fault_stats"] == ti["fault_stats"]


@pytest.fixture(scope="module")
def mosaic_credits():
    return _jax_run(stress.FAULT_CREDITS), stress.fault_run("credits", "cpu")


@pytest.fixture(scope="module")
def mosaic_dead():
    return _jax_run(stress.FAULT_DEAD), stress.fault_run("dead", "cpu")


# ---------------------------------------------------- against Mosaic


def test_credit_faults_equal_jax(mosaic_credits):
    jout, tout = mosaic_credits
    assert_same(jout, tout)
    fs = tout[1]["fault_stats"]
    assert fs[1]["credits_dropped"] == 1       # the granter's side
    assert fs[0]["credits_regenerated"] == 1   # the starved writer's
    assert fs[1]["credits_duplicated"] == 1
    assert sum(f["xfers_delayed"] for f in fs) > 0
    assert tout[1]["rounds"] == 5 and all(f["heartbeat"] == 5 for f in fs)


def test_dead_device_equals_jax(mosaic_dead):
    jout, tout = mosaic_dead
    assert_same(jout, tout)
    dead = stress.FAULT_DEAD["plan"]["dead_device"]
    fs = tout[1]["fault_stats"]
    assert fs[dead]["rehomed_rows"] > 0
    assert all(dead in f["quarantined"] and f["dead_detected_round"] == 2
               for d, f in enumerate(fs) if d != dead)
    assert fs[dead]["heartbeat"] == 1 and fs[dead]["quarantined"] == []


# ---------------------------------------------------- the plan


def test_plan_validation_and_env_against_jax(monkeypatch):
    for k in tenv.REGISTRY:
        monkeypatch.delenv(k, raising=False)
    for bad in (dict(drop_credit_rate=1.5), dict(credit_timeout=-1),
                dict(delay_xfer_rate=-0.1)):
        for cls in (JPlan, DeviceFaultPlan):
            with pytest.raises(ValueError):
                cls(**bad)
    attrs = ("seed", "drop_millis", "dup_millis", "delay_millis",
             "drop_credit_at", "dup_credit_at", "dead_device", "dead_round",
             "credit_timeout", "heartbeat_timeout")
    kws = [dict(), dict(drop_credit_rate=0.25), dict(dead_device=2),
           dict(dup_credit_at=[(1, 0, 1)], delay_xfer_rate=0.0004),
           dict(seed=9, drop_credit_at=[(3, 1, 2)], credit_timeout=0,
                heartbeat_timeout=0)]
    for env in ({}, {"HCLIB_TPU_CREDIT_TIMEOUT": "7",
                     "HCLIB_TPU_HEARTBEAT_TIMEOUT": "9"},
                {"HCLIB_TPU_CREDIT_TIMEOUT": "soon"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for kw in kws:
            j, t = JPlan(**kw), DeviceFaultPlan(**kw)
            assert [getattr(j, a) for a in attrs] == [
                getattr(t, a) for a in attrs]
            for m in ("enabled", "drops_credits", "dups_credits"):
                assert getattr(j, m)() == getattr(t, m)()
    assert DeviceFaultPlan(drop_credit_rate=0.25).credit_timeout == 2
    assert {"HCLIB_TPU_CREDIT_TIMEOUT",
            "HCLIB_TPU_HEARTBEAT_TIMEOUT"} <= set(tenv.REGISTRY)


def test_plan_words_for_the_card():
    p = DeviceFaultPlan(seed=-5, drop_credit_rate=0.1,
                        drop_credit_at=[(1, 0, 1), (4, 2, 3)],
                        dup_credit_at=[(2, 1, 0)], dead_device=3,
                        dead_round=6, credit_timeout=0)
    w = fault_plan_words(p)
    assert w.dtype == np.int32 and w[0] == (-5) % (1 << 31)
    assert w[1:11].tolist() == [100, 0, 0, 3, 6, 0, 2, 2, 1, 1]
    assert w[16:22].tolist() == [1, 0, 1, 4, 2, 3]
    assert w[16 + 3 * FP_MAX_AT:19 + 3 * FP_MAX_AT].tolist() == [2, 1, 0]
    with pytest.raises(ValueError, match="exact entries"):
        fault_plan_words(DeviceFaultPlan(
            drop_credit_at=[(r, 0, 1) for r in range(FP_MAX_AT + 1)]))


# ---------------------------------------------------- refusals


def _rk(ndev=2, **kw):
    return ResidentKernel(stress.fault_megakernel(64, "cpu"), cpu_mesh(ndev),
                          **kw)


@pytest.mark.parametrize("case", ["steal_false", "too_many_devices",
                                  "dead_out_of_range", "inject", "tenants",
                                  "nonpof2"])
def test_refusals(case):
    plan = DeviceFaultPlan(drop_credit_rate=0.1)
    if case == "steal_false":
        with pytest.raises(ValueError, match="steal"):
            _rk(steal=False, fault_plan=plan)
    elif case == "too_many_devices":
        with pytest.raises(ValueError, match="31 devices"):
            _rk(32, migratable_fns=[BUMP], fault_plan=plan)
        _rk(16, migratable_fns=[BUMP], fault_plan=plan)
    elif case == "dead_out_of_range":
        for dead in (5, -1):
            with pytest.raises(ValueError, match="dead_device"):
                _rk(migratable_fns=[BUMP],
                    fault_plan=DeviceFaultPlan(dead_device=dead))
    elif case in ("inject", "tenants"):
        kw = dict(inject=True, tenants=2 if case == "tenants" else None)
        with pytest.raises(NotImplementedError, match="A11b.5"):
            _rk(migratable_fns=[BUMP], fault_plan=plan, **kw)
        assert _rk(migratable_fns=[BUMP], **kw).inject
    else:
        with pytest.raises(ValueError, match="power-of-two"):
            ICIStealMegakernel(stress.fault_megakernel(64, "cpu"),
                               cpu_mesh(3), migratable_fns=[BUMP],
                               fault_plan=plan)
    # A plan that injects nothing compiles nothing.
    assert _rk(migratable_fns=[BUMP],
               fault_plan=DeviceFaultPlan()).plan is None


# ---------------------------------------------------- the StallErrors


def test_no_regeneration_raises_naming_the_channel():
    """JAX's test_dropped_credit_without_regeneration_raises_stallerror:
    the mesh exits in lockstep at the fold after the drop."""
    plan = DeviceFaultPlan(seed=3, drop_credit_at=[(1, 0, 1)],
                           credit_timeout=0)
    with pytest.raises(StallError, match="hop-0 .*granter device 1") as e:
        stress.fault_resident(2, plan, 128, device="cpu").run(
            stress.skewed_builders(2, 40), quantum=2, max_rounds=4096)
    info = e.value.stats
    assert info["rounds"] == 3 and info["pending"] > 0
    assert info["fault_stats"][0]["starved_channel"] == {"hop": 0,
                                                         "granter": 1}


def test_dead_device_with_unmigratable_work_names_the_suspect():
    """The dead device holds work that may not move (BUMP is not
    migratable): survivors quarantine it and the run stalls naming it."""
    rk = ResidentKernel(
        stress.fault_megakernel(64, "cpu"), cpu_mesh(4), homed=False,
        migratable_fns=[], fault_plan=DeviceFaultPlan(
            dead_device=2, dead_round=1, heartbeat_timeout=2))
    with pytest.raises(StallError, match="suspect chip: device 2 ") as e:
        rk.run(stress.skewed_builders(4, 12, 2), quantum=2, max_rounds=32)
    fs = e.value.stats["fault_stats"]
    assert all(f["quarantined"] == [2] for d, f in enumerate(fs) if d != 2)


# ---------------------------------------------------- the port alone


def test_runs_are_deterministic():
    a = stress.fault_run("credits", "cpu")
    b = stress.fault_run("credits", "cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1]["per_device_counts"],
                                  b[1]["per_device_counts"])
    assert a[1]["fault_stats"] == b[1]["fault_stats"]
    assert a[1]["exchange"]["rows"] == b[1]["exchange"]["rows"]


@pytest.mark.parametrize("name", ["drop", "dup", "delay"])
def test_jax_credit_shapes(name):
    """JAX's 2-device credit tests at their shapes (40 BUMPs)."""
    plans = {"drop": dict(seed=3, drop_credit_at=[(1, 0, 1)]),
             "dup": dict(seed=5, dup_credit_at=[(1, 0, 1)]),
             "delay": dict(seed=11, delay_xfer_rate=0.5)}
    rk = stress.fault_resident(2, DeviceFaultPlan(credit_timeout=2,
                                                  **plans[name]), 128,
                               device="cpu")
    iv, _, info = rk.run(stress.skewed_builders(2, 40), quantum=2,
                         max_rounds=4096)
    stress.check_bump(iv, info, 40, 820)
    fs = info["fault_stats"]
    if name == "drop":
        assert fs[1]["credits_dropped"] == 1
        assert fs[0]["credits_regenerated"] == 1
    elif name == "dup":
        assert fs[1]["credits_duplicated"] == 1
    else:
        assert sum(f["xfers_delayed"] for f in fs) > 0
    iv2, _, info2 = rk.run(stress.skewed_builders(2, 40), quantum=2,
                           max_rounds=4096)
    assert info2["fault_stats"] == fs and (iv2 == iv).all()


def test_jax_dead_chip_shape():
    """JAX's test_dead_chip_rehomes_and_survivors_drain_workload: 8
    devices, 6 BUMPs each, device 3 dead at round 2."""
    dead = 3
    rk = stress.fault_resident(8, DeviceFaultPlan(
        seed=7, dead_device=dead, dead_round=2, heartbeat_timeout=2), 256,
        device="cpu")
    bs, total = stress.spread_builders(8, 6)
    iv, _, info = rk.run(bs, quantum=2, max_rounds=4096)
    stress.check_bump(iv, info, 48, total)
    fs = info["fault_stats"]
    assert fs[dead]["rehomed_rows"] > 0
    assert any(dead in f["quarantined"] for d, f in enumerate(fs)
               if d != dead)
    detect = [f["dead_detected_round"] for d, f in enumerate(fs)
              if d != dead and f["dead_detected_round"] >= 0]
    assert detect and min(detect) >= 2
    assert info["per_device_counts"][dead, 5] <= 2 * 2


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_soak_dead_chip_shape(seed):
    """tools/chaos_soak.py's dead-chip scenario with its totals: 8
    devices, 4 BUMPs each, device seed % 8 dead at round 2; at 2 tasks a
    round every queue is empty after round 1, so the run ends before the
    death. (Its dropped-credit scenario is JAX's drop test's shape,
    test_jax_credit_shapes[drop].)"""
    dead = seed % 8
    rk = stress.fault_resident(8, DeviceFaultPlan(
        seed=seed, dead_device=dead, dead_round=2, heartbeat_timeout=2),
        256, device="cpu")
    bs, total = stress.spread_builders(8, 4)
    iv, _, info = rk.run(bs, quantum=2, max_rounds=4096)
    stress.check_bump(iv, info, 32, total)
    assert info["rounds"] == 2
    assert all(f["heartbeat"] == 2 for f in info["fault_stats"])


def test_ici_steal_delegates_with_the_plan():
    """ICIStealMegakernel on a power-of-two mesh runs the resident
    kernel's steal-only configuration under the plan: the dry run's
    BUMPs, device 0 (which holds them all) dead from round 0."""
    plan = DeviceFaultPlan(seed=5, drop_credit_rate=0.05, dead_device=0,
                           dead_round=0)
    sk = ICIStealMegakernel(stress.bump_megakernel("cpu"), cpu_mesh(4),
                            migratable_fns=[BUMP], window=4, fault_plan=plan)
    assert sk._resident.plan is plan
    iv, _, info = sk.run(stress.dryrun_builders(2, 4), quantum=2)
    stress.check_bump(iv, info, 32, 32 * 33 // 2)
    fs = info["fault_stats"]
    assert info["per_device_counts"][0, 5] == 0
    assert fs[0]["rehomed_rows"] == 32 and fs[0]["heartbeat"] == 0
    assert all(f["quarantined"] == [0] for f in fs[1:])


def test_full_width_loads_small():
    """The phase-30 loads at small sizes: UTS depth 12 under UTS_FAULT
    plan on 16 devices (the dead device re-homes, every survivor
    quarantines it, every dropped credit regenerates) and the forest
    steal-only with its whole queue re-homed."""
    iv, info = stress.uts_fault(max_depth=12, device="cpu")
    assert int(iv[:, 0].sum()) == info["executed"] == 5332
    fs = info["fault_stats"]
    assert fs[0]["rehomed_rows"] > 0
    assert all(f["quarantined"] == [0] for f in fs[1:])
    iv, info = stress.forest_fault(ndev=8, roots=24, n=9, capacity=1024,
                                   device="cpu")
    fs = info["fault_stats"]
    # Every root, and any row a survivor sent it before the quarantine.
    assert fs[0]["rehomed_rows"] >= 24
    assert info["per_device_counts"][0, 5] == 0
    assert sum(f["credits_dropped"] for f in fs) == sum(
        f["credits_regenerated"] for f in fs)
