"""The resident kernel's injection ring and mesh tenancy in the port
(hclib_tpu_torch/device/resident.py ``inject=`` / ``tenants=``, and
device/tenants.py ``MeshTenantTable``) held to the JAX package.

The host halves word for word on the same fake clock and submission
sequence: the mesh table's routing, rings and tctl after ``pump``,
``stats()``, ``pressure()``, ``export_state`` and ``reshard`` with its
guards (tests/test_tenants.py's mesh tests), the egress ledger's
preempt and reattach across a cut (tests/test_serving.py's),
``pack_inject_rows``, the ``HCLIB_TPU_MESH_TENANTS`` spelling and the
construction checks. Two runs of JAX's Mosaic-interpreted resident
kernel (module fixtures at the smallest shapes, 25-50 s each on one
core): 2 devices steal-only with ``inject_rows``, and 2 devices with
four tenant lanes through a MeshTenantTable (the last lane's rows
expire on the ring, and a 4-row table makes the lane scan stop at
the headroom); each compared with the port's plain run word for word:
value slots, counts rows, rounds, fault stats, and the tctl echo and
the table's stats. JAX's three resident compositions that inject (its
composition test and the five-way and volume tests it runs only on a
TPU) and the phase-29 loads at small sizes run on the port alone, held
to JAX's assertions.
"""


import numpy as np
import pytest

from hclib_tpu.device import tenants as jten
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.megakernel import Megakernel as JMegakernel
from hclib_tpu.device.resident import ResidentKernel as JResident
from hclib_tpu.device.resident import pack_inject_rows as jpack
from hclib_tpu.parallel.mesh import cpu_mesh as jax_mesh
from hclib_tpu_torch.device import stress
from hclib_tpu_torch.device import tenants as tten
from hclib_tpu_torch.device.descriptor import (
    F_A0,
    F_FN,
    F_OUT,
    RING_ROW,
    TEN_ID,
    TEN_TOKEN,
)
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.device.megakernel import Megakernel
from hclib_tpu_torch.device.resident import ResidentKernel, pack_inject_rows
from hclib_tpu_torch.parallel.mesh import cpu_mesh

BUMP = 0


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


def _bump(ctx):
    ctx.set_value(0, ctx.value(0) + ctx.arg(0))


def _jbump_mk(capacity=128):
    return JMegakernel(kernels=[("bump", _bump)], capacity=capacity,
                       num_values=4, succ_capacity=8, interpret=True)


def _tbump_mk(capacity=128):
    return Megakernel([("bump", _bump)], capacity=capacity, num_values=4,
                      succ_capacity=8, device="cpu")


# ---------------------------------------------------- the mesh table


def _boom(row):
    raise RuntimeError("poison")


def _routing(ten):
    """tests/test_tenants.py test_mesh_table_routing_quota_and_isolation
    on package ``ten``: everything it observes."""
    clock = FakeClock()
    mt = ten.MeshTenantTable(
        [ten.TenantSpec("a", weight=2, queue_capacity=64),
         ten.TenantSpec("rated", rate=1.0, burst=2.0, queue_capacity=64),
         ten.TenantSpec("poi", validator=_boom, poison_throttle=1,
                        poison_quarantine=2, queue_capacity=64),
         ten.TenantSpec("dl", deadline_s=1.0, deadline_budget=3,
                        queue_capacity=64)],
        ndev=2, region_rows=16, clock=clock)
    rings = np.zeros((2, 4 * 16, RING_ROW), np.int32)
    seen = []
    for i in range(4):
        seen.append(mt.submit("a", BUMP, args=[i]))
    seen.append(mt.submit("a", BUMP, args=[9], device=1))
    for i in range(3):
        seen.append(mt.submit("rated", BUMP, args=[i]))
    seen.append(mt.submit("poi", BUMP, args=[1], device=0))
    seen.append(mt.submit("poi", BUMP, args=[2], device=1))
    for i in range(4):
        seen.append(mt.submit("dl", BUMP, args=[i]))
    tctls = [mt.pump(rings)]
    clock.advance(2.0)  # dl's published rows lapse on the ring
    tctls.append(mt.pump(rings))
    for r in range(4):
        for d in range(2):
            ten.wrr_poll_reference(rings[d], tctls[-1][d], 16, r, 1 << 20)
    mt.absorb(tctls[-1])
    tctls.append(mt.pump(rings))
    for d in range(2):
        seen.append(mt.submit("poi", BUMP, args=[0], device=d))
    verdicts = [(a.status, a.reason, a.device) for a in seen]
    return (verdicts, rings, np.stack(tctls), mt.stats(), mt.pressure(),
            mt.per_device_stats())


def test_mesh_table_routing_quota_isolation_and_pressure():
    j, t = _routing(jten), _routing(tten)
    assert j[0] == t[0]
    np.testing.assert_array_equal(j[1], t[1])
    np.testing.assert_array_equal(j[2], t[2])
    assert j[3] == t[3] and j[4] == t[4] and j[5] == t[5]
    verdicts, _, _, stats, pressure, _ = t
    assert [v[2] for v in verdicts[:5]] == [0, 1, 0, 1, 1]
    assert verdicts[7][:2] == ("REJECTED", "rate")
    assert verdicts[-1][:2] == verdicts[-2][:2] == ("REJECTED", "quarantined")
    assert stats["poi"]["quarantined"] == 1 and stats["poi"]["poisoned"] == 2
    assert stats["dl"]["expired"] == 4 and pressure["dl"]["pressure"] == 1.0
    assert stats["dl"]["quarantined"] == 0 and verdicts[-3][:2] == (
        "ACCEPTED", None)
    for tid, s in stats.items():
        assert s["accepted"] == (s["completed"] + s["expired"] + s["dropped"]
                                 + s["backlog"]), (tid, s)
    with pytest.raises(KeyError):
        tten.MeshTenantTable([tten.TenantSpec("a")], 2, 16).submit(
            "a", BUMP, device=7)
    with pytest.raises(KeyError):
        tten.MeshTenantTable([tten.TenantSpec("a")], 2, 16).submit(
            "nobody", BUMP)
    with pytest.raises(ValueError, match="placement"):
        tten.MeshTenantTable([tten.TenantSpec("a")], 2, 16,
                             placement={"a": [5]})


def _reshard(ten):
    """test_mesh_export_reshard_resume_conserves_and_guards on package
    ``ten``: the export mid-flight, the 4 -> 2 reshard, the drain on the
    successor and the guards' messages."""
    clock = FakeClock()

    def specs():
        return [ten.TenantSpec("x", weight=2, queue_capacity=64),
                ten.TenantSpec("y", queue_capacity=64),
                ten.TenantSpec("z", queue_capacity=64)]

    mt = ten.MeshTenantTable(specs(), 4, 16, clock=clock,
                             placement={"z": [1, 3]})
    rings = np.zeros((4, 3 * 16, RING_ROW), np.int32)
    sub = {"x": 11, "y": 7, "z": 5}
    for tid, n in sub.items():
        for i in range(n):
            assert mt.submit(tid, BUMP, args=[i])
    tctl = mt.pump(rings)
    for d in range(4):
        ten.wrr_poll_reference(rings[d], tctl[d], 16, 0, 1 << 20)
    mt.absorb(tctl)
    mt2, state = mt.reshard(rings, 2)
    late = mt.submit("x", BUMP, args=[0])
    rings2 = np.zeros((2, 3 * 16, RING_ROW), np.int32)
    tctls = []
    for r in range(64):
        tctl = mt2.pump(rings2)
        for d in range(2):
            ten.wrr_poll_reference(rings2[d], tctl[d], 16, r, 1 << 20)
        mt2.absorb(tctl)
        tctls.append(tctl)
        if mt2.drained():
            break
    errors = []
    for bad in (
        lambda: ten.MeshTenantTable(
            [ten.TenantSpec("y"), ten.TenantSpec("x"), ten.TenantSpec("z")],
            2, 16, clock=clock).resume_from(state),
        lambda: ten.MeshTenantTable(specs(), 2, 16, clock=clock).resume_from(
            {"ring_rows": state["ring_rows"], "ictl": state["ictl"]}),
        lambda: ten.MeshTenantTable([ten.TenantSpec("only")], 2, 16,
                                    clock=clock).resume_from(state),
    ):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    arrays = {k: v for k, v in state.items() if k != "tenant_ids"}
    return (arrays, list(state["tenant_ids"]), (late.status, late.reason),
            np.stack(tctls), mt2.stats(), mt2.placement, errors,
            ten.per_tenant_ring_counts(state["ring_rows"], state["ictl"]))


def test_mesh_export_reshard_resume_and_guards():
    j, t = _reshard(jten), _reshard(tten)
    assert sorted(j[0]) == sorted(t[0])
    for k in j[0]:
        np.testing.assert_array_equal(j[0][k], t[0][k])
    assert j[1:3] == t[1:3]
    np.testing.assert_array_equal(j[3], t[3])
    assert j[4:] == t[4:]
    _, _, late, _, stats, placement, errors, residue = t
    assert late == ("REJECTED", "closed")
    assert placement == {"z": [1]}
    assert all(stats[k]["completed"] == n
               for k, n in {"x": 11, "y": 7, "z": 5}.items())
    assert [("roster" in errors[0]), ("tctl" in errors[1]),
            ("lanes" in errors[2])] == [True] * 3
    assert sum(residue.values()) > 0


def _egress_cut(ten, eg):
    """tests/test_serving.py's mesh egress cut on package ``ten`` (egress
    module ``eg``): futures from a mesh-wide ledger, the export preempts
    the in-flight ones, the resized successor shares the ledger and
    reattaches them, and the drain through host mailboxes closes the
    conservation identity."""
    clk = [100.0]
    spec = eg.EgressSpec(depth=4)
    table = ten.MeshTenantTable(
        [ten.TenantSpec("gold", weight=2), ten.TenantSpec("std")], 2, 16,
        clock=lambda: clk[0], egress=spec)
    rings = np.zeros((2, 2 * 16, RING_ROW), np.int32)
    live = []
    for i in range(8):
        adm = table.submit(i % 2, BUMP, args=[i], deadline_s=600.0)
        live.append(adm.future)
    state = table.export_state(rings)
    tokens = [f.resume_token for f in live if f.state == "PREEMPTED"]
    nxt = table.resized(2)
    assert nxt.futures is table.futures
    nxt.resume_from(state)
    states = [nxt.reattach(tok).state for tok in tokens]
    boxes = [eg.HostMailbox(spec) for _ in range(2)]
    for r in range(40):
        tctl = nxt.pump(rings)
        for d in range(2):
            rows = ten.wrr_poll_reference(rings[d], tctl[d], 16, r, 1 << 20)
            boxes[d].publish([(int(row[TEN_TOKEN]), 0, BUMP, 0, 7)
                              for row in rows])
        nxt.absorb(tctl)
        for box in boxes:
            box.drain(futures=table.futures)
        if nxt.drained():
            break
    arrays = {k: v for k, v in state.items() if k != "tenant_ids"}
    return (arrays, len(tokens), states, rings, nxt.stats(),
            table.futures.conservation())


def test_mesh_egress_preempt_and_reattach():
    from hclib_tpu.device import egress as jeg
    from hclib_tpu_torch.device import egress as teg

    j, t = _egress_cut(jten, jeg), _egress_cut(tten, teg)
    for k in j[0]:
        np.testing.assert_array_equal(j[0][k], t[0][k])
    assert j[1:3] == t[1:3]
    np.testing.assert_array_equal(j[3], t[3])
    assert j[4:] == t[4:]
    _, ntok, states, _, _, cons = t
    assert ntok > 0 and states == ["PENDING"] * ntok
    assert cons["ok"] and cons["pending"] == 0
    assert cons["reattached"] == ntok and cons["resolved"] == 8


@pytest.mark.parametrize("env, err", [
    ({}, None),
    ({"HCLIB_TPU_MESH_TENANTS": "3"}, None),
    ({"HCLIB_TPU_MESH_TENANTS": "3", "HCLIB_TPU_TENANT_WEIGHTS": "4,2,1",
      "HCLIB_TPU_TENANT_INFLIGHT": "5", "HCLIB_TPU_TENANT_DEADLINE_S": "2"},
     None),
    ({"HCLIB_TPU_MESH_TENANTS": "3", "HCLIB_TPU_TENANT_WEIGHTS": "4,2"},
     "lanes"),
    ({"HCLIB_TPU_MESH_TENANTS": "nope"}, "MESH_TENANTS"),
    ({"HCLIB_TPU_MESH_TENANTS": "-2"}, ">= 1"),
    ({"HCLIB_TPU_MESH_TENANTS": "2", "HCLIB_TPU_TENANT_BURST": "3"},
     "needs HCLIB_TPU_TENANT_RATE"),
])
def test_mesh_tenants_env_and_normalize(monkeypatch, env, err):
    from hclib_tpu_torch.runtime import env as tenv

    for k in tenv.REGISTRY:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if err is not None:
        for ten in (jten, tten):
            with pytest.raises(ValueError, match=err):
                ten.mesh_tenants_from_env()
        return

    def shape(specs):
        return None if specs is None else [
            (s.id, s.weight, s.max_in_flight, s.deadline_s) for s in specs]

    for arg in (None, False, 2, ["gold", {"id": "std", "weight": 3}]):
        assert shape(jten.normalize_mesh_tenants(arg)) == shape(
            tten.normalize_mesh_tenants(arg))
    assert shape(jten.mesh_tenants_from_env()) == shape(
        tten.mesh_tenants_from_env())


# ------------------------------------------------ ring packing, construction


def test_pack_inject_rows_matches_jax():
    """tests/test_tenants.py test_resident_inject_rows_accept_tenant_tags:
    tuples with and without out slot and tenant lane, and a prebuilt
    tagged row, land word for word as JAX's packer lays them out."""
    tagged = tten.build_row(BUMP, [5])
    tagged[TEN_ID] = 2
    specs = [(BUMP, (1,), 3, 1), tagged, (BUMP, [7, 8]), (2, [], 9)]
    ring, n = pack_inject_rows(specs, R=8)
    jring, jn = jpack(specs, R=8)
    assert n == jn == 4
    np.testing.assert_array_equal(ring, jring)
    assert ring[0, F_FN] == BUMP and ring[0, F_A0] == 1
    assert ring[0, F_OUT] == 3 and ring[0, TEN_ID] == 1
    assert (ring[1] == tagged).all()
    ic = np.zeros((1, 8), np.int32)
    ic[0, 0] = n
    assert tten.per_tenant_ring_counts(ring[None], ic) == {1: 1, 2: 1, 0: 2}
    with pytest.raises(ValueError, match="overflow"):
        pack_inject_rows([(BUMP, ())] * 5, R=4)


@pytest.mark.parametrize("ring_capacity, tenants", [
    (96, None), (96, ["x", "y", "z"]), (100, 3), (8, ["a", "b", "c", "d"]),
])
def test_resident_tenancy_construction_matches_jax(ring_capacity, tenants):
    """test_resident_mesh_tenancy_construction_and_off_path's shapes on a
    Megakernel that is not checkpoint-built: the lane count, the region
    rows (a multiple of 8) and the ring as their concatenation, as JAX
    computes them."""
    kw = dict(inject=True, tenants=tenants, ring_capacity=ring_capacity)
    j = JResident(_jbump_mk(), jax_mesh(2, axis_name="q"), **kw)
    t = ResidentKernel(_tbump_mk(), cpu_mesh(2), **kw)
    for k in ("T", "region_rows", "ring_capacity"):
        assert getattr(j, k) == getattr(t, k), k
    assert (t.tenant_specs is None) == (tenants is None)
    if t.T:
        assert t.ring_capacity == t.T * t.region_rows
        assert t.region_rows % 8 == 0


def test_resident_tenancy_refusals():
    """The construction and run() checks of JAX's tenancy tests: tenants=
    needs inject=True; a tenant mesh admits rows only through its table,
    of its exact shape; a tenancy-off mesh refuses a table; inject_rows
    needs inject=True. Quiesce needs a checkpoint build (JAX's message);
    a checkpoint-built tenant or tenancy-off mesh quiesces and resumes,
    and resume_state= takes no builders, as in JAX."""
    with pytest.raises(ValueError, match="inject=True"):
        ResidentKernel(_tbump_mk(), cpu_mesh(2), tenants=2)
    rk = ResidentKernel(_tbump_mk(), cpu_mesh(2), inject=True,
                        tenants=["x", "y", "z"], ring_capacity=96)
    rk_off = ResidentKernel(_tbump_mk(), cpu_mesh(2), inject=True)
    assert rk_off.T == 0 and rk_off.region_rows == 0
    bs = [TBuilder() for _ in range(2)]
    with pytest.raises(ValueError, match="MeshTenantTable"):
        rk.run(bs, inject_rows=[[(BUMP, (1,))]])
    with pytest.raises(ValueError, match="mismatch"):
        rk.run(bs, tenant_table=tten.MeshTenantTable(
            [tten.TenantSpec("x")], 2, 16))
    with pytest.raises(ValueError, match="tenant-enabled"):
        rk_off.run(bs, tenant_table=tten.MeshTenantTable(
            [tten.TenantSpec("x")], 2, 16))
    with pytest.raises(ValueError, match="requires inject=True"):
        ResidentKernel(_tbump_mk(), cpu_mesh(2)).run(
            bs, inject_rows=[[(BUMP, (1,))]])
    with pytest.raises(ValueError, match="overflow"):
        rk_off.run(bs, inject_rows=[[(BUMP, (1,))] * 300])
    for kw, match in ((dict(quiesce=True), "checkpoint=True"),
                      (dict(resume_state={"tasks": None}), "exactly one")):
        for r in (rk, rk_off):
            with pytest.raises(ValueError, match=match):
                r.run(bs, **kw)
    # Checkpoint-built: a cut at round 0 holds every published row as
    # residue (the tenant mesh's, tagged, in the table's export), and the
    # resume installs and runs them.
    mk = Megakernel([("bump", _bump)], capacity=128, num_values=4,
                    succ_capacity=8, checkpoint=True, device="cpu")
    rk_t = ResidentKernel(mk, cpu_mesh(2), inject=True, tenants=["x", "y"],
                          ring_capacity=32)
    rk_o = ResidentKernel(mk, cpu_mesh(2), inject=True, ring_capacity=32)
    table = tten.MeshTenantTable(rk_t.tenant_specs, 2, rk_t.region_rows)
    for i in range(6):
        table.submit(("x", "y")[i % 2], BUMP, args=[i + 1])
    for r, kw in ((rk_t, dict(tenant_table=table)),
                  (rk_o, dict(inject_rows=[[(BUMP, (1,))] * 3,
                                           [(BUMP, (2,))] * 3]))):
        _, _, q = r.run([TBuilder() for _ in range(2)], quiesce=True, **kw)
        assert q["quiesced"] and q["executed"] == 0
        assert int(q["state"]["ictl"][:, 0].sum()) == 6
        rkw = ({"tenant_table": tten.MeshTenantTable(
            rk_t.tenant_specs, 2, rk_t.region_rows)} if r is rk_t else {})
        iv, _, info = r.run(resume_state=q["state"], **rkw)
        assert info["pending"] == 0 and info["executed"] == 6
        assert int(iv[:, 0].sum()) in (21, 9)


def test_mesh_tenants_env_enables_the_resident_lanes(monkeypatch):
    """tenants=None reads HCLIB_TPU_MESH_TENANTS (the variable is honoured,
    not ignored): an injecting mesh gets its lanes, and a mesh without
    injection refuses, as JAX's does."""
    monkeypatch.setenv("HCLIB_TPU_MESH_TENANTS", "2")
    monkeypatch.setenv("HCLIB_TPU_TENANT_WEIGHTS", "3,1")
    rk = ResidentKernel(_tbump_mk(), cpu_mesh(2), inject=True)
    assert rk.T == 2 and [s.weight for s in rk.tenant_specs] == [3, 1]
    for RK, mk, mesh in ((ResidentKernel, _tbump_mk(), cpu_mesh(2)),
                         (JResident, _jbump_mk(),
                          jax_mesh(2, axis_name="q"))):
        with pytest.raises(ValueError, match="inject=True"):
            RK(mk, mesh)


# ------------------------------------------------- the Mosaic fixtures


def _inject_run(MK, RK, B, mesh):
    """Two devices steal-only (homed=False, BUMP migratable): six BUMPs on
    device 0, five injected on device 0's ring and one on device 1's, a
    16-row table, quantum 8 (the injected rows are what device 0 still
    holds after its first quantum, and some of them are stolen)."""
    rk = RK(MK(16), mesh, migratable_fns=[BUMP], homed=False, window=4,
            inject=True, ring_capacity=16)
    bs = [B() for _ in range(2)]
    for i in range(6):
        bs[0].add(BUMP, args=[i + 1])
    rows = [[(BUMP, [100 + j]) for j in range(5)], [(BUMP, [200])]]
    iv, _, info = rk.run(bs, inject_rows=rows, quantum=8)
    return np.asarray(iv), info


# (tenant, weight, admissions): the last lane's rows are published by an
# earlier pump and expire on the ring before the run.
LANES = (("gold", 2, 7), ("std", 1, 4), ("bg", 1, 3), ("late", 1, 3))


def _tenant_run(MK, RK, B, ten, mesh):
    """Two devices steal-only with the four LANES through a
    MeshTenantTable (fake clock), a 4-row table so the lane scan stops
    at the headroom (it reaches 0), quantum 4; one BUMP 0 seeds each
    device."""
    rk = RK(MK(4), mesh, migratable_fns=[BUMP], homed=False, window=4,
            inject=True, ring_capacity=32,
            tenants=[ten.TenantSpec(t, weight=w) for t, w, _ in LANES])
    clock = FakeClock()
    table = ten.MeshTenantTable(rk.tenant_specs, 2, rk.region_rows,
                                clock=clock)
    for _ in range(LANES[-1][2]):
        assert table.submit("late", BUMP, args=[1000], deadline_s=1.0)
    table.pump(np.zeros((2, rk.ring_capacity, RING_ROW), np.int32))
    clock.advance(2.0)
    for i, (tid, _, n) in enumerate(LANES[:-1]):
        for _ in range(n):
            assert table.submit(tid, BUMP, args=[i + 1])
    bs = [B() for _ in range(2)]
    for b in bs:
        b.add(BUMP, args=[0])
    iv, _, info = rk.run(bs, quantum=4, tenant_table=table)
    return np.asarray(iv), info


@pytest.fixture(scope="module")
def mosaic_inject():
    return (_inject_run(_jbump_mk, JResident, JBuilder,
                        jax_mesh(2, axis_name="q")),
            _inject_run(_tbump_mk, ResidentKernel, TBuilder, cpu_mesh(2)))


@pytest.fixture(scope="module")
def mosaic_tenants():
    return (_tenant_run(_jbump_mk, JResident, JBuilder, jten,
                        jax_mesh(2, axis_name="q")),
            _tenant_run(_tbump_mk, ResidentKernel, TBuilder, tten,
                        cpu_mesh(2)))


def _assert_same(jout, tout):
    (jiv, ji), (tiv, ti) = jout, tout
    np.testing.assert_array_equal(jiv, tiv)
    np.testing.assert_array_equal(np.asarray(ji["per_device_counts"]),
                                  ti["per_device_counts"])
    assert ji["rounds"] == ti["rounds"]
    assert ji["fault_stats"] == ti["fault_stats"]


def test_inject_rows_match_mosaic(mosaic_inject):
    _assert_same(*mosaic_inject)
    iv, info = mosaic_inject[1]
    assert int(iv[:, 0].sum()) == 21 + 5 * 100 + 10 + 200
    assert info["executed"] == 12 and info["pending"] == 0


def test_tenant_lanes_match_mosaic(mosaic_tenants):
    _assert_same(*mosaic_tenants)
    (_, ji), (iv, ti) = mosaic_tenants
    np.testing.assert_array_equal(np.asarray(ji["tenant_ctl"]),
                                  ti["tenant_ctl"])
    assert ji["tenants"] == ti["tenants"]
    ten = ti["tenants"]
    assert int(iv[:, 0].sum()) == sum(n * (i + 1)
                                      for i, (_, _, n) in enumerate(LANES[:3]))
    assert ten["late"]["expired"] == 3 and ten["late"]["completed"] == 0
    assert sum(f["tenant_expired"] for f in ti["fault_stats"]) == 3
    for tid, s in ten.items():
        assert s["accepted"] == (s["completed"] + s["expired"] + s["dropped"]
                                 + s["backlog"]), (tid, s)


# ------------------------------------------------ the port alone, at JAX's


@pytest.mark.parametrize("name", ["compose_4", "five_way_1", "volume_1"])
def test_jax_compositions_that_inject(name):
    """tests/test_resident.py :238 (steal + put/wait + injection on 4
    devices) and the two TPU-only tests :420 (the five-way composition)
    and :472 (the volume stress: fib(14), 64 fetch-adds, 8 contending
    lockers, 4 puts, a 64-row stream), on the port's plain path; the
    stress functions raise unless every JAX assertion holds."""
    run = {"compose_4": stress.compose_inject, "five_way_1": stress.five_way,
           "volume_1": stress.volume}[name]
    iv, data, info = run(device="cpu")
    assert info["pending"] == 0 and info["fault_stats"][0][
        "tenant_expired"] == 0
    assert info["proxies"] == [0] * len(info["proxies"])


def test_phase29_loads_small():
    """chip_smoke.py's inject_128 and tenants_128 at 8 and 4 devices:
    exact forest and injected totals, every admission installed once,
    the late lane dropped on the ring, per-tenant conservation."""
    iv, info = stress.inject_forest(ndev=8, roots=24, n=9, per_dev=16,
                                    n_inj=4, capacity=1024, device="cpu")
    assert info["executed"] == 24 * 163 + 8 * 16 * 13
    assert int((np.asarray(info["per_device_counts"])[:, 5] > 0).sum()) == 8
    lanes = (("gold", 4, 96), ("std", 2, 64), ("bg", 1, 32), ("late", 1, 16))
    iv, info = stress.tenant_mesh(4, lanes, capacity=16, device="cpu")
    assert info["tenants"]["late"]["expired"] == 16
    tc = info["tenant_ctl"]
    assert tc.shape == (4, 4, 8)
    assert (tc[:, :, tten.TC_CONSUMED] == tc[:, :, tten.TC_TAIL]).all()
