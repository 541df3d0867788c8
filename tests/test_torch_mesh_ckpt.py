"""The resident mesh's quiesce, resume and flight recorder in the port
(hclib_tpu_torch/device/resident.py ``quiesce=`` / ``resume_state=`` and
traced or checkpoint-built tables, device/ici_steal.py's traced ring,
runtime/checkpoint.py ``snapshot_resident``, ``restore_resident`` and
``CheckpointBundle.reshard``) held to the JAX package.

Three runs of JAX's Mosaic-interpreted resident kernel (module fixtures,
each sized to the fewest rounds that show its cut, 15-45 s on one core):

- (a) ``_mesh_uts_rk(2)`` of tests/test_checkpoint.py (UTS depth 6,
  capacity 256) traced (256 records) and checkpoint-built, quantum 8,
  quiesced at round 2: every array of the exported state, every device's
  decoded records, the fault stats, rounds, executed and pending word for
  word; the port resumes JAX's state, a bundle JAX saved restores in the
  port and the port's loads in JAX.
- (b) tests/test_checkpoint.py's pending-waits round trip (a chain of 21
  BUMPs hides the PUT, the CONSUME waits on it) quiesced at round 2: the
  state with the wait table's rebased needs, the heap; the port's resume
  fires the parked wait.
- (c) tests/test_checkpoint.py's injection residue (4 devices, 6 BUMP
  rows a ring) quiesced at round 0: the ring residue, its ictl and the
  inject_ctl echo.

Words JAX's Mosaic interpreter leaves unwritten (a spawned row's unused
words, the ready ring past its live entries) hold the interpreter's
fill, 2^31 - 1; the comparisons skip exactly those words. The rest runs
on the port alone, held to JAX's assertions (the traced mesh, the batch
tier's records and its cut, the same-mesh round trip at 4 devices, the
tenant mesh's cut, the injected residue resharded), and ``reshard`` is
held to JAX's on every bundle of JAX's reshard tests, refusals included.
"""

import numpy as np
import pytest

from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.megakernel import Megakernel as JMegakernel
from hclib_tpu.device.resident import ResidentKernel as JResident
from hclib_tpu.device.workloads import UTS_NODE as J_UTS
from hclib_tpu.device.workloads import make_fib_megakernel as j_fib_mk
from hclib_tpu.device.workloads import make_uts_megakernel as j_uts_mk
from hclib_tpu.parallel.mesh import cpu_mesh as jax_mesh
from hclib_tpu.runtime import checkpoint as jck
from hclib_tpu_torch.device import stress
from hclib_tpu_torch.device import tracebuf as tb
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import (
    DESC_WORDS,
    F_DEP,
    F_FN,
    F_HOME,
    F_OUT,
    F_SUCC0,
    NO_TASK,
    RING_ROW,
)
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
from hclib_tpu_torch.device.resident import ResidentKernel
from hclib_tpu_torch.device.tenants import MeshTenantTable
from hclib_tpu_torch.parallel.mesh import cpu_mesh
from hclib_tpu_torch.runtime import checkpoint as tck
from hclib_tpu_torch.runtime.resilience import DeviceFaultPlan

pytestmark = pytest.mark.chaos

FILL = np.iinfo(np.int32).max  # Mosaic interpret's unwritten words


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


def assert_state_equal(jstate, tstate):
    """Every array of two exported states, JAX's unwritten words
    skipped."""
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        if k == "data":
            assert set(v) == set(tstate[k])
            for n, a in v.items():
                np.testing.assert_array_equal(np.asarray(a), tstate[k][n])
            continue
        j, t = np.asarray(v), np.asarray(tstate[k])
        assert j.shape == t.shape, k
        m = j != FILL
        np.testing.assert_array_equal(j[m], t[m], err_msg=k)


def assert_rings_equal(jtrace, ttrace):
    assert len(jtrace["rings"]) == len(ttrace["rings"])
    for jr, tr in zip(jtrace["rings"], ttrace["rings"]):
        assert (jr["written"], jr["dropped"]) == (tr["written"],
                                                  tr["dropped"])
        np.testing.assert_array_equal(jr["records"], tr["records"])


def assert_run_equal(jout, tout):
    jiv, ji = jout[0], jout[-1]
    tiv, ti = tout[0], tout[-1]
    np.testing.assert_array_equal(np.asarray(jiv), tiv)
    for k in ("rounds", "executed", "pending", "fault_stats", "quiesced"):
        assert ji[k] == ti[k], k
    np.testing.assert_array_equal(np.asarray(ji["per_device_counts"]),
                                  ti["per_device_counts"])


# ---------------------------------------------------- (a) UTS, traced


def _jax_uts_rk(ndev, **kw):
    mk = j_uts_mk(max_depth=6, interpret=True, capacity=256, **kw)
    return JResident(mk, jax_mesh(ndev, axis_name="q"),
                     migratable_fns=[J_UTS], window=4, homed=False)


def _jax_uts_builders(ndev):
    bs = [JBuilder() for _ in range(ndev)]
    for d in range(ndev):
        bs[d].add(J_UTS, args=[d + 1, 0])
    return bs


def _port_uts(**kw):
    rk = stress.ckpt_uts_resident(2, device="cpu", **kw)
    return rk, rk.run(stress.ckpt_uts_builders(2), quantum=8,
                      max_rounds=4096, quiesce=2)


@pytest.fixture(scope="module")
def mosaic_uts():
    rk = _jax_uts_rk(2, checkpoint=True, trace=256)
    iv, _, info = rk.run(_jax_uts_builders(2), quantum=8, max_rounds=4096,
                         quiesce=2)
    return rk, (np.asarray(iv), info)


def test_quiesce_and_trace_equal_jax(mosaic_uts):
    _, jout = mosaic_uts
    _, (tiv, _, ti) = _port_uts(checkpoint=True, trace=256)
    assert_run_equal(jout, (tiv, ti))
    assert ti["quiesced"] and ti["pending"] == 16 and ti["executed"] == 32
    assert [f["quiesce_round"] for f in ti["fault_stats"]] == [2, 2]
    assert_state_equal(jout[1]["state"], ti["state"])
    assert_rings_equal(jout[1]["trace"], ti["trace"])
    # The cut's records: TR_QUIESCE at the fold of round 2, TR_CKPT last.
    for ring in ti["trace"]["rings"]:
        tags = ring["records"][:, 0].tolist()
        assert tags.count(tb.TR_QUIESCE) == 1 and tags[-1] == tb.TR_CKPT


def test_port_resumes_jax_state(mosaic_uts):
    _, (jiv, ji) = mosaic_uts
    rk = stress.ckpt_uts_resident(2, device="cpu")
    full_iv, _, full = rk.run(stress.ckpt_uts_builders(2), quantum=8,
                              max_rounds=4096)
    iv, _, info = rk.run(resume_state=ji["state"], quantum=8,
                         max_rounds=4096)
    assert info["pending"] == 0 and info["executed"] == full["executed"]
    assert int(iv[:, 0].sum()) == int(full_iv[:, 0].sum()) == 314


def test_jax_bundle_restores_in_port(mosaic_uts, tmp_path):
    jrk, (_, ji) = mosaic_uts
    path = str(tmp_path / "jax-mesh")
    jck.snapshot_resident(jrk, ji).save(path)
    b = tck.CheckpointBundle.load(path)
    assert b.kind == "resident" and b.meta["ndev"] == 2
    rk = stress.ckpt_uts_resident(2, trace=256, device="cpu")
    iv, _, info = tck.restore_resident(b, rk, quantum=8, max_rounds=4096)
    assert info["pending"] == 0 and info["executed"] == 314
    assert int(iv[:, 0].sum()) == 314


def test_port_bundle_loads_in_jax(mosaic_uts, tmp_path):
    jrk, (_, ji) = mosaic_uts
    rk, (_, _, ti) = _port_uts(checkpoint=True, trace=256)
    bundle = tck.snapshot_resident(rk, ti)
    path = str(tmp_path / "port-mesh")
    bundle.save(path)
    j = jck.CheckpointBundle.load(path)
    assert j.kind == "resident" and j.meta == bundle.meta
    assert set(j.arrays) == set(bundle.arrays)
    for k, v in bundle.arrays.items():
        np.testing.assert_array_equal(j.arrays[k], v)
    # The manifest JAX writes for the same cut: the same meta, kind
    # classes included (the built-in UTS node is link-free).
    jm = jck.snapshot_resident(jrk, ji).meta
    assert jm == bundle.meta
    assert bundle.meta["kind_classes"] == {"uts_node": "link-free"}


def test_reshard_of_the_cut_refuses_as_jax(mosaic_uts):
    """Under homed=False a spawned UTS row keeps its slot's F_HOME (0 in
    the port, the interpreter's fill in JAX): every spawned row at the cut
    reads as home-linked, and both packages refuse to re-home it, with
    the same diagnostic."""
    jrk, (_, ji) = mosaic_uts
    rk, (_, _, ti) = _port_uts(checkpoint=True, trace=256)
    with pytest.raises(jck.CheckpointError) as je:
        jck.snapshot_resident(jrk, ji).reshard(1)
    with pytest.raises(tck.CheckpointError) as te:
        tck.snapshot_resident(rk, ti).reshard(1)
    assert "migration home-link" in str(te.value)
    assert str(je.value) == str(te.value)


def test_kind_classes_equal_jax():
    """The manifest's build-time classes of the built-in kinds; a user
    kind is unknown to the port (no recording pass over its body)."""
    assert tck._kind_classes(tw.make_fib_megakernel(64, device="cpu")) == \
        jck._kind_classes(j_fib_mk(64, interpret=True))
    assert tck._kind_classes(stress.bump_megakernel("cpu")) == {
        "bump": "unknown"}


# ---------------------------------------------------- (b) pending waits


def _jax_bump(ctx):
    ctx.set_value(0, ctx.value(0) + ctx.arg(0))


def _jax_put(ctx):
    ctx.pgas.put(ctx.arg(0), 0, ctx.arg(1), ctx.arg(2))


def _jax_consume(ctx):
    ctx.set_value(ctx.arg(0), ctx.pgas.count(0))


@pytest.fixture(scope="module")
def mosaic_waits():
    import jax

    mk = JMegakernel(
        kernels=[("bump", _jax_bump), ("put", _jax_put),
                 ("consume", _jax_consume)],
        data_specs={"heap": jax.ShapeDtypeStruct(
            (stress.WAITS_ROWS, stress.WAITS_COLS), np.int32)},
        capacity=128, num_values=64, succ_capacity=64, interpret=True,
        checkpoint=True)
    rk = JResident(mk, jax_mesh(2, axis_name="q"),
                   channels={"c0": ("heap", 1)}, window=4)
    _, waits, heap = stress.ckpt_waits_load()
    bs = [JBuilder(), JBuilder()]
    prev = bs[0].add(0, args=[1])
    for i in range(20):
        prev = bs[0].add(0, args=[i + 2], deps=[prev])
    bs[0].add(1, args=[1, 3, 2], deps=[prev])
    bs[1].add(2, args=[1])
    iv, data, info = rk.run(bs, data={"heap": heap}, waits=waits,
                            quantum=2, max_rounds=4096, quiesce=2)
    return (np.asarray(iv), {k: np.asarray(v) for k, v in data.items()},
            info, rk)


def test_pending_waits_equal_jax(mosaic_waits):
    jiv, jdata, ji, _ = mosaic_waits
    rk = stress.ckpt_waits_resident(device="cpu")
    bs, waits, heap = stress.ckpt_waits_load()
    iv, data, info = rk.run(bs, data={"heap": heap}, waits=waits, quantum=2,
                            max_rounds=4096, quiesce=2)
    assert_run_equal((jiv, ji), (iv, info))
    np.testing.assert_array_equal(jdata["heap"], data["heap"].numpy())
    assert_state_equal(ji["state"], info["state"])
    w = info["state"]["waits"]
    assert int(w[1, 0, 0]) == 1 and int(w[1, 1, 1]) >= 1  # still parked
    assert not w[1, 2:].any() and not w[0].any()  # zeros past the count


def test_resume_fires_the_parked_wait(mosaic_waits):
    _, _, ji, _ = mosaic_waits
    rk = stress.ckpt_waits_resident(device="cpu")
    bs, waits, heap = stress.ckpt_waits_load()
    iv_f, data_f, info_f = rk.run(bs, data={"heap": heap}, waits=waits,
                                  quantum=2, max_rounds=4096)
    assert int(iv_f[1, 1]) == 1
    bs, waits, heap = stress.ckpt_waits_load()
    own = rk.run(bs, data={"heap": heap}, waits=waits, quantum=2,
                 max_rounds=4096, quiesce=2)[2]["state"]
    for state in (ji["state"], own):
        iv, data, info = rk.run(resume_state=state, quantum=2,
                                max_rounds=4096)
        assert info["pending"] == 0
        assert info["executed"] == info_f["executed"]
        assert int(iv[1, 1]) == 1  # the re-armed wait fired
        assert np.array_equal(data["heap"].numpy(), data_f["heap"].numpy())


def test_user_table_bundle_meta_differs_from_jax_in_kind_classes(
        mosaic_waits):
    """A bundle of a user table's cut carries JAX's meta but for
    ``kind_classes``: JAX classes each user body by a recording pass over
    it (ROADMAP A13), the port writes ``unknown`` for every user body.
    The field feeds only reshard's diagnostics."""
    _, _, ji, jrk = mosaic_waits
    rk = stress.ckpt_waits_resident(device="cpu")
    bs, waits, heap = stress.ckpt_waits_load()
    info = rk.run(bs, data={"heap": heap}, waits=waits, quantum=2,
                  max_rounds=4096, quiesce=2)[2]
    jm = jck.snapshot_resident(jrk, ji).meta
    tm = tck.snapshot_resident(rk, info).meta
    assert ({k: v for k, v in jm.items() if k != "kind_classes"}
            == {k: v for k, v in tm.items() if k != "kind_classes"})
    assert tm["kind_classes"] == dict.fromkeys(("bump", "put", "consume"),
                                               "unknown")
    assert jm["kind_classes"] == {"bump": "link-free", "put": "unknown",
                                  "consume": "unknown"}


# ---------------------------------------------------- (c) ring residue


@pytest.fixture(scope="module")
def mosaic_inject():
    mk = JMegakernel(kernels=[("bump", _jax_bump)], capacity=256,
                     num_values=1024, succ_capacity=8, interpret=True,
                     checkpoint=True)
    rk = JResident(mk, jax_mesh(4, axis_name="q"), migratable_fns=[0],
                   window=4, homed=False, inject=True)
    bs, rows, _, _ = stress.ckpt_inject_load()
    jbs = [JBuilder() for _ in range(4)]
    for d, b in enumerate(bs):
        for i in range(b.num_tasks):
            jbs[d].add(0, args=[2 * d + i + 1])
    iv, _, info = rk.run(jbs, inject_rows=rows, quantum=4, max_rounds=4096,
                         quiesce=True)
    return np.asarray(iv), info


def _port_inject(ndev=4):
    return ResidentKernel(stress.ckpt_bump_megakernel(device="cpu"),
                          cpu_mesh(ndev), migratable_fns=[0], window=4,
                          homed=False, inject=True)


def test_injection_residue_equals_jax(mosaic_inject):
    jiv, ji = mosaic_inject
    bs, rows, want, v = stress.ckpt_inject_load()
    rk = _port_inject()
    iv, _, info = rk.run(bs, inject_rows=rows, quantum=4, max_rounds=4096,
                         quiesce=True)
    assert_run_equal((jiv, ji), (iv, info))
    np.testing.assert_array_equal(np.asarray(ji["inject_ctl"]),
                                  info["inject_ctl"])
    assert_state_equal(ji["state"], info["state"])
    assert info["state"]["ictl"][:, 0].tolist() == [6] * 4  # all residue
    # JAX's resume of the residue, 4 -> 2 (tests/test_checkpoint.py :838).
    small = tck.snapshot_resident(rk, info).reshard(2)
    assert int(small.arrays["ictl"][:, 0].sum()) == 24
    iv, _, info = _port_inject(2).run(resume_state=small.state(), quantum=8,
                                      max_rounds=1 << 14)
    assert info["pending"] == 0 and info["executed"] == v
    assert int(iv[:, 0].sum()) == want


def test_injection_cursor_after_a_later_cut():
    """A cut after the polls consumed: consumed + residue == published,
    and the resume reaches the same totals."""
    bs, rows, want, _ = stress.ckpt_inject_load()
    rk = _port_inject()
    _, _, info = rk.run(bs, inject_rows=rows, quantum=4, max_rounds=4096,
                        quiesce=2)
    assert info["quiesced"]
    ic = info["inject_ctl"]
    residue = int(info["state"]["ictl"][:, 0].sum())
    assert int(ic[:, 2].sum()) + residue == int(ic[:, 0].sum())
    iv, _, _ = rk.run(resume_state=info["state"], quantum=8)
    assert int(iv[:, 0].sum()) == want


# ---------------------------------------------------- on the port alone


def test_traced_mesh_round_records():
    """tests/test_tracebuf.py :343: fib(9) and fib(7) on 2 devices with
    the recorder: one round bracket a device per round."""
    mk = tw.make_fib_megakernel(256, trace=2048, device="cpu")
    rk = ResidentKernel(mk, cpu_mesh(2), steal=True, homed=False)
    bs = []
    for n in (9, 7):
        b = TBuilder()
        b.add(tw.FIB, args=[n], out=0)
        bs.append(b)
    iv, _, info = rk.run(bs, quantum=64)
    assert [int(iv[0][0]), int(iv[1][0])] == [34, 13]
    tr = info["trace"]
    assert len(tr["rings"]) == 2 and "quiesced" not in info
    for d in range(2):
        begins = tb.records_of(tr, tb.TR_ROUND_BEGIN, ring=d)
        ends = tb.records_of(tr, tb.TR_ROUND_END, ring=d)
        assert len(begins) == len(ends) == info["rounds"]


def _batched_uts(ndev, **kw):
    return stress.ckpt_uts_resident(ndev, batch_width=4, device="cpu", **kw)


def test_mesh_batch_trace_reconciles_with_tstats():
    """tests/test_resident.py :681: the batch records of each device
    equal its tier counters."""
    mk = tw.make_fib_megakernel(256, trace=512, batch_width=4, device="cpu")
    rk = ResidentKernel(mk, cpu_mesh(2), migratable_fns=[tw.FIB],
                        homed=False, window=4)
    bs = [TBuilder() for _ in range(2)]
    bs[0].add(tw.FIB, args=[8], out=0)
    iv, _, info = rk.run(bs, quantum=8)
    assert info["pending"] == 0 and int(iv[:, 0].sum()) == 21
    for d in range(2):
        ring = info["trace"]["rings"][d]
        assert ring["dropped"] == 0
        recs = tb.records_of(info["trace"], tb.TR_FIRE_BATCH, ring=d)
        assert recs.shape[0] == info["tiers"][d]["batch_rounds"]
        takes = int((recs[:, 2] & 0xFFFF).sum()) if recs.size else 0
        assert takes == info["tiers"][d]["batch_tasks"]


def test_mesh_batch_checkpoint_reshard_4_to_2():
    """tests/test_resident.py :691 with lanes active: the quiesced batch
    mesh leaves only ring rows (every sched exit spilled its lanes) and
    the same-mesh resume is exact. Its reshard 4 -> 2 refuses, as JAX's
    does (spawned rows keep their slot's F_HOME under homed=False); the
    migrating configuration (stress.uts_ckpt), whose scheduler clears a
    spawned row's home, reshards the same tree's cut and resumes it."""
    iv_f, _, info_f = _batched_uts(4).run(stress.ckpt_uts_builders(4),
                                          quantum=8, max_rounds=4096)
    total = int(iv_f[:, 0].sum())
    assert info_f["pending"] == 0 and total == info_f["executed"]
    assert sum(t["batch_tasks"] for t in info_f["tiers"]) > 0
    rk = _batched_uts(4)
    _, _, info_q = rk.run(stress.ckpt_uts_builders(4), quantum=8,
                          max_rounds=4096, quiesce=2)
    assert info_q["quiesced"] and info_q["pending"] > 0
    st = info_q["state"]
    live = sum(int(c[1] - c[0]) for c in st["counts"])  # ring rows
    assert live == info_q["pending"]
    iv, _, info = rk.run(resume_state=st, quantum=8, max_rounds=4096)
    assert info["executed"] == info_f["executed"]
    assert int(iv[:, 0].sum()) == total
    with pytest.raises(tck.CheckpointError, match="migration home-link"):
        tck.snapshot_resident(rk, info_q).reshard(2)
    # The migrating configuration's cut re-homes 4 -> 2.
    rk4, bs = stress.uts_ckpt(4, 9, device="cpu")
    iv_f, _, info_f = rk4.run(bs, quantum=8)
    _, _, info_q = rk4.run(bs, quantum=8, quiesce=2)
    assert info_q["quiesced"] and info_q["pending"] > 0
    rk2 = stress.uts_ckpt(2, 9, device="cpu")[0]
    iv, _, info = tck.restore_resident(tck.snapshot_resident(rk4, info_q),
                                       rk2, quantum=8)
    assert info["pending"] == 0 and info["executed"] == info_f["executed"]
    assert int(iv[:, 0].sum()) == int(iv_f[:, 0].sum())


def test_same_mesh_roundtrip_4():
    """tests/test_checkpoint.py :877: a 4-device cut resumed on the same
    mesh equals the uninterrupted run."""
    rk = stress.ckpt_uts_resident(4, device="cpu")
    iv_f, _, info_f = rk.run(stress.ckpt_uts_builders(4), quantum=8,
                             max_rounds=4096)
    total = int(iv_f[:, 0].sum())
    assert info_f["pending"] == 0 and total == info_f["executed"]
    _, _, info_q = rk.run(stress.ckpt_uts_builders(4), quantum=8,
                          max_rounds=4096, quiesce=2)
    assert info_q["quiesced"] is True and info_q["pending"] > 0
    assert all(f["quiesce_round"] >= 2 for f in info_q["fault_stats"])
    iv, _, info = rk.run(resume_state=info_q["state"], quantum=8,
                         max_rounds=4096)
    assert info["pending"] == 0 and info["executed"] == info_f["executed"]
    assert int(iv[:, 0].sum()) == total


def test_tenant_mesh_quiesce_and_reshard():
    """tests/test_tenants.py :1051: the tenant mesh's cut exports the
    tagged residue and the counter blocks, and a reshard 4 -> 2 resumes
    with every tenant's totals."""
    def make(ndev):
        return ResidentKernel(stress.ckpt_bump_megakernel(128, 4,
                                                          device="cpu"),
                              cpu_mesh(ndev), migratable_fns=[0],
                              homed=False, window=4, inject=True,
                              tenants=["gold", "std", "bg"],
                              ring_capacity=96)

    def table_for(rk):
        return MeshTenantTable(rk.tenant_specs, rk.ndev, rk.region_rows)

    def seed(ndev):
        bs = [TBuilder() for _ in range(ndev)]
        for b in bs:
            b.add(0, args=[0])
        return bs

    sub = {"gold": 10, "std": 6, "bg": 4}
    rk2 = make(4)
    t2 = table_for(rk2)
    expect = 0
    for i, (tid, n) in enumerate(sub.items()):
        for _ in range(n):
            assert t2.submit(tid, 0, args=[i + 1])
            expect += i + 1
    _, _, info_q = rk2.run(seed(4), quantum=1, max_rounds=4096, quiesce=1,
                           tenant_table=t2)
    assert info_q["quiesced"] and "tctl" in info_q["state"]
    bundle = tck.snapshot_resident(rk2, info_q)
    assert bundle.meta["tenants"] == list(sub)
    rk3 = make(2)
    iv3, _, info3 = tck.restore_resident(bundle, rk3, quantum=4,
                                         max_rounds=4096,
                                         tenant_table=table_for(rk3))
    assert info3["pending"] == 0
    assert int(iv3[:, 0].sum()) == expect
    untenanted = ResidentKernel(stress.ckpt_bump_megakernel(
        128, 4, device="cpu"), cpu_mesh(2), migratable_fns=[0], homed=False,
        inject=True)
    with pytest.raises(tck.CheckpointError, match="roster mismatch"):
        tck.restore_resident(bundle, untenanted)


def test_resident_quiesce_validation_needs_no_mesh():
    """tests/test_checkpoint.py :504: the host refusals, with JAX's
    messages."""
    import re

    jrk, jrk2 = _jax_uts_rk(2), _jax_uts_rk(2, checkpoint=True)
    trk = stress.ckpt_uts_resident(2, checkpoint=False, device="cpu")
    trk2 = stress.ckpt_uts_resident(2, device="cpu")
    bad_waits = np.zeros((4, 65, 3), np.int32)

    def state():
        return {"tasks": np.zeros((2, 4, 16), np.int32),
                "succ": np.zeros((2, 8), np.int32),
                "ready": np.zeros((2, 4), np.int32),
                "counts": np.zeros((2, 8), np.int32),
                "ivalues": np.zeros((2, 16), np.int32),
                "waits": bad_waits}

    cases = [
        (lambda rk, rk2, B: rk.run(B(2), quiesce=1), "checkpoint=True"),
        (lambda rk, rk2, B: rk2.run(B(2), quiesce=1, waits=[[(0, 1, 0)]]),
         "bad channel id"),
        (lambda rk, rk2, B: rk2.run(B(2), resume_state={}), "exactly one"),
        (lambda rk, rk2, B: rk2.run(), "exactly one"),
        (lambda rk, rk2, B: rk2.run(resume_state=state()),
         "wait table covers"),
        (lambda rk, rk2, B: rk2.run(resume_state=state(), data={}),
         "carries its own"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError) as je:
            call(jrk, jrk2, _jax_uts_builders)
        with pytest.raises(ValueError) as te:
            call(trk, trk2, stress.ckpt_uts_builders)
        assert re.search(match, str(te.value))
        assert str(je.value) == str(te.value)


def test_fault_records_match_fault_stats():
    """The fault layer's records (TR_CREDIT, TR_FAULT), which no JAX test
    reads, held to the run's own fault stats: one TR_CREDIT for each
    dropped, duplicated and regenerated credit, one TR_FAULT for each
    delay and each quarantine."""
    for cfg in (stress.FAULT_CREDITS, stress.FAULT_DEAD):
        from hclib_tpu_torch.device.megakernel import Megakernel

        mk = Megakernel([("bump", stress._bump0, stress.BUMP0_CUDA)],
                        capacity=cfg["capacity"], num_values=1024,
                        succ_capacity=8, trace=512, device="cpu")
        rk = ResidentKernel(mk, cpu_mesh(cfg["ndev"]), migratable_fns=[0],
                            window=4, fault_plan=DeviceFaultPlan(
                                **cfg["plan"]))
        iv, _, info = rk.run(stress.skewed_builders(cfg["ndev"],
                                                    cfg["ntasks"],
                                                    cfg["dev"]),
                             quantum=2, max_rounds=4096)
        n = cfg["ntasks"]
        stress.check_bump(iv, info, n, n * (n + 1) // 2)
        for d, f in enumerate(info["fault_stats"]):
            ring = info["trace"]["rings"][d]
            assert ring["dropped"] == 0
            r = ring["records"]
            credit = r[r[:, 0] == tb.TR_CREDIT, 3].tolist()
            fault = r[r[:, 0] == tb.TR_FAULT, 2].tolist()
            assert credit.count(tb.CR_DROPPED) == f["credits_dropped"]
            assert credit.count(tb.CR_DUPED) == f["credits_duplicated"]
            assert credit.count(tb.CR_REGENERATED) == \
                f["credits_regenerated"]
            assert fault.count(tb.FLT_DELAY) == f["xfers_delayed"]
            assert fault.count(tb.FLT_DEAD_QUARANTINE) == \
                len(f["quarantined"])
        fs = info["fault_stats"]
        assert sum(f["credits_dropped"] + f["xfers_delayed"]
                   + len(f["quarantined"]) for f in fs) > 0


def test_ring_ignores_the_checkpoint_and_records_when_traced():
    """JAX's ring never reads mk.checkpoint: a checkpoint-built table runs
    on the ring as an unbuilt one does (no quiesce, no export); a traced
    one records its rounds, TR_XFER and TR_ABORT."""
    def ring(**kw):
        mk = stress.forest_megakernel(24, 1024, 0, "cpu", **kw)
        return ICIStealMegakernel(mk, cpu_mesh(3), migratable_fns=[tw.FIB],
                                  window=8)

    bs = lambda: stress.forest_builders(3, 24, 9)  # noqa: E731
    iv0, _, i0 = ring().run(bs(), quantum=64)
    iv1, _, i1 = ring(checkpoint=True).run(bs(), quantum=64)
    np.testing.assert_array_equal(iv0, iv1)
    np.testing.assert_array_equal(i0["per_device_counts"],
                                  i1["per_device_counts"])
    assert "quiesced" not in i1 and "state" not in i1
    iv2, _, i2 = ring(trace=4096).run(bs(), quantum=64)
    np.testing.assert_array_equal(iv0, iv2)
    for d, rg in enumerate(i2["trace"]["rings"]):
        r = rg["records"]
        assert (r[:, 0] == tb.TR_ROUND_BEGIN).sum() == i2["steal_rounds"]
        assert int(r[r[:, 0] == tb.TR_XFER, 3].sum()) == \
            i2["exchange"]["rows"][d]
    _, _, i3 = ring(trace=64).run(bs(), quantum=64, abort=[0, 0, 1])
    assert all(int((rg["records"][:, 0] == tb.TR_ABORT).sum()) == 1
               for rg in i3["trace"]["rings"])


# ---------------------------------------------------- reshard vs JAX


def _fake_arrays(ndev=2, cap=8, live_per_dev=1, extra=None, mutate=None):
    """tests/test_checkpoint.py's clean-quiesce resident bundle."""
    tasks = np.zeros((ndev, cap, DESC_WORDS), np.int32)
    tasks[:, :, 2:4] = NO_TASK
    tasks[:, :, F_HOME] = NO_TASK
    counts = np.zeros((ndev, 8), np.int32)
    counts[:, 1:4] = live_per_dev  # tail, alloc, pending
    counts[:, 4] = 2  # value_alloc
    arrays = {"tasks": tasks, "succ": np.full((ndev, 8), -1, np.int32),
              "ready": np.zeros((ndev, cap), np.int32), "counts": counts,
              "ivalues": np.zeros((ndev, 16), np.int32)}
    if mutate is not None:
        mutate(tasks)
    arrays.update(extra or {})
    return {"ndev": ndev}, arrays


def _waits_arrays(ndev=4, cap=8, live=1, parked=(), channels=("left",
                  "right"), host_residue=None, max_waits=4, seed=0):
    """tests/test_checkpoint.py's bundle with wait-parked rows."""
    tasks = np.zeros((ndev, cap, DESC_WORDS), np.int32)
    tasks[:, :, 2:4] = NO_TASK
    tasks[:, :, F_HOME] = NO_TASK
    ready = np.full((ndev, cap), NO_TASK, np.int32)
    counts = np.zeros((ndev, 8), np.int32)
    waits = np.zeros((ndev, max_waits + 1, 3), np.int32)
    for d in range(ndev):
        for i in range(live):
            tasks[d, i, F_FN] = 1
            ready[d, i] = i
        npk = 0
        for (pd, ch, need) in parked:
            if pd != d:
                continue
            slot = live + npk
            tasks[d, slot, F_FN] = 2
            tasks[d, slot, F_DEP] = 1
            w = int(waits[d, 0, 0])
            waits[d, 1 + w] = (ch, need, slot)
            waits[d, 0, 0] = w + 1
            npk += 1
        counts[d, 1] = live
        counts[d, 2:4] = live + npk
        counts[d, 4] = 2
    rng = np.random.default_rng(seed)
    meta = {"ndev": ndev, "channels": list(channels)}
    if host_residue:
        meta["host_residue"] = dict(host_residue)
    return meta, {"tasks": tasks, "succ": np.full((ndev, 8), -1, np.int32),
                  "ready": ready, "counts": counts,
                  "ivalues": rng.integers(0, 1 << 20, (ndev, 16)).astype(
                      np.int32),
                  "waits": waits}


def _ring_residue(full=False):
    rr = np.zeros((2, 8, RING_ROW), np.int32)
    ic = np.zeros((2, 8), np.int32)
    for d in range(2):
        for i in range(3):
            rr[d, i, 0] = 10 * d + i
        ic[d, 0] = 8 if full else 3
        ic[d, 1] = 1
    return {"ring_rows": rr, "ictl": ic,
            "waits": np.zeros((2, 5, 3), np.int32)}


def _set(word, value, d=0, row=0):
    def mutate(t):
        t[d, row, word] = value
    return mutate


RESHARD_CASES = {
    # test_reshard_refuses_unsafe_rows
    "ok_1": (_fake_arrays(), 1),
    "dep": (_fake_arrays(mutate=_set(F_DEP, 1)), 1),
    "linked": (_fake_arrays(mutate=_set(F_SUCC0, 1)), 1),
    "homed": (_fake_arrays(mutate=_set(F_HOME, 1)), 1),
    "dyn_out": (_fake_arrays(mutate=_set(F_OUT, 5)), 1),
    "not_pof2": (_fake_arrays(), 3),
    # test_reshard_m_edge_cases_diagnosed
    "fold_1": (_fake_arrays(live_per_dev=2), 1),
    "grow_8": (_fake_arrays(live_per_dev=2), 8),
    "zero": (_fake_arrays(), 0),
    "integer": (_fake_arrays(), "two"),
    "overfull": (_fake_arrays(cap=4, live_per_dev=3), 1),
    # test_reshard_rehomes_ring_residue_and_empty_waits
    "ring_1": (_fake_arrays(extra=_ring_residue()), 1),
    "ring_4": (_fake_arrays(extra=_ring_residue()), 4),
    "ring_overflow": (_fake_arrays(extra=_ring_residue(True)), 1),
    # test_reshard_waits_conservation_matrix
    "waits_2": (_waits_arrays(parked=[(0, 0, 3), (1, 1, 2), (2, 0, 1),
                                      (3, 1, 4)]), 2),
    "waits_1": (_waits_arrays(parked=[(0, 0, 3), (1, 1, 2), (2, 0, 1),
                                      (3, 1, 4)]), 1),
    "waits_8": (_waits_arrays(parked=[(0, 0, 3), (1, 1, 2), (2, 0, 1),
                                      (3, 1, 4)]), 8),
    # test_reshard_refuses_satisfier_in_residue
    "residue": (_waits_arrays(parked=[(0, 0, 3), (1, 0, 1), (2, 1, 2)],
                              host_residue={"left": 2, "right": 1}), 2),
    "residue_unwaited": (_waits_arrays(parked=[(0, 0, 3)],
                                       host_residue={"right": 5}), 2),
    # test_reshard_diagnoses_wait_dep_mismatch
    "wait_dep": (_waits_arrays(ndev=2, parked=[(0, 0, 2)]), 1),
}
RESHARD_CASES["wait_dep"][0][1]["tasks"][0, 1, F_DEP] = 0  # strip the bump


@pytest.mark.parametrize("name", sorted(RESHARD_CASES))
def test_reshard_equals_jax(name):
    """Each bundle of JAX's reshard tests through both packages'
    ``reshard``: equal arrays and meta, or the same refusal."""
    (meta, arrays), m = RESHARD_CASES[name]
    j = jck.CheckpointBundle("resident", dict(meta),
                             {k: v.copy() for k, v in arrays.items()})
    t = tck.CheckpointBundle("resident", dict(meta),
                             {k: v.copy() for k, v in arrays.items()})
    try:
        jout = j.reshard(m)
    except jck.CheckpointError as e:
        with pytest.raises(tck.CheckpointError) as te:
            t.reshard(m)
        assert str(te.value) == str(e)
        return
    tout = t.reshard(m)
    assert tout.meta == jout.meta
    assert set(tout.arrays) == set(jout.arrays)
    for k, v in jout.arrays.items():
        np.testing.assert_array_equal(tout.arrays[k], v, err_msg=k)
    # A second reshard of the result, as JAX's matrix runs 4 -> 2 -> 4.
    if not isinstance(m, str) and m >= 1:
        np.testing.assert_array_equal(tout.reshard(4).arrays["counts"],
                                      jout.reshard(4).arrays["counts"])


def test_reshard_kind_checks_equal_jax():
    for cls, err in ((jck.CheckpointBundle, jck.CheckpointError),
                     (tck.CheckpointBundle, tck.CheckpointError)):
        with pytest.raises(err, match="applies to resident-mesh bundles"):
            cls("megakernel", {}, {}).reshard(2)
