"""The host halves of the port's streaming front door (device/tenants.py,
device/egress.py, device/telemetry.py, runtime/clockprobe.py and the
resilience pieces they use) held to the JAX package's on the same
seeded inputs: the executable specs (``wrr_poll_reference``,
``egress_reference``, ``flush_parked_reference``, ``hist_fold_reference``,
``bucket_of``, ``unpack_spans``), the tenant table's admission ladder and
its pump / absorb / export_state / resume_from under a fake clock, and
the environment spellings. Every word compared is int32: exact."""

import numpy as np
import pytest

from hclib_tpu.device import egress as jeg
from hclib_tpu.device import telemetry as jtl
from hclib_tpu.device import tenants as jten
from hclib_tpu.runtime import clockprobe as jcp
from hclib_tpu.runtime import resilience as jres
from hclib_tpu_torch.device import descriptor as tdesc
from hclib_tpu_torch.device import egress as teg
from hclib_tpu_torch.device import telemetry as ttl
from hclib_tpu_torch.device import tenants as tten
from hclib_tpu_torch.runtime import clockprobe as tcp
from hclib_tpu_torch.runtime import env as tenv
from hclib_tpu_torch.runtime import resilience as tres

class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _rows(rng, n):
    return [np.asarray(jten.build_row(0, [int(x)]), np.int32)
            for x in rng.integers(0, 1000, n)]


# ------------------------------------------------------- executable specs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrr_poll_reference(seed):
    rng = np.random.default_rng(seed)
    T, region = 3, 16
    ring = rng.integers(0, 1 << 20, (T * region, tdesc.RING_ROW)).astype(
        np.int32)
    ring[:, tdesc.TEN_EXPIRED] = rng.random(T * region) < 0.2
    tctl = np.zeros((T, 8), np.int32)
    tctl[:, tten.TC_TAIL] = rng.integers(0, region, T)
    tctl[:, tten.TC_WEIGHT] = rng.integers(1, 5, T)
    tctl[:, tten.TC_PAUSE] = [0, 1, 0] if seed == 1 else 0
    outs = []
    for ten in (jten, tten):
        tc = tctl.copy()
        got = []
        for r in range(6):
            got += ten.wrr_poll_reference(ring, tc, region, r, headroom=5)
        outs.append((tc, np.asarray(got).reshape(-1, tdesc.RING_ROW)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("depth", [1, 4])
def test_egress_reference_park_and_flush(depth):
    rng = np.random.default_rng(depth)
    rows = [(int(t), int(rng.integers(0, 3)), int(rng.integers(0, 4)),
             int(rng.integers(0, 64)), int(rng.integers(-99, 99)))
            for t in rng.integers(0, 6, 12)]
    outs = []
    for eg in (jeg, teg):
        egr = np.zeros((depth, eg.EGR_WORDS), np.int32)
        park = np.zeros((16, eg.EGR_WORDS), np.int32)
        ectl = np.zeros(8, np.int32)
        pub = eg.egress_reference(rows, egr, park, ectl, depth)
        ectl[eg.EC_CONSUMED] = ectl[eg.EC_WRITE]  # the host consumed all
        fl = eg.flush_parked_reference(egr, park, ectl, depth)
        outs.append((pub, fl, egr, park, ectl))
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    with pytest.raises(teg.EgressProtocolError, match="park buffer"):
        teg.egress_reference(rows, np.zeros((1, 8), np.int32),
                             np.zeros((1, 8), np.int32),
                             np.zeros(8, np.int32), 1)


def test_host_mailbox_slow_poller_loses_nothing():
    outs = []
    for eg in (jeg, teg):
        ft = eg.FutureTable(clock=FakeClock())
        futs = [ft.create("t", 0, 1) for _ in range(10)]
        mb = eg.HostMailbox(eg.EgressSpec(depth=3), park_cap=16)
        mb.publish([(f.token, 0, 0, 1, 100 + i)
                    for i, f in enumerate(futs)])
        got = []
        while ft.pending():
            got += mb.drain(ft, limit=2)
        outs.append((got, [f.value for f in futs], ft.conservation()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_telemetry_specs(seed):
    rng = np.random.default_rng(seed)
    ds = [int(x) for x in rng.integers(-5, 1 << 17, 40)] + [0, 1, 2, 3]
    assert [jtl.bucket_of(d) for d in ds] == [ttl.bucket_of(d) for d in ds]
    assert jtl.bucket_edges() == ttl.bucket_edges()
    for a, s in rng.integers(0, 1 << 30, (20, 2)):
        assert jtl.unpack_spans(a, s) == ttl.unpack_spans(a, s)
    tele = rng.integers(0, 9, (4, jtl.LAT_BUCKETS)).astype(np.int32)
    ret = [(int(t), int(d)) for t, d in
           zip(rng.integers(0, 3, 30), rng.integers(-3, 1 << 16, 30))]
    hj = jtl.hist_fold_reference(tele, ret)
    ht = ttl.hist_fold_reference(tele, ret)
    assert np.array_equal(hj, ht)
    for q in (0.5, 0.9, 0.99):
        for row in hj[1:]:
            assert jtl.quantile_from_hist(row, q) == \
                ttl.quantile_from_hist(row, q)
    bj = jtl.TelemetryBlock(hj, 1000.0)
    bt = ttl.TelemetryBlock(ht, 1000.0)
    assert bj.total() == bt.total()
    assert bj.quantile(0.99) == bt.quantile(0.99)
    assert bj.quantile_s(0.5) == bt.quantile_s(0.5)
    with pytest.raises(ValueError):
        ttl.hist_fold_reference(tele, [(7, 1)])


def test_epoch_bracket():
    brs = [jcp.EpochBracket(), tcp.EpochBracket()]
    for br in brs:
        assert br.ns_per_round() is None
        for t0, t1, r in ((0, 1000, 10), (5, 3, 4), (100, 900, 0)):
            br.accumulate(t0, t1, r)
    assert [b.ns_per_round() for b in brs][0] == brs[1].ns_per_round()
    assert brs[0].to_ns(7) == brs[1].to_ns(7)


# ------------------------------------------------------- the tenant table


def _admission_ladder(ten, rng):
    clock = FakeClock()
    out = []
    t = ten.TenantTable(
        [ten.TenantSpec("a", max_in_flight=2, queue_capacity=5, rate=1.0,
                        burst=8.0)], 16, clock=clock)
    out += [t.admit("a", r) for r in _rows(rng, 6)]
    t2 = ten.TenantTable([ten.TenantSpec("b", rate=1.0, burst=2.0)], 16,
                         clock=clock)
    out += [t2.admit("b", r) for r in _rows(rng, 3)]
    clock.advance(1.0)
    out.append(t2.admit("b", _rows(rng, 1)[0]))
    t3 = ten.TenantTable([ten.TenantSpec("c", queue_capacity=100)], 8,
                         clock=clock)
    out += [t3.admit("c", r) for r in _rows(rng, 9)]
    t4 = ten.TenantTable([ten.TenantSpec("d")], 8, clock=clock)
    out.append(t4.admit("d", _rows(rng, 1)[0], deadline_at=clock() - 1))
    t4.quarantine("d", "test")
    out.append(t4.admit("d", _rows(rng, 1)[0]))
    t5 = ten.TenantTable([ten.TenantSpec("e")], 8, clock=clock)
    t5.cancel("e", "gone")
    out.append(t5.admit("e", _rows(rng, 1)[0]))
    return [(a.status, a.tenant, a.reason) for a in out], [
        x.stats() for x in (t, t2, t3, t4, t5)]


def test_admission_verdicts_every_reject_reason():
    got = [_admission_ladder(ten, np.random.default_rng(7))
           for ten in (jten, tten)]
    assert got[0] == got[1]
    reasons = {r for _, _, r in got[1][0] if r}
    assert {"backlog", "rate", "ring", "expired", "quarantined",
            "cancelled"} <= reasons


def _table_cycle(ten, eg):
    """pump / device-poll model / absorb over a few entries, with ring
    expiry, a throttled and a quarantined lane, then export_state and a
    resume_from on a fresh table (deadlines re-armed, futures preempted
    and re-attached)."""
    clock = FakeClock()
    rng = np.random.default_rng(11)
    specs = [ten.TenantSpec("g", weight=4, queue_capacity=64,
                            max_in_flight=6),
             ten.TenantSpec("s", weight=2, queue_capacity=64,
                            deadline_s=0.15),
             ten.TenantSpec("b", weight=1, queue_capacity=64)]
    t = ten.TenantTable(specs, 16, clock=clock,
                        egress=eg.EgressSpec(depth=8))
    ring = np.zeros((48, tdesc.RING_ROW), np.int32)
    futs = []
    for i, r in enumerate(_rows(rng, 30)):
        adm = t.admit(i % 3, r, t.resolve_deadline(i % 3, None, None))
        futs.append(adm.future)
    log = []
    t.set_admit_round(3)
    for e in range(4):
        tctl = t.pump(ring)
        log.append(tctl.copy())
        ten.wrr_poll_reference(ring, tctl, 16, e, headroom=2)
        t.absorb(tctl)
        clock.advance(0.1)
        if e == 1:
            t.throttle("g")
        if e == 2:
            t.quarantine("b", "poison")
    st = t.export_state(ring)
    stats = t.stats()
    t2 = ten.TenantTable(specs, 16, clock=clock,
                         egress=eg.EgressSpec(depth=8))
    t2.resume_from(st)
    ring2 = np.zeros_like(ring)
    tctl2 = t2.pump(ring2)
    # Residue rows' futures re-attach to the resumed table (installed
    # rows' tokens come back through the stream's etok table instead).
    residue = set(st["ring_rows"][:, tdesc.TEN_TOKEN].tolist())
    re = [t2.reattach(f.resume_token).state for f in futs
          if f.state == "PREEMPTED" and f.token in residue]
    return (log, {k: v for k, v in st.items()}, stats, tctl2, ring2,
            t2.stats(), [f.state for f in futs], re,
            t.futures.conservation(), t2.futures.conservation())


def test_pump_absorb_export_resume():
    a = _table_cycle(jten, jeg)
    b = _table_cycle(tten, teg)
    for x, y in zip(a, b):
        if isinstance(x, dict) and x and isinstance(
                next(iter(x.values())), np.ndarray):
            assert x.keys() == y.keys()
            for k in x:
                assert np.array_equal(x[k], y[k]), k
        elif isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y
    states = set(b[6])
    assert "PREEMPTED" in states and "EXPIRED" in states


def test_ring_counts_and_normalize():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 3, (20, tdesc.RING_ROW)).astype(np.int32)
    assert jten.per_tenant_ring_counts(rows) == \
        tten.per_tenant_ring_counts(rows)
    for arg in (3, ["x", {"id": "y", "weight": 3}], False):
        a, b = jten.normalize_tenants(arg), tten.normalize_tenants(arg)
        if a is None:
            assert b is None
        else:
            assert [(s.id, s.weight) for s in a] == [
                (s.id, s.weight) for s in b]
    with pytest.raises(ValueError, match="ambiguous"):
        tten.normalize_tenants(True)


@pytest.mark.parametrize("env,err", [
    ({"HCLIB_TPU_TENANTS": "3", "HCLIB_TPU_TENANT_WEIGHTS": "4,2,1",
      "HCLIB_TPU_TENANT_RATE": "5", "HCLIB_TPU_TENANT_INFLIGHT": "2",
      "HCLIB_TPU_TENANT_DEADLINE_S": "0.5"}, None),
    ({"HCLIB_TPU_TENANTS": "x"}, "must be an int"),
    ({"HCLIB_TPU_TENANT_WEIGHTS": "4,0"}, ">= 1"),
    ({"HCLIB_TPU_TENANTS": "2", "HCLIB_TPU_TENANT_WEIGHTS": "1,2,3"},
     "disagrees"),
    ({"HCLIB_TPU_TENANTS": "1", "HCLIB_TPU_TENANT_BURST": "3"},
     "needs HCLIB_TPU_TENANT_RATE"),
    ({"HCLIB_TPU_TENANTS": "1", "HCLIB_TPU_TENANT_INFLIGHT": "2.5"},
     "whole number"),
    ({"HCLIB_TPU_TENANTS": "1", "HCLIB_TPU_TENANT_RATE": "fast"},
     "not a number"),
])
def test_env_spellings(monkeypatch, env, err):
    for k in tenv.REGISTRY:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if err is not None:
        for ten in (jten, tten):
            with pytest.raises(ValueError, match=err):
                ten.tenants_from_env()
        return
    a, b = jten.tenants_from_env(), tten.tenants_from_env()
    assert [(s.id, s.weight, s.max_in_flight, s.deadline_s) for s in a] == \
        [(s.id, s.weight, s.max_in_flight, s.deadline_s) for s in b]


def test_egress_and_telemetry_env(monkeypatch):
    for k in tenv.REGISTRY:
        monkeypatch.delenv(k, raising=False)
    assert teg.egress_from_env() is None
    monkeypatch.setenv("HCLIB_TPU_EGRESS_DEPTH", "16")
    monkeypatch.setenv("HCLIB_TPU_EGRESS_BACKOFF_S", "0.01")
    a, b = jeg.egress_from_env(), teg.egress_from_env()
    assert (a.depth, a.backoff_s) == (b.depth, b.backoff_s) == (16, 0.01)
    monkeypatch.setenv("HCLIB_TPU_EGRESS_DEPTH", "deep")
    with pytest.raises(ValueError, match="HCLIB_TPU_EGRESS_DEPTH"):
        teg.egress_from_env()
    names = ("HCLIB_TPU_TENANTS", "HCLIB_TPU_TENANT_WEIGHTS",
             "HCLIB_TPU_TENANT_RATE", "HCLIB_TPU_TENANT_BURST",
             "HCLIB_TPU_TENANT_INFLIGHT", "HCLIB_TPU_TENANT_DEADLINE_S",
             "HCLIB_TPU_EGRESS_DEPTH", "HCLIB_TPU_EGRESS_BACKOFF_S",
             "HCLIB_TPU_TELEMETRY", "HCLIB_TPU_TELEMETRY_POLL_S")
    assert set(names) <= set(tenv.REGISTRY)
    monkeypatch.setenv("HCLIB_TPU_TELEMETRY_POLL_S", "soon")
    with pytest.raises(ValueError, match="POLL_S"):
        tenv.env_float("HCLIB_TPU_TELEMETRY_POLL_S", 0.05)


def test_left_out_pieces_name_their_items():
    # The mesh front door runs (tests/test_torch_inject_mesh.py), and so
    # does a tenant mesh's quiesce, on a checkpoint build (without one it
    # refuses with JAX's message); the rest names its ROADMAP item.
    from hclib_tpu_torch.device.descriptor import TaskGraphBuilder
    from hclib_tpu_torch.device.resident import ResidentKernel
    from hclib_tpu_torch.device.stress import bump_megakernel
    from hclib_tpu_torch.parallel.mesh import cpu_mesh

    assert [s.id for s in tten.normalize_mesh_tenants(2)] == ["t0", "t1"]
    rk = ResidentKernel(bump_megakernel("cpu"), cpu_mesh(2), inject=True,
                        tenants=2)
    table = tten.MeshTenantTable(rk.tenant_specs, 2, rk.region_rows)
    with pytest.raises(ValueError, match="checkpoint=True"):
        rk.run([TaskGraphBuilder() for _ in range(2)], quiesce=True,
               tenant_table=table)
    from hclib_tpu_torch.device.stress import ckpt_bump_megakernel

    rk = ResidentKernel(ckpt_bump_megakernel(device="cpu"), cpu_mesh(2),
                        inject=True, tenants=2)
    table = tten.MeshTenantTable(rk.tenant_specs, 2, rk.region_rows)
    assert table.submit("t1", 0, args=[5])
    _, _, info = rk.run([TaskGraphBuilder() for _ in range(2)],
                        quiesce=True, tenant_table=table)
    assert info["quiesced"] and "tctl" in info["state"]
    t = tten.TenantTable([tten.TenantSpec("a")], 8)
    with pytest.raises(NotImplementedError, match="A13"):
        t.protocol_model()


def test_cancel_scope_abort_and_preempt_hooks():
    """The resilience pieces the stream uses: a scope's cancel fires the
    bound abort hook (register-then-replay), deadlines inherit, and a
    preempt hook replays when the preemption fired first."""
    for res in (jres, tres):
        seen = []
        parent = res.CancelScope()
        child = res.CancelScope(parent)
        parent.set_deadline(at=50.0)
        child.set_deadline(at=80.0)
        assert child.effective_deadline() == 50.0
        assert child.deadline_expired(now=60.0)
        un = res.bind_abort_to_scope(seen.append, child)
        parent.cancel("stop")
        un()
        assert seen == ["scope cancelled: stop"]
        res.reset_cancel_epoch()
        hits = []
        res.reset_preempt()
        res.fire_preempt("test")

        def hook():
            hits.append(1)

        res.register_preempt_hook(hook)
        res.unregister_preempt_hook(hook)
        assert hits == [1] and res.preempt_requested()
        res.reset_preempt()
        pol = res.RetryPolicy(max_attempts=3, seed=4)
        assert pol.should_retry(0, ValueError()) and not pol.should_retry(
            2, ValueError())
        assert not pol.should_retry(0, res.CancelledError())
    a, b = jres.RetryPolicy(seed=9), tres.RetryPolicy(seed=9)
    assert [a.delay_s(i) for i in range(1, 5)] == [
        b.delay_s(i) for i in range(1, 5)]
