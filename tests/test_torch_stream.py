"""The streaming front door of the port (hclib_tpu_torch/device/inject.py:
``StreamingMegakernel`` with tenant lanes, the completion mailbox and live
telemetry; ``serve_dyngraph``; stream checkpoints) held to the JAX
package's on the same inputs, word for word (every word is int32).

The JAX side runs its interpret-mode stream kernel; the port runs its
plain stream (``device="cpu"``). Each JAX scenario runs at most once a
module (the ``jax_runs`` fixture, asked by each test for the one it
compares with) and the tests compare against it: returned values, the
info dicts (wall-clock fields dropped), the exported state, the echoed
tenant, mailbox and telemetry blocks, futures and the decoded trace
records.
"""

import types

import numpy as np
import pytest
import torch

from hclib_tpu.device import descriptor as jdesc
from hclib_tpu.device import dyngraph as jdg
from hclib_tpu.device import egress as jeg
from hclib_tpu.device import inject as jinj
from hclib_tpu.device import tenants as jten
from hclib_tpu.device import workloads as jw
from hclib_tpu.runtime import checkpoint as jck
from hclib_tpu.runtime.resilience import CancelledError as JCancelled
from hclib_tpu_torch.device import descriptor as tdesc
from hclib_tpu_torch.device import dyngraph as tdg
from hclib_tpu_torch.device import egress as teg
from hclib_tpu_torch.device import inject as tinj
from hclib_tpu_torch.device import tenants as tten
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.runtime import checkpoint as tck
from hclib_tpu_torch.runtime.resilience import CancelledError as TCancelled

QUANTUM, MAX_ROUNDS = 16, 6
CAP = 384
NV = 4 * CAP + 128  # fib's row-owned blocks plus 128 host slots
TRACE = 512

JAX = types.SimpleNamespace(
    name="jax", inj=jinj, ten=jten, eg=jeg, desc=jdesc, ck=jck,
    Cancelled=JCancelled,
    fib_mk=lambda **kw: jw.make_fib_megakernel(
        capacity=CAP, num_values=NV, interpret=True, **kw),
)
TORCH = types.SimpleNamespace(
    name="torch", inj=tinj, ten=tten, eg=teg, desc=tdesc, ck=tck,
    Cancelled=TCancelled,
    fib_mk=lambda **kw: tw.make_fib_megakernel(
        capacity=CAP, num_values=NV, device="cpu", **kw),
)


class Clock:
    """A deterministic table clock: ``step`` seconds a call."""

    def __init__(self, step: float = 0.0) -> None:
        self.t, self.step = 100.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def on_pump(table, actions) -> None:
    """Run ``actions[k]`` before the table's k-th pump (1-based): the
    driver pumps once before every entry, in both packages."""
    n, pump = [0], table.pump

    def hooked(ring):
        n[0] += 1
        act = actions.get(n[0])
        if act is not None:
            act()
        return pump(ring)

    table.pump = hooked


def _trace(info):
    ring = info["trace"]["rings"][0]
    return ring["written"], ring["dropped"], np.asarray(ring["records"])


def _futs(futs):
    return [(f.state, f.value if f.state == "RESULT" else None)
            for f in futs]


def _state(st):
    """A state dict as comparable numpy (tenant ids and data included)."""
    out = {}
    for k, v in st.items():
        if k == "data":
            out.update({f"data/{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _fib_builder(P, n):
    b = P.desc.TaskGraphBuilder()
    b.add(jw.FIB, args=[n], out=0)
    b.reserve_values(128)  # host slots below the row-owned blocks
    return b


# ------------------------------------------------------------- scenarios


def firehose(P):
    """A fib(10) tree with eight fib seeds injected before the run: rows
    reach the scheduler only through the in-kernel poll, mid-entry
    (quantum 16), with the recorder on a ring that wraps."""
    sm = P.inj.StreamingMegakernel(P.fib_mk(trace=64), ring_capacity=32)
    for i, n in enumerate([5, 7, 8, 9, 11, 6, 4, 12]):
        sm.inject(jw.FIB, args=[n], out=1 + i)
    sm.close()
    iv, info = sm.run_stream(_fib_builder(P, 10), quantum=QUANTUM,
                             max_rounds=MAX_ROUNDS)
    return {"iv": np.asarray(iv), "info": {k: info[k] for k in
                                            ("executed", "pending",
                                             "injected")},
            "trace": _trace(info)}


def _lanes_stream(P, clock, depth=4, telemetry=True, checkpoint=False,
                  trace=TRACE, per=12, deadline=None):
    """Three lanes at 4:2:1 (gold / silver / bronze) over a running fib(8)
    tree; each lane submits ``per`` SUM requests of two preset slots,
    egress depth 4 so retirements park."""
    table = P.ten.TenantTable(
        [P.ten.TenantSpec("gold", weight=4),
         P.ten.TenantSpec("silver", weight=2),
         P.ten.TenantSpec("bronze", weight=1)],
        32, clock=clock, egress=P.eg.EgressSpec(depth=depth))
    sm = P.inj.StreamingMegakernel(
        P.fib_mk(trace=trace, checkpoint=checkpoint), ring_capacity=96,
        tenants=table, telemetry=telemetry)
    futs = []
    for lane, tid in enumerate(("gold", "silver", "bronze")):
        for i in range(per):
            dl = deadline if (deadline is not None and lane == 2) else None
            adm = sm.submit(tid, jw.SUM, args=[1 + i % 4, 5 + i % 3],
                            out=16 + lane * per + i, deadline_s=dl)
            assert adm.accepted, adm
            futs.append(adm.future)
    iv = np.zeros(NV, np.int32)
    iv[1:8] = [10, 20, 30, 40, 50, 60, 70]
    return sm, futs, iv


def lanes(P):
    clock = Clock()
    sm, futs, iv = _lanes_stream(P, clock)
    sm.close()
    out, info = sm.run_stream(_fib_builder(P, 8), ivalues=iv,
                              quantum=QUANTUM, max_rounds=MAX_ROUNDS)
    tele = info["telemetry"]
    return {"iv": np.asarray(out), "futs": _futs(futs),
            "tenants": info["tenants"], "executed": info["executed"],
            "tele": np.asarray(tele["tele"]), "rounds": tele["rounds"],
            "spans": sm.telemetry_spans(), "trace": _trace(info),
            "egress": sm.stats_dict()["egress"],
            "cons": sm.tenants.futures.conservation()}


def expiry_quarantine(P):
    """Bronze requests carry a deadline the stepping clock passes while
    rows wait on the ring (marked TEN_EXPIRED and dropped by the device
    poll, counted); silver is quarantined after the first entry, so the
    device sweeps its published rows and the rest of its backlog
    drops."""
    clock = Clock(step=0.05)
    sm, futs, iv = _lanes_stream(P, clock, deadline=0.5)
    sm.close()
    on_pump(sm.tenants, {2: lambda: sm.tenants.quarantine("silver", "test")})
    out, info = sm.run_stream(_fib_builder(P, 8), ivalues=iv,
                              quantum=QUANTUM, max_rounds=2)
    return {"iv": np.asarray(out), "futs": _futs(futs),
            "tenants": info["tenants"], "executed": info["executed"],
            "tele": np.asarray(info["telemetry"]["tele"]),
            "trace": _trace(info), "cons": sm.tenants.futures.conservation()}


def abort(P):
    """abort() lands between entries (from the clock hook): one final
    entry runs with the abort word and the frozen all-paused tctl, the
    mailbox drains and every other outstanding future is poisoned."""
    clock = Clock()
    sm, futs, iv = _lanes_stream(P, clock)
    sm.close()
    on_pump(sm.tenants, {3: lambda: sm.abort("client disconnect")})
    with pytest.raises(P.Cancelled, match="client disconnect"):
        sm.run_stream(_fib_builder(P, 8), ivalues=iv, quantum=QUANTUM,
                      max_rounds=MAX_ROUNDS)
    stats = sm.stats_dict()
    stats.pop("abort_latency_s")
    return {"futs": _futs(futs), "stats": stats,
            "cons": sm.tenants.futures.conservation()}


def quiesce_resume(P):
    """A quiesce at k = 60 executed tasks with rows parked, lanes half
    consumed and requests in flight; the cut's state, then its resume on
    the same object and on a fresh one (futures preempted, re-attached
    through their resume tokens), each to the drained exit."""
    clock = Clock()
    sm, futs, iv = _lanes_stream(P, clock, checkpoint=True)
    sm.quiesce(after_executed=60)
    _, cut = sm.run_stream(_fib_builder(P, 8), ivalues=iv, quantum=QUANTUM,
                           max_rounds=MAX_ROUNDS)
    assert cut["quiesced"]
    st = cut["state"]
    res = {"cut": _state(st), "cut_info": {k: cut[k] for k in (
        "executed", "pending", "injected", "quiesce_observed_round")},
           "cut_futs": _futs(futs), "cut_trace": _trace(cut)}
    tokens = [f.resume_token for f in futs if f.state == "PREEMPTED"]
    sm2, _, _ = _lanes_stream(P, Clock(), checkpoint=True, per=0)
    sm2.close()
    out2, fin2 = sm2.run_stream(resume_state=st, quantum=QUANTUM,
                                max_rounds=MAX_ROUNDS)
    res["fresh"] = (np.asarray(out2), fin2["tenants"],
                    np.asarray(fin2["telemetry"]["tele"]), _trace(fin2))
    res["fresh_futs"] = [sm2.tenants.reattach(t).result(timeout=5)
                         for t in tokens]
    sm.close()
    out1, fin1 = sm.run_stream(resume_state=st, quantum=QUANTUM,
                               max_rounds=MAX_ROUNDS)
    res["same"] = (np.asarray(out1), fin1["tenants"],
                   np.asarray(fin1["telemetry"]["tele"]), _trace(fin1))
    res["tokens"] = len(tokens)
    return res, (sm, cut)


def firehose_quiesce(P):
    """The single firehose quiesced at k = 100: the residue rides as
    ``ring_rows``; resumed on a fresh stream it finishes the values."""
    sm = P.inj.StreamingMegakernel(P.fib_mk(checkpoint=True),
                                   ring_capacity=32)
    for i, n in enumerate([5, 7, 8, 9, 11, 6, 4, 12]):
        sm.inject(jw.FIB, args=[n], out=1 + i)
    sm.quiesce(after_executed=100)
    _, cut = sm.run_stream(_fib_builder(P, 10), quantum=QUANTUM,
                           max_rounds=MAX_ROUNDS)
    sm2 = P.inj.StreamingMegakernel(P.fib_mk(checkpoint=True),
                                    ring_capacity=32)
    sm2.close()
    out, fin = sm2.run_stream(resume_state=cut["state"], quantum=QUANTUM,
                              max_rounds=MAX_ROUNDS)
    return {"cut": _state(cut["state"]), "iv": np.asarray(out),
            "executed": fin["executed"]}, (sm, cut)


def _serve_graph(dg):
    rng = np.random.default_rng(3)
    n, m = 24, 80
    return dg.DynGraph(n, rng.integers(0, n, m), rng.integers(0, n, m),
                       rng.integers(1, 8, m), spare_blocks=2, upd_cap=16)


def serve(P):
    dg, kw = (jdg, {"interpret": True}) if P.name == "jax" else (
        tdg, {"device": "cpu"})
    g = _serve_graph(dg)
    res, info = dg.serve_dyngraph(
        "sssp", g, src=0, updates=[(1, 5, 3), (2, 7, 1), (0, 9, 2)],
        queries=[0, 5, 9], ring_capacity=64, egress_depth=32,
        max_rounds=512, **kw)
    keep = ("edges", "relaxations", "updates_applied", "spare_in_use",
            "dropped", "queries", "query_values", "query_results",
            "executed", "pending", "injected", "tenants")
    return {"res": np.asarray(res), "graph_updates": list(g.updates),
            "info": {k: info[k] for k in keep},
            "futs": _futs(info["update_futures"] + info["query_futures"]),
            "egress": info["serve_stats"]["egress"],
            "splice": np.asarray(
                info["splice_trace"]["rings"][0]["records"])}


JAX_SCENARIOS = {"firehose": firehose, "lanes": lanes,
                 "expiry": expiry_quarantine, "abort": abort,
                 "quiesce": quiesce_resume, "fh_quiesce": firehose_quiesce,
                 "serve": serve}


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX scenario, run at most once per module (and per worker:
    each test asks only for the one it compares with)."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = JAX_SCENARIOS[name](JAX)
        return done[name]

    return get


def _eq(a, b, path="out"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _eq(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert np.array_equal(a, b), (path, np.argwhere(a != b)[:8])
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------- device half


def test_firehose_rows_found_by_the_in_kernel_poll(jax_runs):
    got = firehose(TORCH)
    _eq(got, jax_runs("firehose"))
    assert got["iv"][0] == 55 and got["iv"][8] == 144
    written, dropped, recs = got["trace"]
    assert dropped > 0  # the ring wrapped
    assert written == dropped + len(recs)


def test_three_lanes_park_and_flush_with_telemetry(jax_runs):
    got = lanes(TORCH)
    _eq(got, jax_runs("lanes"))
    vals = [v for _, v in got["futs"]]
    want = [10 * (1 + i % 4) + 10 * (5 + i % 3) for _ in range(3)
            for i in range(12)]
    assert vals == want
    assert got["egress"]["resolved"] == 36 and got["cons"]["ok"]
    # Retirements parked in the depth-4 mailbox and flushed, FIFO.
    recs = got["trace"][2]
    assert got["tele"][0, 0] == got["rounds"] > 0
    assert got["tele"][1:].sum() == 36  # the histogram mass
    assert set(np.unique(recs[:, 0])) >= {tinj.TR_TENANT, tinj.TR_INJECT}


def test_expiry_and_quarantine(jax_runs):
    got = expiry_quarantine(TORCH)
    _eq(got, jax_runs("expiry"))
    ten = got["tenants"]
    assert ten["silver"]["quarantined"] == 1 and ten["silver"]["dropped"] > 0
    assert ten["bronze"]["expired"] > 0
    states = {s for s, _ in got["futs"]}
    assert {"RESULT", "POISONED", "EXPIRED"} <= states
    assert got["cons"]["ok"]


def test_abort_poisons_outstanding_futures(jax_runs):
    got = abort(TORCH)
    _eq(got, jax_runs("abort"))
    assert got["stats"]["aborts"] == 1
    assert {s for s, _ in got["futs"]} == {"RESULT", "POISONED"}


def test_quiesce_and_resume_same_and_fresh_object(jax_runs):
    got, _ = quiesce_resume(TORCH)
    want, _ = jax_runs("quiesce")
    _eq(got, want)
    assert got["tokens"] > 0
    assert "etok" in got["cut"] and "tele" in got["cut"]
    assert got["fresh"][0][16] == got["same"][0][16] == 10 + 50


def test_firehose_quiesce_residue_and_resume(jax_runs):
    got, _ = firehose_quiesce(TORCH)
    want, _ = jax_runs("fh_quiesce")
    _eq(got, want)
    assert got["cut"]["ring_rows"].shape[1] == tdesc.RING_ROW
    assert got["iv"][0] == 55 and got["iv"][8] == 144


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_bundles_cross_both_ways(jax_runs, tmp_path, direction):
    """A lane stream quiesced in one package, bundled to disk, restored
    in the other on a fresh stream, equals the first package's own
    restore."""
    src, dst = (JAX, TORCH) if direction == "jax_to_port" else (TORCH, JAX)
    if src is JAX:
        _, (sm, cut) = jax_runs("quiesce")
    else:
        _, (sm, cut) = quiesce_resume(TORCH)
    src.ck.snapshot_stream(sm, cut).save(str(tmp_path / "b"))
    outs = []
    for P in (src, dst):
        sm2, _, _ = _lanes_stream(P, Clock(), checkpoint=True, per=0)
        sm2.close()
        out, fin = P.ck.restore_stream(str(tmp_path / "b"), sm2,
                                       quantum=QUANTUM,
                                       max_rounds=MAX_ROUNDS)
        outs.append((np.asarray(out), fin["tenants"],
                     np.asarray(fin["telemetry"]["tele"])))
    _eq(outs[0], outs[1])
    # The roster guard: a reordered roster is refused.
    clock = Clock()
    bad = dst.inj.StreamingMegakernel(
        dst.fib_mk(checkpoint=True), ring_capacity=96,
        tenants=dst.ten.TenantTable(
            [dst.ten.TenantSpec(t) for t in ("silver", "gold", "bronze")],
            32, clock=clock, egress=dst.eg.EgressSpec(depth=4)),
        telemetry=True)
    with pytest.raises(dst.ck.CheckpointError, match="roster"):
        dst.ck.restore_stream(str(tmp_path / "b"), bad)


def test_serve_dyngraph_sssp(jax_runs):
    got = serve(TORCH)
    _eq(got, jax_runs("serve"))
    g = _serve_graph(tdg)
    for up in got["graph_updates"]:
        g.add_update(*up)
    assert np.array_equal(got["res"], tdg.host_dyngraph("sssp", g, src=0))
    assert got["info"]["query_results"] == got["info"]["query_values"]
    assert {s for s, _ in got["futs"]} == {"RESULT"}


def test_refusals():
    mk = tw.make_fib_megakernel(batch_width=4, device="cpu")
    sm = tinj.StreamingMegakernel(mk)
    sm.close()
    with pytest.raises(ValueError, match="scalar tier"):
        sm.run_stream(_fib_builder(TORCH, 5))
    with pytest.raises(ValueError, match="checkpoint=True"):
        tinj.StreamingMegakernel(TORCH.fib_mk()).quiesce(3)
    with pytest.raises(ValueError, match="egress"):
        tinj.StreamingMegakernel(TORCH.fib_mk(), tenants=2, telemetry=True)
    with pytest.raises(ValueError, match="dep_count"):
        tinj.StreamingMegakernel(TORCH.fib_mk()).inject(0, dep_count=1)
    closed = tinj.StreamingMegakernel(TORCH.fib_mk(), ring_capacity=8)
    closed.close()
    with pytest.raises(RuntimeError, match="closed"):
        closed.inject(0, args=[1])
    # The entry points default to the card and raise without one.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tinj.StreamingMegakernel(tw.make_fib_megakernel())
        with pytest.raises(RuntimeError, match="cuda"):
            tdg.serve_dyngraph("sssp", _serve_graph(tdg))
