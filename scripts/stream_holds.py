"""The streams the streaming front door's kernel is held to its plain
version on, word for word: ``chip_smoke.py``'s ``stream`` phase and the
card tests of ``tests/test_torch_cuda.py`` run each case on the card
(``device="cuda"``, the ``stream_kernel`` launches) and on the CPU (the
plain stream, ``_PlainStream``) and compare everything each returns.

    from stream_holds import CASES, run_case, compare
    compare(run_case("lanes_park", "cuda"), run_case("lanes_park", "cpu"))

Each case returns a dict of plain values and numpy arrays: the returned
values, the info dict less its wall-clock fields, the futures' states
and values, the echoed control block of every entry (ctl, counts, tctl,
mailbox, park ring, ectl, telemetry; ``StreamingMegakernel.entry_log``),
the final state (task table, ready ring, counts, values, data, etok,
tlat) and the decoded trace records. Cases (``trace`` adds the flight
recorder; every case runs traced and untraced):

- ``fib_firehose``: a fib(10) tree, eight fib seeds injected before the
  run and found mid-entry by the in-kernel poll (quantum 16).
- ``lanes_park``: three lanes at 4:2:1 over a running fib(8) tree, 12 SUM
  requests a lane, egress depth 4 (rows park and flush), telemetry on.
- ``expiry_quarantine``: as lanes_park, the bronze lane's deadlines
  passing while its rows wait on the ring (dropped by the device poll)
  and the silver lane quarantined after the first entry (swept).
- ``abort``: as lanes_park, aborted after two entries: outstanding
  futures poisoned.
- ``quiesce_restore``: as lanes_park on a checkpoint build, quiesced at
  60 executed tasks, bundled to a temporary directory
  (``snapshot_stream``) and restored on a fresh stream
  (``restore_stream``), futures re-attached.
- ``serve7``: ``serve_dyngraph("sssp")`` on bench.py --graph dyngraph's
  configuration (rmat_edges(7, efactor=8, seed=7), spare_blocks 2, 24
  updates and 4 queries drawn as bench.py draws them): instance 5.
- ``frontier9``: a static SSSP table on bench.py --graph's graph
  (rmat_edges(9, efactor=8, seed=7)) driven as a stream: instance 4.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hclib_tpu_torch.device import dyngraph as td  # noqa: E402
from hclib_tpu_torch.device import frontier as tf  # noqa: E402
from hclib_tpu_torch.device import workloads as tw  # noqa: E402
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder  # noqa: E402
from hclib_tpu_torch.device.egress import EgressSpec  # noqa: E402
from hclib_tpu_torch.device.inject import StreamingMegakernel  # noqa: E402
from hclib_tpu_torch.device.tenants import TenantSpec, TenantTable  # noqa
from hclib_tpu_torch.runtime import checkpoint as tck  # noqa: E402

QUANTUM, MAX_ROUNDS = 16, 6
CAP = 384
NV = 4 * CAP + 128  # fib's row-owned value blocks plus 128 host slots
WALL = ("quiesce_latency_s", "abort_latency_s", "last_quiesce_latency_s",
        "ns_per_round", "epoch", "t0_ns", "t1_ns")


class Clock:
    """A deterministic table clock: ``step`` seconds a call."""

    def __init__(self, step: float = 0.0) -> None:
        self.t, self.step = 100.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def on_pump(table, actions) -> None:
    """Run ``actions[k]`` before the table's k-th pump (one a entry)."""
    n, pump = [0], table.pump

    def hooked(ring):
        n[0] += 1
        if n[0] in actions:
            actions[n[0]]()
        return pump(ring)

    table.pump = hooked


def clean(x):
    """Plain values and numpy arrays, wall-clock fields dropped."""
    if isinstance(x, dict):
        return {k: clean(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return [clean(v) for v in x]
    if hasattr(x, "state") and hasattr(x, "token"):  # a Future
        return (x.state, x.value if x.state == "RESULT" else None)
    if hasattr(x, "numpy") and hasattr(x, "cpu"):  # a tensor
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def _fib_builder(n):
    b = TaskGraphBuilder()
    b.add(tw.FIB, args=[n], out=0)
    b.reserve_values(128)  # host slots below the row-owned blocks
    return b


def _lanes(device, trace, clock, checkpoint=False, per=12, deadline=None):
    table = TenantTable([TenantSpec("gold", weight=4),
                         TenantSpec("silver", weight=2),
                         TenantSpec("bronze", weight=1)], 32, clock=clock,
                        egress=EgressSpec(depth=4))
    mk = tw.make_fib_megakernel(CAP, num_values=NV, trace=trace,
                                checkpoint=checkpoint, device=device)
    sm = StreamingMegakernel(mk, ring_capacity=96, tenants=table,
                             telemetry=True)
    sm.entry_log = []
    futs = []
    for lane, tid in enumerate(("gold", "silver", "bronze")):
        for i in range(per):
            dl = deadline if deadline is not None and lane == 2 else None
            adm = sm.submit(tid, tw.SUM, args=[1 + i % 4, 5 + i % 3],
                            out=16 + lane * per + i, deadline_s=dl)
            assert adm.accepted, adm
            futs.append(adm.future)
    iv = np.zeros(NV, np.int32)
    iv[1:8] = [10, 20, 30, 40, 50, 60, 70]
    return sm, futs, iv


def _out(sm, iv, info, futs=()):
    return {"iv": iv, "info": info, "futs": list(futs),
            "entries": sm.entry_log, "final": sm.final_state,
            "stats": sm.stats_dict(), "spans": sm.telemetry_spans()}


def fib_firehose(device, trace):
    mk = tw.make_fib_megakernel(CAP, num_values=NV, trace=trace,
                                device=device)
    sm = StreamingMegakernel(mk, ring_capacity=32)
    sm.entry_log = []
    for i, n in enumerate([5, 7, 8, 9, 11, 6, 4, 12]):
        sm.inject(tw.FIB, args=[n], out=1 + i)
    sm.close()
    iv, info = sm.run_stream(_fib_builder(10), quantum=QUANTUM,
                             max_rounds=MAX_ROUNDS)
    return _out(sm, iv, info)


def lanes_park(device, trace):
    sm, futs, iv = _lanes(device, trace, Clock())
    sm.close()
    out, info = sm.run_stream(_fib_builder(8), ivalues=iv, quantum=QUANTUM,
                              max_rounds=MAX_ROUNDS)
    return _out(sm, out, info, futs)


def expiry_quarantine(device, trace):
    sm, futs, iv = _lanes(device, trace, Clock(step=0.05), deadline=0.5)
    sm.close()
    on_pump(sm.tenants, {2: lambda: sm.tenants.quarantine("silver", "t")})
    out, info = sm.run_stream(_fib_builder(8), ivalues=iv, quantum=QUANTUM,
                              max_rounds=2)
    return _out(sm, out, info, futs)


def abort(device, trace):
    from hclib_tpu_torch.runtime.resilience import CancelledError

    sm, futs, iv = _lanes(device, trace, Clock())
    sm.close()
    on_pump(sm.tenants, {3: lambda: sm.abort("client disconnect")})
    try:
        sm.run_stream(_fib_builder(8), ivalues=iv, quantum=QUANTUM,
                      max_rounds=MAX_ROUNDS)
    except CancelledError as e:
        return _out(sm, None, {"raised": str(e)}, futs)
    raise AssertionError("abort: the stream did not raise CancelledError")


def quiesce_restore(device, trace):
    sm, futs, iv = _lanes(device, trace, Clock(), checkpoint=True)
    sm.quiesce(after_executed=60)
    _, cut = sm.run_stream(_fib_builder(8), ivalues=iv, quantum=QUANTUM,
                           max_rounds=MAX_ROUNDS)
    assert cut["quiesced"], cut
    d = tempfile.mkdtemp(prefix="hclib-stream-hold-")
    try:
        tck.snapshot_stream(sm, cut).save(os.path.join(d, "b"))
        sm2, _, _ = _lanes(device, trace, Clock(), checkpoint=True, per=0)
        sm2.close()
        out, info = tck.restore_stream(os.path.join(d, "b"), sm2,
                                       quantum=QUANTUM,
                                       max_rounds=MAX_ROUNDS)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    back = [sm2.tenants.reattach(f.resume_token).result(timeout=5)
            for f in futs if f.state == "PREEMPTED"]
    return {"cut": cut, "cut_entries": sm.entry_log,
            **_out(sm2, out, info, futs), "reattached": back}


def draw_updates(g, nup, nq):
    """bench.py --graph dyngraph's stream: default_rng(11), uniform
    endpoints, weights 1-7, then the queries."""
    rng = np.random.default_rng(11)
    ups = [(int(u), int(v), int(w)) for u, v, w in zip(
        rng.integers(0, g.n, nup), rng.integers(0, g.n, nup),
        rng.integers(1, 8, nup))]
    return ups, [int(q) for q in rng.integers(0, g.n, nq)]


def serve7(device, trace):
    g = td.DynGraph(*tw.rmat_edges(7, efactor=8, seed=7), spare_blocks=2,
                    upd_cap=24)
    ups, qs = draw_updates(g, 24, 4)
    log = []
    res, info = td.serve_dyngraph("sssp", g, 0, updates=ups, queries=qs,
                                  capacity=1024, trace=trace,
                                  ring_capacity=64, egress_depth=64,
                                  device=device, entry_log=log)
    ref = td.host_dyngraph("sssp", g, 0)
    assert np.array_equal(res, ref), "serve7 differs from host_dyngraph"
    assert info["dropped"] == 0 and info["updates_applied"] == 24
    assert info["query_results"] == info["query_values"]
    futs = info.pop("update_futures") + info.pop("query_futures")
    assert all(f.state == "RESULT" for f in futs)
    return {"res": res, "info": info, "futs": futs, "entries": log}


def frontier9(device, trace):
    g = tf.Graph(*tw.rmat_edges(9, efactor=8, seed=7))
    mk = tf.make_frontier_megakernel(tf.sssp_kernel(), g, width=0,
                                     capacity=4096, trace=trace,
                                     device=device)
    b, iv, data = tf.frontier_state("sssp", g, mk, 0, m0=4096, reps=64)
    sm = StreamingMegakernel(mk, ring_capacity=8)
    sm.entry_log = []
    sm.close()
    out, info = sm.run_stream(b, ivalues=iv, data=data, quantum=256,
                              max_rounds=8)
    st = g.st_base
    assert np.array_equal(np.asarray(out[st:st + g.n]), tf.host_sssp(g))
    return _out(sm, out, info)


CASES = {f.__name__: f for f in (fib_firehose, lanes_park,
                                 expiry_quarantine, abort, quiesce_restore,
                                 serve7, frontier9)}


def run_case(name: str, device, trace=None) -> dict:
    return clean(CASES[name](device, trace))


def compare(got, want, path="out") -> float:
    """Raise unless ``got`` equals ``want`` word for word; returns the
    largest absolute difference (0)."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(
                f"{path}: keys {sorted(set(got) ^ set(want))}")
        return max([compare(got[k], want[k], f"{path}.{k}") for k in want],
                   default=0.0)
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} != {len(want)} items")
        return max([compare(a, b, f"{path}[{i}]")
                    for i, (a, b) in enumerate(zip(got, want))], default=0.0)
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        a, b = np.asarray(got), np.asarray(want)
        if a.shape != b.shape or not np.array_equal(a, b):
            where = np.argwhere(a != b)[:4] if a.shape == b.shape else None
            raise AssertionError(f"{path}: differs (shapes {a.shape} "
                                 f"{b.shape}; first at {where})")
        return 0.0
    if got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")
    return 0.0
