"""The port's flight recorder (hclib_tpu_torch/device/tracebuf.py and the
recorder the plain core and ``mk_kernel`` share) against the JAX
package's, word for word, in interpret mode.

Traced runs: fib(9) on the scalar table with a ring smaller than its
record count (the overflow arm); the batched forasync stencil with the
prefetch, quiesced with a prefetch in flight so the drain and the spill
are recorded (its exported state held to JAX's too); BFS on the
JAX tests' ``rmat_edges(5, efactor=6, seed=3)`` graph at width 4 with
``lane_max_age=1`` and 2 priority buckets (age and bucket fire records,
and the gauges they feed). Each holds the decoded records, ``written``,
``dropped``, the tier counters and gauges to JAX's, and reconciles the
records with the counters (tests/test_tracebuf.py's identities). Then the
host decoders against JAX's on the same rows, the JSON round trip through
JAX's ``trace_from_jsonable``, and trace-off runs equal to traced ones.
The UTS traced arm shares its build with the quiesce arms
(tests/test_torch_checkpoint.py)."""

import json

import numpy as np
import pytest

from hclib_tpu.device import forasync_tier as jfa
from hclib_tpu.device import frontier as jf
from hclib_tpu.device import tracebuf as jtb
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import forasync_tier as tfa
from hclib_tpu_torch.device import frontier as tf
from hclib_tpu_torch.device import tracebuf as ttb
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder

HOST_KEYS = ("build_s", "cache_lookup_s")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")
    for var in ("HCLIB_TPU_TRACE", "HCLIB_TPU_CHECKPOINT",
                "HCLIB_TPU_QUIESCE_STRIDE", "HCLIB_TPU_LANE_MAX_AGE",
                "HCLIB_TPU_PRIORITY_BUCKETS"):
        monkeypatch.delenv(var, raising=False)


def same_trace(ji, ti):
    """The two runs' decoded rings agree word for word (and the port's
    epoch brackets its launch)."""
    jr, tr = ji["trace"]["rings"][0], ti["trace"]["rings"][0]
    for k in ("written", "dropped", "capacity"):
        assert jr[k] == tr[k], k
    assert tr["records"].dtype == np.int64
    assert np.array_equal(jr["records"], tr["records"])
    ep = ti["trace"]["epoch"]
    assert ep["t1_ns"] >= ep["t0_ns"] > 0
    return tr


def same_tiers(ji, ti):
    jt = {k: v for k, v in ji["tiers"].items() if k not in HOST_KEYS}
    assert jt == ti["tiers"]
    return ti["tiers"]


def reconcile(trace, tiers):
    """The record counts against the tier counters, exactly."""
    bat = ttb.records_of(trace, ttb.TR_FIRE_BATCH)
    assert len(bat) == tiers["batch_rounds"]
    assert int((bat[:, 2] & 0xFFFF).sum()) == tiers["batch_tasks"]
    assert int(bat[:, 3].sum()) == tiers["prefetch_hits"]
    assert len(ttb.records_of(trace, ttb.TR_FIRE_SCALAR)) == \
        tiers["scalar_tasks"]
    assert len(ttb.records_of(trace, ttb.TR_FIRE_AGE)) == tiers["age_fires"]
    spills = ttb.records_of(trace, ttb.TR_SPILL)
    assert int(spills[:, 3].sum()) == tiers["spilled"]


def test_fib_ring_overflow_matches_jax():
    """fib(9) on the scalar table into a 32-record ring: the wrap keeps
    the last 32 records, the closing round_end among them."""
    jmk = jw.make_fib_megakernel(256, interpret=True, trace=32)
    tmk = tw.make_fib_megakernel(256, trace=32, device="cpu")
    jb, tb = JBuilder(), TBuilder()
    jb.add(jw.FIB, args=[9], out=0)
    tb.add(tw.FIB, args=[9], out=0)
    ji_v, _, ji = jmk.run(jb)
    ti_v, _, ti = tmk.run(tb)
    assert int(ti_v[0]) == int(ji_v[0]) == 34
    ring = same_trace(ji, ti)
    assert ring["dropped"] > 0
    assert ring["written"] == ring["dropped"] + ring["capacity"]
    assert int(ring["records"][-1, 0]) == ttb.TR_ROUND_END
    assert int(ring["records"][-1, 2]) == ti["executed"]
    assert ttb.summarize(ti["trace"]) == jtb.summarize(ji["trace"])
    # The port's JSON form is what JAX's loader (tools/timeline.py
    # --trace) reads.
    back = jtb.trace_from_jsonable(json.loads(json.dumps(
        ttb.trace_to_jsonable(ti["trace"]))))
    assert back["epoch"] == ti["trace"]["epoch"]
    assert np.array_equal(back["rings"][0]["records"], ring["records"])
    # Tracing off: the same run, no ring.
    off_v, _, off = tw.make_fib_megakernel(256, device="cpu").run(tb)
    assert "trace" not in off and int(off_v[0]) == 34
    assert {k: v for k, v in ti.items() if k != "trace"} == off


def test_stencil_prefetch_quiesced_matches_jax():
    """The batched stencil (16 tiles, width 4, prefetch) quiesced after
    its first batch, with the next batch's prefetch in flight: the
    announce, its drain at the cut and the spill of the unrun tiles are
    recorded, and the exported state (both data buffers included) is
    JAX's."""
    jtk, bounds, tile = jw.stencil_loop(32, 512)
    ttk = tw.stencil_loop(32, 512)[0]
    gin, gout = tw.stencil_data(32, 512, seed=3)
    out = {}
    for pkg, tk, B, kw in (
            (jfa, jtk, JBuilder, {"interpret": True}),
            (tfa, ttk, TBuilder, {"device": "cpu"})):
        mk = pkg.make_forasync_megakernel(tk, width=4, capacity=64,
                                          trace=256, checkpoint=True, **kw)
        b = B()
        pkg.seed_tiles(b, bounds, tile)
        out[pkg] = mk.run(b, data={"gin": gin, "gout": gout.copy()},
                          quiesce=4)[2]
    ji, ti = out[jfa], out[tfa]
    assert ti["quiesce"] == ji["quiesce"] == {"executed_at": 4}
    ring = same_trace(ji, ti)
    tiers = same_tiers(ji, ti)
    tags = set(ring["records"][:, 0].tolist())
    assert {ttb.TR_PREFETCH_ISSUE, ttb.TR_PREFETCH_DRAIN, ttb.TR_SPILL,
            ttb.TR_QUIESCE, ttb.TR_CKPT} <= tags
    reconcile(ti["trace"], tiers)
    drn = ttb.records_of(ti["trace"], ttb.TR_PREFETCH_DRAIN)
    assert drn[:, 3].tolist() == [4] and tiers["spilled"] == 12
    for k in ("tasks", "ready", "counts", "ivalues"):
        assert np.array_equal(np.asarray(ji["state"][k]), ti["state"][k]), k
    for k in ("gin", "gout"):
        assert np.array_equal(np.asarray(ji["state"]["data"][k]),
                              ti["state"]["data"][k]), k


def test_bfs_age_and_bucket_fires_match_jax():
    """BFS at width 4 with lane_max_age=1 and 2 buckets: the fire
    reasons (TR_FIRE_AGE, TR_FIRE_BUCKET) and the partial-age and
    bucket-occupancy gauges equal JAX's."""
    n, src, dst, w = jw.rmat_edges(5, efactor=6, seed=3)
    kw = dict(width=4, trace=1024, lane_max_age=1, priority_buckets=2,
              capacity=256)
    jr, ji = jf.run_frontier("bfs", jf.Graph(n, src, dst, w), 0,
                             interpret=True, **kw)
    tr, ti = tf.run_frontier("bfs", tf.Graph(n, src, dst, w), 0,
                             device="cpu", **kw)
    assert np.array_equal(tr, jr)
    same_trace(ji, ti)
    tiers = same_tiers(ji, ti)
    assert tiers["age_fires"] > 0 and "bucket_occupancy" in tiers
    reconcile(ti["trace"], tiers)
    buckets = ttb.records_of(ti["trace"], ttb.TR_FIRE_BUCKET)
    assert len(buckets) == tiers["batch_rounds"]
    assert int((buckets[:, 2] >> 16 > 0).sum()) == tiers["bucket_fires"]
    assert tiers["bucket_occupancy"] == ttb.bucket_occupancy(
        ti["trace"], {0: 4}, 2)


def test_host_decoders_equal_jax():
    """decode_ring (wrapped and not), records_of, lane_partial_age,
    bucket_occupancy, summarize and host_trace_info on the same rows."""
    rng = np.random.default_rng(4)
    cap = 16
    for written in (0, 5, 16, 37):
        row = np.zeros(ttb.HDR + cap * ttb.TR_WORDS, np.int32)
        row[0] = written
        body = rng.integers(0, 1 << 18, (cap, 4)).astype(np.int32)
        body[:, 0] = rng.choice([ttb.TR_FIRE_BATCH, ttb.TR_FIRE_BUCKET,
                                 ttb.TR_SPILL], cap)
        body[:, 1] = np.sort(rng.integers(0, 40, cap))
        body[:, 2] = (rng.integers(0, 2, cap) << 16) | rng.integers(
            1, 5, cap)
        row[ttb.HDR:] = body.ravel()
        t = ttb.trace_info([row], 1, 2, cap)
        j = jtb.trace_info([row], 1, 2, cap)
        assert t["epoch"] == j["epoch"]
        for a, b in zip(t["rings"], j["rings"]):
            assert {k: v for k, v in a.items() if k != "records"} == {
                k: v for k, v in b.items() if k != "records"}
            assert np.array_equal(a["records"], b["records"])
        for tag in (ttb.TR_FIRE_BATCH, ttb.TR_SPILL):
            assert np.array_equal(ttb.records_of(t, tag),
                                  jtb.records_of(j, tag))
        widths = {0: 4, 1: 4}
        for gap in (1, 8):
            assert ttb.lane_partial_age(t, widths, max_gap=gap) == \
                jtb.lane_partial_age(j, widths, max_gap=gap)
        assert ttb.bucket_occupancy(t, widths, 2) == \
            jtb.bucket_occupancy(j, widths, 2)
        assert ttb.summarize(t) == jtb.summarize(j)
    recs = [[ttb.TR_CKPT, i, -(1 + ttb.CK_SAVE), i] for i in range(3)]
    h, hj = ttb.host_trace_info(recs, 5, 9), jtb.host_trace_info(recs, 5, 9)
    assert h["rings"][0]["written"] == hj["rings"][0]["written"] == 3
    assert np.array_equal(h["rings"][0]["records"], hj["rings"][0]["records"])
    assert (ttb.TAG_NAMES, ttb.CK_NAMES, ttb.SC_NAMES) == (
        jtb.TAG_NAMES, jtb.CK_NAMES, jtb.SC_NAMES)
    assert ttb.TraceRing.of(True).capacity == 2048
    assert ttb.TraceRing.of(None) is None and ttb.TraceRing.of(False) is None
    assert ttb.TraceRing.of(64).words == jtb.TraceRing(64).words
    with pytest.raises(ValueError, match=">= 1"):
        ttb.TraceRing(0)


def test_traced_batch_run_equals_untraced():
    """A traced, checkpoint-built run that never quiesces leaves every
    output as the plain build does (the recorder and poll observe only),
    and its records reconcile with the counters."""
    b = TBuilder()
    b.add(tw.FIB, args=[10], out=0)
    mk_on = tw.make_fib_megakernel(256, trace=4096, batch_width=4,
                                   checkpoint=True, quiesce_stride=3,
                                   device="cpu")
    mk_off = tw.make_fib_megakernel(256, batch_width=4, device="cpu")
    st_on, st_off = mk_on.state(b), mk_off.state(b)
    mk_on.launch(st_on)
    mk_off.launch(st_off)
    for k in ("tasks", "ready", "counts", "ivalues", "tstats"):
        assert np.array_equal(st_on[k].numpy(), st_off[k].numpy()), k
    qstat = st_on["qstat"].tolist()
    assert qstat[0] == 0 and qstat[2] > 0  # polled every round, no quiesce
    info = mk_on.run(b)[2]
    assert info["quiesced"] is False and "state" not in info
    assert info["trace"]["rings"][0]["dropped"] == 0
    reconcile(info["trace"], info["tiers"])
    rounds = ttb.records_of(info["trace"], ttb.TR_ROUND_END)
    assert int(rounds[0, 1]) == qstat[2] + 1  # begin, polled rounds, end
