"""The port's graph frontier tier against the JAX package's: BFS, SSSP and
push PageRank on the JAX tests' R-MAT graph (scale 5, efactor 6, seed
3), the scalar arm and the width-4 arm with the edge-slab prefetch and
the default lane-age trigger. The raw outputs of ``jax.jit(
mk._build_raw(fuel))`` in interpret mode and the port's
``Megakernel.launch`` on the CPU (its plain core), fed identical state,
must agree word for word across the task table, ready ring, counts,
value slots and all 12 tier counters; and every result equals its host
reference (``host_bfs``, ``host_sssp``, ``host_pagerank_push``)."""

import jax
import numpy as np
import pytest

from hclib_tpu.device import frontier as jf
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import frontier as tf
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder

FUEL = 1 << 22
N, SRC, DST, W = jw.rmat_edges(5, efactor=6, seed=3)
JG, TG = jf.Graph(N, SRC, DST, W), tf.Graph(N, SRC, DST, W)
M0, REPS = 1 << 12, 64
PARTS = ["tasks", "ready", "counts", "ivalues", "tstats"]
# (kind, width) -> capacity: JAX's tests' shapes (PageRank at 768 rows).
ARMS = {(k, w): 768 if k == "pagerank" else 512
        for k in ("bfs", "sssp", "pagerank") for w in (0, 4)}


@pytest.fixture(autouse=True)
def _reference_without_hclint(monkeypatch):
    """The JAX reference megakernels are built without their build-time
    verifier (a host analysis that cannot change the program)."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")
    for var in ("HCLIB_TPU_LANE_MAX_AGE", "HCLIB_TPU_PRIORITY_BUCKETS"):
        monkeypatch.delenv(var, raising=False)


def _staged(pkg, graph, builder_cls, mk, kind):
    """run_frontier's inputs: the seeded builder finalized, the preset
    value row (value_alloc widened as Megakernel.run widens it) and the
    edge data."""
    fk = pkg._KINDS[kind](reps=REPS) if kind == "pagerank" \
        else pkg._KINDS[kind]()
    st = graph.st_base
    iv = graph.preset_values(mk.num_values, fk.state0)
    if kind == "pagerank":
        iv[st:st + graph.n] = pkg._pr_seed_rank(graph, M0, REPS)
    else:
        iv[st] = 0
    b = builder_cls()
    b.reserve_values(graph.num_value_slots)
    pkg.seed_frontier(b, graph, kind, m0=M0, reps=REPS)
    tasks, succ, ring, counts = b.finalize(capacity=mk.capacity,
                                           succ_capacity=mk.succ_capacity)
    counts = counts.copy()
    nz = np.flatnonzero(iv)
    counts[4] = max(counts[4], int(nz[-1]) + 1)
    data = [graph.indices] + ([graph.weights] if kind == "sssp" else [])
    return [tasks, succ, ring, counts, iv], data


_PAIRS: dict = {}


def _pair(arm):
    """(JAX raw outputs, port raw outputs, JAX mk, port mk) of ``arm``,
    computed once a process: only this arm's JAX raw program is compiled,
    so a test worker builds just the arms it runs."""
    if arm not in _PAIRS:
        kind, width = arm
        kw = dict(width=width, capacity=ARMS[arm])
        reps = {"reps": REPS} if kind == "pagerank" else {}
        mj = jf.make_frontier_megakernel(jf._KINDS[kind](**reps), JG,
                                         interpret=True, **kw)
        mt = tf.make_frontier_megakernel(tf._KINDS[kind](**reps), TG,
                                         device="cpu", **kw)
        sj, dj = _staged(jf, JG, JBuilder, mj, kind)
        stt, dt = _staged(tf, TG, TBuilder, mt, kind)
        for x, y in zip(sj + dj, stt + dt):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        with jax.default_device(jax.devices("cpu")[0]):
            outs = [np.asarray(o)
                    for o in jax.jit(mj._build_raw(FUEL))(*sj, *dj)]
        jax_out = outs[:4] + ([outs[-1]] if mj.batch_specs else [])
        s = state.from_numpy(*stt, data=dict(zip(mt.data_specs, dt)),
                             device="cpu")
        mt.launch(s, FUEL)
        tasks, _, ready, counts, ivalues, _ = state.to_numpy(s)
        port_out = [tasks, ready, counts, ivalues] + (
            [s["tstats"].numpy()] if mt.batch_specs else [])
        _PAIRS[arm] = (jax_out, port_out, mj, mt)
    return _PAIRS[arm]


@pytest.fixture(params=sorted(ARMS), ids=lambda a: f"{a[0]}_w{a[1]}")
def arm(request):
    return request.param


def test_rmat_and_blocked_csr_layout():
    """rmat_edges, Graph, preset_values and seed_frontier equal the JAX
    package's array for array (tests/test_frontier.py:90's checks)."""
    for x, y in zip(tw.rmat_edges(5, efactor=6, seed=3), (N, SRC, DST, W)):
        assert np.array_equal(x, y)
    for x, y in zip(tw.rmat_edges(9, efactor=8, seed=7),
                    jw.rmat_edges(9, efactor=8, seed=7)):
        assert np.array_equal(x, y)
    for f in ("deg", "blk_count", "blk_start", "indices", "weights"):
        assert np.array_equal(getattr(TG, f), getattr(JG, f)), f
    assert (TG.n, TG.m, TG.nblocks, TG.st_base, TG.num_value_slots) == (
        JG.n, JG.m, JG.nblocks, JG.st_base, JG.num_value_slots)
    assert all(np.array_equal(a, b) for a, b in zip(TG.adj, JG.adj))
    assert all(np.array_equal(a, b) for a, b in zip(TG.adj_w, JG.adj_w))
    for state0 in (tf.INF, 0):
        assert np.array_equal(TG.preset_values(300, state0),
                              JG.preset_values(300, state0))
    for kind in ("bfs", "sssp", "pagerank"):
        assert tf.seed_frontier(None, TG, kind, m0=M0) == jf.seed_frontier(
            None, JG, kind, m0=M0)
    assert np.array_equal(tf._pr_seed_rank(TG, M0, REPS),
                          jf._pr_seed_rank(JG, M0, REPS))
    with pytest.raises(ValueError, match="out of range"):
        tf.Graph(4, [0, 9], [1, 2])
    with pytest.raises(ValueError, match="num_values"):
        TG.preset_values(4, 0)


def test_raw_state_and_results_like_jax(arm):
    """The whole raw state word for word (tasks, ring, counts, value slots
    and, batched, all 12 tier counters), the decoded tiers (age_fires and
    max_starved_age included) equal to JAX's, and the result equal to the
    host reference."""
    jax_out, port_out, mj, mt = _pair(arm)
    kind, width = arm
    assert len(jax_out) == len(port_out) == (5 if width else 4)
    for part, x, y in zip(PARTS, jax_out, port_out):
        assert x.dtype == y.dtype == np.int32, part
        assert x.shape == y.shape and np.array_equal(x, y), part
    if width:
        assert mt.lane_max_age == mj.lane_max_age == 4 * width
        tiers = mt.decode_tier_stats(port_out[4])
        assert tiers == mj.decode_tier_stats(jax_out[4])
        assert tiers["scalar_tasks"] == 0
        assert tiers["batch_tasks"] == port_out[2][5]
        assert tiers["prefetch_hits"] > 0
    else:
        assert mt.lane_max_age == mj.lane_max_age == 0
    st = TG.st_base
    got = port_out[3][st:st + TG.n]
    if kind == "bfs":
        assert np.array_equal(got, tf.host_bfs(TG, 0))
    elif kind == "sssp":
        assert np.array_equal(got, tf.host_sssp(TG, 0))
    else:
        twin, deliveries = tf.host_pagerank_push(TG, m0=M0, reps=REPS)
        assert np.array_equal(got.astype(np.int64), twin)
        assert port_out[3][tf.V_RELAX] == deliveries


@pytest.mark.parametrize("kind", ["bfs", "sssp", "pagerank"])
def test_run_frontier_entry_point(kind):
    """run_frontier on the CPU: the host reference, with edges and
    relaxations from the value slots."""
    kw = {"m0": M0, "capacity": 768} if kind == "pagerank" else {}
    r, info = tf.run_frontier(kind, TG, 0, width=4, device="cpu", **kw)
    if kind == "pagerank":
        want, deliveries = tf.host_pagerank_push(TG, m0=M0, reps=REPS)
        assert r.dtype == np.int64 and info["relaxations"] == deliveries
        assert r.sum() == TG.n * M0
    else:
        want = tf.host_bfs(TG) if kind == "bfs" else tf.host_sssp(TG)
        assert r.dtype == np.int32
    assert np.array_equal(r, want)
    assert info["edges"] > 0 and info["tiers"]["batch_tasks"] == \
        info["executed"]


def test_expand_rounds_plain_equals_scalar_bodies():
    """The standalone entry's plain version: rows relaxed in row order,
    spawns pushed to the ring, nothing popped; width 4 and scalar tables
    leave the same state."""
    outs = []
    for width in (0, 4):
        mk = tf.make_frontier_megakernel(tf.sssp_kernel(), TG, width=width,
                                         device="cpu")
        (tasks, succ, ring, counts, iv), data = _staged(
            tf, TG, TBuilder, mk, "sssp")
        s = state.from_numpy(tasks, succ, ring, counts, iv,
                             data=dict(zip(mk.data_specs, data)),
                             device="cpu")
        tf.expand_rounds(mk, s, range(int(counts[2])))
        outs.append(state.to_numpy(s)[:5])
    for x, y in zip(*outs):
        assert np.array_equal(x, y)
    counts = outs[0][3]
    assert counts[1] > counts[0] and counts[5] == 0  # pushed, not run
