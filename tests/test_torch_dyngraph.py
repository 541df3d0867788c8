"""The port's dynamic-graph tier against the JAX package's, on the JAX
tests' graph and update stream (``rmat_edges(5, efactor=4, seed=9)``,
spare_blocks 2, upd_cap 16, tests/test_dyngraph.py:40-48).

Word for word against ``jax.jit(mk._build_raw(fuel))`` in interpret mode
(task table, ready ring, counts, value slots, both data buffers the
splices write, and the 12 tier counters of a routed table): scalar SSSP
with three queries, BFS at width 4, BFS at width 4 with 2 priority
buckets, and the spare-exhaustion graph (its run raises on the overflow
flag, and the state before the raise is JAX's). Then the layout, the
build variables, PageRank's conserved mass, the incremental host twin
under permuted orders, the ``const`` priority rule and the refusals."""

import jax
import numpy as np
import pytest
import torch

from hclib_tpu.device import dyngraph as jd
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import dyngraph as td
from hclib_tpu_torch.device import frontier as tf
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder

FUEL = 1 << 22
N, SRC, DST, W = jw.rmat_edges(5, efactor=4, seed=9)
UPS = [(1, 5, 3), (2, 7, 1), (0, 9, 2), (4, 3, 6)]
M0, REPS = 1 << 12, 64
# The spare-exhaustion graph (tests/test_dyngraph.py:174-200): vertex 0's
# single block is full and spare_blocks is 0, so its insert drops.
X_N = 8
X_SRC = np.concatenate([np.zeros(tf.EBLOCK, np.int64), [1]])
X_DST = np.concatenate([1 + np.arange(tf.EBLOCK) % (X_N - 1),
                        [2]]).astype(np.int64)
X_UPS = [(0, 7, 1), (1, 3, 1)]
# On the same graph with one spare block a vertex: vertex 0's inserts fill
# a fresh spare row (written whole), then its lanes, then drop.
S_UPS = [(0, 1 + i % 7, 1 + i % 3) for i in range(130)] + [(1, 3, 1)]
# name -> (kind, build kwargs, graph kwargs, updates, queries); the graph
# is the JAX tests' unless the case names the exhaustion graph.
ARMS = {
    "sssp_w0_queries": ("sssp", {"width": 0}, {}, UPS, [0, 5, 9]),
    "bfs_w4": ("bfs", {"width": 4}, {}, UPS, []),
    "bfs_w4_b2": ("bfs", {"width": 4, "priority_buckets": 2,
                          "update_priority": 0}, {}, UPS, []),
    "exhaustion_w0": ("bfs", {"width": 0}, {"exhaust": True}, X_UPS, []),
    "spares_sssp_w0": ("sssp", {"width": 0}, {"spares": True}, S_UPS, [0]),
    "spares_sssp_w0_reps2": ("sssp", {"width": 0}, {"spares": True}, S_UPS,
                             [0]),
}
# reps > 1 re-stages the task table, ring, counts and value slots but not
# the data buffers, in JAX (aliased HBM) as in the port: rep 2 re-applies
# every splice over rep 1's rows.
REPS_OF = {"spares_sssp_w0_reps2": 2}
PARTS = ["tasks", "ready", "counts", "ivalues", "data.indices",
         "data.weights", "tstats"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """The JAX reference is built without its build-time verifier; no
    policy or dyngraph variable leaks in from outside."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")
    for var in ("HCLIB_TPU_LANE_MAX_AGE", "HCLIB_TPU_PRIORITY_BUCKETS",
                "HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS",
                "HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY"):
        monkeypatch.delenv(var, raising=False)


def _graph(pkg, exhaust=False, spares=False):
    if exhaust or spares:
        return pkg.DynGraph(X_N, X_SRC, X_DST, np.ones(len(X_SRC), np.int64),
                            spare_blocks=int(spares), upd_cap=4 + 140 * spares)
    return pkg.DynGraph(N, SRC, DST, W, spare_blocks=2, upd_cap=16)


def _staged(pkg, B, graph, mk, kind, queries):
    """run_dyngraph's inputs: the seeded builder (seeds, updates in uid
    order, queries) finalized, the preset value row with value_alloc
    widened as Megakernel.run widens it, and the data buffers."""
    st = graph.st_base
    iv = graph.preset_values(mk.num_values, tf.INF)
    iv[st] = 0
    b = B()
    b.reserve_values(graph.num_value_slots)
    for args in pkg.seed_frontier(None, graph, kind):
        b.add(0, args=list(args))
    for uid, (u, v, w) in enumerate(graph.updates):
        b.add(1, args=[u, v, w, uid])
    for qi, v in enumerate(queries):
        b.add(2, args=[v], out=st + graph.n + qi)
    tasks, succ, ring, counts = b.finalize(capacity=mk.capacity,
                                           succ_capacity=mk.succ_capacity)
    counts = counts.copy()
    counts[4] = max(counts[4], int(np.flatnonzero(iv)[-1]) + 1)
    data = [graph.indices] + ([graph.weights] if kind == "sssp" else [])
    return [tasks, succ, ring, counts, iv], data


def _sides(name):
    kind, kw, gkw, ups, queries = ARMS[name]
    out = {}
    for pkg, B in ((jd, JBuilder), (td, TBuilder)):
        g = _graph(pkg, **gkw)
        for up in ups:
            g.add_update(*up)
        if pkg is jd:
            mk = jd.make_dyngraph_megakernel(kind, g, interpret=True, **kw)
        else:
            mk = td.make_dyngraph_megakernel(kind, g, device="cpu", **kw)
        out[pkg] = (g, mk, *_staged(pkg, B, g, mk, kind, queries))
    return out


def _jax_raw(mj, staged, data, reps):
    with jax.default_device(jax.devices("cpu")[0]):
        outs = [np.asarray(o)
                for o in jax.jit(mj._build_raw(FUEL, reps))(*staged, *data)]
    res = dict(zip(PARTS[:4], outs[:4]))
    res.update(zip(["data." + k for k in mj.data_specs], outs[4:]))
    if mj.batch_specs:
        res["tstats"] = outs[-1]
    return res


_PAIRS: dict = {}


def _pair(name):
    """(JAX raw outputs, port raw outputs, port graph, port mk) of arm
    ``name``, computed once a process: only this arm's JAX raw program is
    compiled, so a test worker builds just the arm it runs (a scalar arm
    ~3 s, a width-4 arm ~30 s: 20 s of lowering, 10 of compile)."""
    if name not in _PAIRS:
        sides = _sides(name)
        gj, mj, sj, dj = sides[jd]
        gt, mt, stt, dt = sides[td]
        for x, y in zip(sj + dj, stt + dt):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        reps = REPS_OF.get(name, 1)
        jax_out = _jax_raw(mj, sj, dj, reps)
        s = state.from_numpy(*stt, data=dict(zip(mt.data_specs, dt)),
                             device="cpu")
        mt.launch(s, FUEL, reps=reps)
        tasks, _, ready, counts, ivalues, data = state.to_numpy(s)
        port_out = {"tasks": tasks, "ready": ready, "counts": counts,
                    "ivalues": ivalues,
                    **{"data." + k: v for k, v in data.items()}}
        if mt.batch_specs:
            port_out["tstats"] = s["tstats"].numpy()
        _PAIRS[name] = (jax_out, port_out, gt, mt)
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(ARMS))
def test_raw_state_like_jax(name):
    """The whole raw state word for word, the edge buffers the splices
    wrote included, and (routed arms) the decoded tiers."""
    jax_out, port_out, g, mt = _pair(name)
    kind, kw, _, _, queries = ARMS[name]
    assert set(jax_out) == set(port_out)
    assert "data.indices" in port_out
    assert ("data.weights" in port_out) == (kind == "sssp")
    for part in jax_out:
        x, y = jax_out[part], port_out[part]
        assert x.dtype == y.dtype == np.int32, part
        assert x.shape == y.shape and np.array_equal(x, y), part
    iv = port_out["ivalues"]
    if name == "exhaustion_w0":
        assert port_out["counts"][tmk.C_OVERFLOW] & tmk.OVF_ENGINE
        assert iv[td.V_DROPPED] == 1 and iv[td.V_UPDATES] == 1
        return
    if name.startswith("spares"):
        # The scalar ring pops LIFO: vertex 0's uids 129 down to 2 fill
        # its spare row in that order, uids 1 and 0 drop.
        assert iv[td.V_FREE] == 1 and iv[td.V_DROPPED] == 2
        assert iv[td.V_UPDATES] == len(S_UPS) - 2
        row = port_out["data.indices"][g.spare_base]
        assert np.array_equal(row, [S_UPS[i][1] for i in range(129, 1, -1)])
        st = g.st_base
        assert np.array_equal(iv[st:st + g.n],
                              td.host_dyngraph(kind, g, 0))
        return
    st = g.st_base
    assert np.array_equal(iv[st:st + g.n], td.host_dyngraph(kind, g, 0))
    assert iv[td.V_UPDATES] == len(UPS) and iv[td.V_DROPPED] == 0
    assert iv[td.V_FREE] == g.spare_needed()
    assert iv[td.V_QUERIES] == len(queries)
    # The splices landed in the adjacency the device holds.
    idx = port_out["data.indices"]
    for u, v, _ in UPS:
        rows = [int(g.blk_start[u]) + i for i in range(int(g.blk_count[u]))]
        rows += [g.spare_base + u * g.spare + j for j in range(g.spare)]
        assert v in idx[rows].reshape(-1)
    if kw.get("width"):
        tiers = mt.decode_tier_stats(port_out["tstats"])
        assert tiers["scalar_tasks"] == 0 and tiers["prefetch_hits"] == 0
        assert (tiers["bucket_fires"] > 0) == bool(
            kw.get("priority_buckets"))


def test_layout_like_jax():
    """DynGraph, array for array: the spare rows, preset_values,
    mutated() and spare_needed(), also on a stream that takes spares."""
    gj, gt = _graph(jd), _graph(td)
    for up in UPS + [(u, (u * 7 + 3) % N, 1 + u % 5) for u in range(8)]:
        assert gj.add_update(*up) == gt.add_update(*up)
    for f in ("deg", "blk_count", "blk_start", "indices", "weights"):
        assert np.array_equal(getattr(gt, f), getattr(gj, f)), f
    for f in ("n", "m", "nblocks", "spare", "spare_base", "static_nblocks",
              "bcs_base", "flag_base", "st_base", "num_value_slots",
              "upd_cap"):
        assert getattr(gt, f) == getattr(gj, f), f
    assert gt.updates == gj.updates
    for state0 in (tf.INF, 0):
        assert np.array_equal(gt.preset_values(gt.num_value_slots + 4,
                                               state0),
                              gj.preset_values(gj.num_value_slots + 4,
                                               state0))
    for count in (None, 2):
        mt, mj = gt.mutated(count), gj.mutated(count)
        for f in ("deg", "blk_count", "indices", "weights"):
            assert np.array_equal(getattr(mt, f), getattr(mj, f)), f
    assert gt.spare_needed() == gj.spare_needed()
    # A stream that fills vertex 0's tail, its one spare block, then
    # drops.
    tight_j = jd.DynGraph(N, SRC, DST, W, spare_blocks=1, upd_cap=300)
    tight_t = td.DynGraph(N, SRC, DST, W, spare_blocks=1, upd_cap=300)
    for up in [(0, v % N, 1) for v in range(300)]:
        tight_j.add_update(*up)
        tight_t.add_update(*up)
    assert tight_t.spare_needed() == tight_j.spare_needed() == 1
    assert np.array_equal(tight_t.mutated().deg, tight_j.mutated().deg)
    assert tight_t.mutated().deg[0] == 2 * tf.EBLOCK
    with pytest.raises(ValueError, match="out of range"):
        gt.add_update(0, gt.n)
    with pytest.raises(ValueError, match="weight"):
        gt.add_update(0, 1, -2)
    with pytest.raises(ValueError, match="spare_blocks"):
        td.DynGraph(N, SRC, DST, W, spare_blocks=-1)
    one = td.DynGraph(N, SRC, DST, W, spare_blocks=1, upd_cap=1)
    one.add_update(0, 1)
    with pytest.raises(ValueError, match="upd_cap"):
        one.add_update(1, 2)


def test_env_knobs(monkeypatch):
    """The two variables with JAX's rules (tests/test_dyngraph.py:82)."""
    monkeypatch.setenv("HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS", "3")
    assert td.DynGraph(N, SRC, DST, W).spare == 3
    for bad in ("0", "-1", "two"):
        monkeypatch.setenv("HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS", bad)
        with pytest.raises(ValueError, match="SPARE_BLOCKS"):
            td.DynGraph(N, SRC, DST, W)
    monkeypatch.delenv("HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS")
    assert td.DynGraph(N, SRC, DST, W).spare == 2
    for v, want in (("1", 1), ("9", 1)):  # clamped into [0, B)
        monkeypatch.setenv("HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY", v)
        mk = td.make_dyngraph_megakernel("bfs", _graph(td), width=4,
                                         priority_buckets=2, device="cpu")
        assert mk._dyngraph["update_priority"] == want
        rules = [s.priority for _, s, _ in mk.batch_specs]
        assert rules[1:] == [("const", 0, want), ("const", 0, 1)]
    monkeypatch.setenv("HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY", "x")
    with pytest.raises(ValueError, match="UPDATE_PRIORITY"):
        td.make_dyngraph_megakernel("bfs", _graph(td), device="cpu")
    monkeypatch.delenv("HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY")
    with pytest.raises(ValueError, match="batched arm"):
        td.make_dyngraph_megakernel("bfs", _graph(td), width=0,
                                    priority_buckets=2, device="cpu")
    mk = td.make_dyngraph_megakernel("sssp", _graph(td), width=8,
                                     device="cpu")
    assert mk.lane_max_age == 32 and not any(
        s.prefetch for _, s, _ in mk.batch_specs)
    mk = td.make_dyngraph_megakernel("sssp", _graph(td), width=4,
                                     priority_buckets=4, capacity=256,
                                     device="cpu")
    assert mk.lane_max_age == 512  # 2 x capacity under buckets


def test_pagerank_mass_and_run_entry():
    """run_dyngraph on the CPU: scalar PageRank conserves the mass of
    host_incremental_pagerank; SSSP at width 4 with queries equals
    host_dyngraph and reads the fixpoint's labels."""
    g = _graph(td)
    r, info = td.run_dyngraph("pagerank", g, updates=UPS, width=0, m0=M0,
                              reps=REPS, capacity=768, device="cpu")
    twin, _ = td.host_incremental_pagerank(g, m0=M0, reps=REPS)
    assert r.dtype == np.int64 and int(r.sum()) == int(twin.sum()) == N * M0
    assert info["updates_applied"] == len(UPS)
    g = _graph(td)
    r, info = td.run_dyngraph("sssp", g, 0, updates=UPS, queries=[0, 5, 9],
                              width=4, device="cpu")
    ref = td.host_dyngraph("sssp", g, 0)
    assert r.dtype == np.int32 and np.array_equal(r, ref)
    assert info["queries"] == 3 and info["query_values"][0] == 0
    assert info["dropped"] == 0 and info["spare_in_use"] == g.spare_needed()
    with pytest.raises(ValueError, match="dyngraph layout"):
        td.run_dyngraph("bfs", _graph(td), 0, mk=td.make_dyngraph_megakernel(
            "sssp", _graph(td), device="cpu"), device="cpu")


def test_spare_exhaustion_raises():
    """The exhaustion graph through run_dyngraph raises on the overflow
    flag; the host mirror drops the same insert."""
    g = _graph(td, exhaust=True)
    with pytest.raises(RuntimeError, match="overflow"):
        td.run_dyngraph("bfs", g, 0, updates=X_UPS, width=0, device="cpu")
    assert g.spare_needed() == 0
    assert int(g.mutated().deg.sum()) == int(g.deg.sum()) + 1
    assert np.array_equal(td.host_incremental("bfs", g, src=0),
                          td.host_dyngraph("bfs", g, 0))


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_host_incremental_like_jax(kind):
    """The port's incremental twin equals JAX's, and the from-scratch
    reference, under three permuted op orders (and PageRank's twin its
    rank and deliveries)."""
    gj, gt = _graph(jd), _graph(td)
    for up in UPS:
        gj.add_update(*up)
        gt.add_update(*up)
    rng = np.random.default_rng(4)
    ref = td.host_dyngraph(kind, gt, 0)
    assert np.array_equal(ref, jd.host_dyngraph(kind, gj, 0))
    for _ in range(3):
        order = rng.permutation(1 + len(UPS))
        got = td.host_incremental(kind, gt, 0, order=order)
        assert np.array_equal(got, jd.host_incremental(kind, gj, 0,
                                                       order=order))
        assert np.array_equal(got, ref)
    rt, dt = td.host_incremental_pagerank(gt, m0=M0, reps=REPS)
    rj, dj = jd.host_incremental_pagerank(gj, m0=M0, reps=REPS)
    assert np.array_equal(rt, rj) and dt == dj
    with pytest.raises(ValueError, match="permutation"):
        td.host_incremental(kind, gt, 0, order=[0])


def test_refusals_name_their_roadmap_items():
    g = _graph(td)
    for kw in ({"placement": object()}, {"mesh": object()},
               {"quantum": 64}, {"window": 16}, {"hop_order": [1]}):
        with pytest.raises(NotImplementedError, match="A11"):
            td.run_dyngraph("bfs", g, 0, device="cpu", **kw)
    # The recorder is ported (ROADMAP A9): a traced build is JAX's, and
    # a traced run records the rounds it ran.
    mt = td.make_dyngraph_megakernel("bfs", g, trace=64, device="cpu")
    mj = jd.make_dyngraph_megakernel("bfs", _graph(jd), trace=64,
                                     interpret=True)
    assert mt.trace.capacity == mj.trace.capacity == 64
    _, info = td.run_dyngraph("bfs", g, 0, trace=64, device="cpu")
    ring = info["trace"]["rings"][0]
    assert ring["written"] == ring["dropped"] + len(ring["records"])
    assert int(ring["records"][-1, 0]) == tmk.TR_ROUND_END
    # The streaming front door is ported (its scalar arm); the batched
    # arm is refused before anything registers, as in JAX.
    with pytest.raises(ValueError, match="scalar arm"):
        td.serve_dyngraph("sssp", g, updates=UPS, width=4, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        td.reshard_dyngraph(None, 2)
    assert g.updates == []  # refused before registering anything
    with pytest.raises(TypeError, match="DynGraph"):
        td.make_dyngraph_megakernel("bfs", tf.Graph(N, SRC, DST, W),
                                    device="cpu")
    with pytest.raises(ValueError, match="unknown dyngraph kind"):
        td.make_dyngraph_megakernel("dfs", g, device="cpu")


def test_expand_rounds_refuses_a_dyngraph_table():
    """The standalone EXPAND entry runs static tables only: a table with
    the dynamic-graph layout is refused before anything runs."""
    g = _graph(td)
    mk = td.make_dyngraph_megakernel("sssp", g, width=0, device="cpu")
    b, iv, data = td.dyngraph_state("sssp", g, mk)
    st = mk.state(b, data=data, ivalues=iv)
    before = st["ivalues"].clone()
    with pytest.raises(ValueError, match="static frontier table"):
        tf.expand_rounds(mk, st, [0])
    assert torch.equal(st["ivalues"], before)
