"""The port's lane-age firing policy, priority-bucket rings and
branch-and-bound against the JAX package's, and the build variables the
scheduler reads.

Word for word against ``jax.jit(mk._build_raw(fuel))`` in interpret mode
(task table, ready ring, counts, value slots, all 12 tier counters):
fib(9) at width 4 under ``HCLIB_TPU_LANE_MAX_AGE=1`` (the fault the port
had: it ignored the variable); two routed kinds under a small age bound;
a bucketed fib whose age guard fires out of bucket order; delta-stepping
SSSP at 8 buckets; the 12-item knapsack unordered and best-first (its
bucket count set through ``HCLIB_TPU_PRIORITY_BUCKETS``). Then the host
bucket spellings against the named rules, the knob and environment
checks, and the refusals that name their ROADMAP items."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from hclib_tpu.device import bnb as jb
from hclib_tpu.device import frontier as jf
from hclib_tpu.device import megakernel as jmk
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import bnb as tb
from hclib_tpu_torch.device import forasync_tier as tfa
from hclib_tpu_torch.device import frontier as tf
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder

FUEL = 1 << 22
N, SRC, DST, W = jw.rmat_edges(5, efactor=6, seed=3)
JG, TG = jf.Graph(N, SRC, DST, W), tf.Graph(N, SRC, DST, W)
KP_J, KP_T = jb.make_knapsack(12, seed=5), tb.make_knapsack(12, seed=5)
PARTS = ["tasks", "ready", "counts", "ivalues", "tstats"]
UTS = dict(seed=19, q_millis=440, m_children=4, max_depth=5)
# The build variables the JAX scheduler reads (megakernel.py:852-929).
ENV_VARS = ("HCLIB_TPU_TRACE", "HCLIB_TPU_CHECKPOINT",
            "HCLIB_TPU_QUIESCE_STRIDE", "HCLIB_TPU_LANE_MAX_AGE",
            "HCLIB_TPU_PRIORITY_BUCKETS")


def _jax_uts_node(fn):
    """JAX's make_uts_megakernel node body, spawning F_FN ``fn`` (the
    port's uts_node spawns its own F_FN in the table)."""
    def node(ctx):
        ctx.set_value(0, ctx.value(0) + 1)
        node_id, depth = ctx.arg(0), ctx.arg(1)

        @pl.when(depth < UTS["max_depth"])
        def _():
            for c in range(UTS["m_children"]):
                h = jmk.fault_mix(UTS["seed"], c, node_id, 0, depth)

                @pl.when((depth == 0) | (h < UTS["q_millis"]))
                def _(c=c):
                    ctx.spawn(fn, [node_id * 31 + jnp.int32(7 * c + 1)
                                   + depth, depth + 1], nargs=2)
    return node


def _fib_builder(B, n, uts=False):
    b = B()
    b.add(0, args=[n], out=1 if uts else 0)
    if uts:
        b.add(2, args=[1, 0])
    return b


def _frontier_builder(pkg, B, graph, mk):
    iv = graph.preset_values(mk.num_values, pkg.INF)
    iv[graph.st_base] = 0
    b = B()
    b.reserve_values(graph.num_value_slots)
    pkg.seed_frontier(b, graph, "sssp")
    return b, iv, [graph.indices, graph.weights]


def _bnb_builder(pkg, B, kp, mk):
    b = B()
    b.reserve_values(kp.num_value_slots)
    b.add(0, args=[0, 0, 0, kp.total])
    return b, kp.preset_values(mk.num_values), []


def _cases():
    """name -> (env, JAX maker, port maker, staging(pkg, B, mk))."""
    fib_nv = 4 * 256 + 16

    def fib_stage(n, uts=False):
        return lambda pkg, B, mk: (_fib_builder(B, n, uts), None, [])

    return {
        "fib9_age1_env": (
            {"HCLIB_TPU_LANE_MAX_AGE": "1"},
            lambda: jw.make_fib_megakernel(64, interpret=True, batch_width=4),
            lambda: tw.make_fib_megakernel(64, batch_width=4, device="cpu"),
            fib_stage(9)),
        "fib_uts_two_lanes_age3": (
            {},
            lambda: jmk.Megakernel(
                kernels=[("fib", jw._fib_kernel), ("sum", jw._sum_kernel),
                         ("uts_node", _jax_uts_node(2))],
                route={"fib": jw.batch_of(jw._fib_kernel, 4),
                       "uts_node": jw.batch_of(_jax_uts_node(2), 4)},
                capacity=256, num_values=fib_nv, succ_capacity=8,
                uses_row_values=True, interpret=True, lane_max_age=3),
            lambda: tmk.Megakernel(
                ["fib", "sum", "uts_node"],
                route={"fib": tmk.BatchSpec(4),
                       "uts_node": tmk.BatchSpec(4)},
                capacity=256, num_values=fib_nv, succ_capacity=8,
                uses_row_values=True, params=UTS, lane_max_age=3,
                device="cpu"),
            fib_stage(8, uts=True)),
        "fib10_buckets4_age3": (
            {},
            lambda: jmk.Megakernel(
                kernels=[("fib", jw._fib_kernel), ("sum", jw._sum_kernel)],
                route={"fib": jmk.BatchSpec(
                    jw.batch_of(jw._fib_kernel, 2).body, width=2,
                    priority=lambda arg: arg(0) // jnp.int32(1))},
                capacity=128, num_values=4 * 128 + 16, succ_capacity=8,
                uses_row_values=True, interpret=True, priority_buckets=4,
                lane_max_age=3),
            lambda: tmk.Megakernel(
                ["fib", "sum"],
                route={"fib": tmk.BatchSpec(2, priority=("div", 0, 1))},
                capacity=128, num_values=4 * 128 + 16, succ_capacity=8,
                uses_row_values=True, priority_buckets=4, lane_max_age=3,
                device="cpu"),
            fib_stage(10)),
        "sssp_w4_buckets8": (
            {},
            lambda: jf.make_frontier_megakernel(
                jf.sssp_kernel(), JG, width=4, interpret=True,
                priority_buckets=8),
            lambda: tf.make_frontier_megakernel(
                tf.sssp_kernel(), TG, width=4, priority_buckets=8,
                device="cpu"),
            lambda pkg, B, mk: _frontier_builder(
                pkg, B, JG if pkg is jf else TG, mk)),
        "bnb_w4": (
            {},
            lambda: jb.make_bnb_megakernel(KP_J, width=4, interpret=True),
            lambda: tb.make_bnb_megakernel(KP_T, width=4, device="cpu"),
            lambda pkg, B, mk: _bnb_builder(
                pkg, B, KP_J if pkg is jb else KP_T, mk)),
        "bnb_w4_buckets8_env": (
            {"HCLIB_TPU_PRIORITY_BUCKETS": "8"},
            lambda: jb.make_bnb_megakernel(KP_J, width=4, interpret=True),
            lambda: tb.make_bnb_megakernel(KP_T, width=4, device="cpu"),
            lambda pkg, B, mk: _bnb_builder(
                pkg, B, KP_J if pkg is jb else KP_T, mk)),
    }


CASES = _cases()
_PKG = {"sssp_w4_buckets8": (jf, tf), "bnb_w4": (jb, tb),
        "bnb_w4_buckets8_env": (jb, tb)}
_PAIRS: dict = {}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No build variable leaks in from outside; the JAX reference is
    built without its build-time verifier (a host analysis)."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


def _staged(name, side, mk):
    pkgs = _PKG.get(name, (None, None))
    pkg, B = (pkgs[0], JBuilder) if side == "jax" else (pkgs[1], TBuilder)
    b, iv, data = CASES[name][3](pkg, B, mk)
    tasks, succ, ring, counts = b.finalize(capacity=mk.capacity,
                                           succ_capacity=mk.succ_capacity)
    counts = counts.copy()
    if iv is None:
        iv = np.zeros(mk.num_values, np.int32)
    else:
        nz = np.flatnonzero(iv)
        counts[4] = max(counts[4], int(nz[-1]) + 1)
    return [tasks, succ, ring, counts, np.asarray(iv, np.int32)], data


def _pair(name):
    """(JAX raw outputs, port raw outputs, JAX mk, port mk) of case
    ``name``, built under the case's environment and computed once a
    process: only this case's JAX raw program is compiled."""
    if name not in _PAIRS:
        env, make_j, make_t, _ = CASES[name]
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            mj, mt = make_j(), make_t()
        sj, dj = _staged(name, "jax", mj)
        stt, dt = _staged(name, "port", mt)
        for x, y in zip(sj + dj, stt + dt):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        with jax.default_device(jax.devices("cpu")[0]):
            outs = [np.asarray(o)
                    for o in jax.jit(mj._build_raw(FUEL))(*sj, *dj)]
        s = state.from_numpy(*stt, data=dict(zip(mt.data_specs, dt)),
                             device="cpu")
        mt.launch(s, FUEL)
        tasks, _, ready, counts, ivalues, _ = state.to_numpy(s)
        port = [tasks, ready, counts, ivalues, s["tstats"].numpy()]
        _PAIRS[name] = (outs[:4] + [outs[-1]], port, mj, mt)
    return _PAIRS[name]


@pytest.fixture(params=sorted(CASES))
def case(request):
    return request.param


def test_raw_state_tiers_and_knobs_like_jax(case):
    """The whole raw state word for word (all 12 tier counters included),
    the knobs and decoded tiers equal to JAX's, and each case's result."""
    jax_out, port_out, mj, mt = _pair(case)
    for part, x, y in zip(PARTS, jax_out, port_out):
        assert x.dtype == y.dtype == np.int32, part
        assert x.shape == y.shape and np.array_equal(x, y), part
    assert (mt.lane_max_age, mt.priority_buckets) == (
        mj.lane_max_age, mj.priority_buckets)
    tiers = mt.decode_tier_stats(port_out[4])
    assert tiers == mj.decode_tier_stats(jax_out[4])
    counts, iv = port_out[2], port_out[3]
    if case == "fib9_age1_env":
        # The repaired fault: JAX's numbers under HCLIB_TPU_LANE_MAX_AGE=1.
        assert mt.lane_max_age == 1 and iv[0] == 34
        assert (tiers["age_fires"], tiers["batch_rounds"], counts[2]) == (
            100, 109, 11)
    elif case == "fib_uts_two_lanes_age3":
        assert iv[1] == 21 and iv[0] == tw.device_uts_mk(
            **{**UTS, "capacity": 256}, device="cpu")[0]
        assert tiers["age_fires"] > 0 and tiers["max_starved_age"] <= 3 + 1
    elif case == "fib10_buckets4_age3":
        # An age-guard fire out of bucket order counts as an inversion.
        assert iv[0] == 55 and tiers["bucket_inversions"] >= 1
        assert tiers["max_starved_age"] <= 3 + 4  # N + nrows bound
    elif case == "sssp_w4_buckets8":
        st = TG.st_base
        assert np.array_equal(iv[st:st + TG.n], tf.host_sssp(TG))
        assert tiers["bucket_fires"] > 0 and tiers["bucket_inversions"] == 0
        assert mt.lane_max_age == 2 * mt.capacity
    else:
        assert iv[tb.V_BEST] == tb.host_knapsack_opt(KP_T) == \
            jb.host_knapsack_opt(KP_J)
        assert iv[tb.V_PRUNED] > 0 and iv[tb.V_LEAVES] >= 1


def test_delta_sssp_fewer_expands_than_unordered():
    d_u, iu = tf.run_frontier("sssp", TG, 0, width=4, device="cpu")
    d_b, ib = tf.run_frontier("sssp", TG, 0, width=4, priority_buckets=8,
                              device="cpu")
    want = tf.host_sssp(TG)
    assert np.array_equal(d_u, want) and np.array_equal(d_b, want)
    assert ib["executed"] <= iu["executed"]
    assert ib["tiers"]["prefetch_hits"] == 0  # bucketed: no prefetch


def test_bnb_best_first_prunes_more():
    assert tb.host_bnb(KP_T) == jb.host_bnb(KP_J)
    assert tb.host_bnb(KP_T, best_first=True) == jb.host_bnb(
        KP_J, best_first=True)
    best_u, iu = tb.run_bnb(KP_T, width=4, device="cpu")
    best_b, ib = tb.run_bnb(KP_T, width=4, priority_buckets=8, device="cpu")
    best_s, _ = tb.run_bnb(KP_T, width=0, device="cpu")
    assert best_u == best_b == best_s == tb.host_knapsack_opt(KP_T)
    assert ib["executed"] < iu["executed"]
    assert (iu["executed"], ib["executed"],
            ib["tiers"]["bucket_fires"]) == (377, 88, 9)


def test_bucket_rules_equal_host_spellings():
    """Each named rule (the card's and the plain core's routing) equals
    the host spelling and JAX's traced priority callable."""
    delta, reps, nbk = 3, 64, 8
    jdiv = jf._bucket_fn("fr_sssp", delta, reps)
    jband = jf._bucket_fn("fr_pagerank", delta, reps)
    for carry in [0, 1, 2, 5, 17, 63, 64, 127, 128, 300, 4096, 1 << 14,
                  1 << 20, -1, -7]:
        args = [0, 0, carry, 0, 0, 0]
        div = tmk.bucket_of(tf._bucket_rule("fr_sssp", delta, reps), args,
                            nbk)
        band = tmk.bucket_of(tf._bucket_rule("fr_pagerank", delta, reps),
                             args, nbk)
        assert div == min(max(tf.priority_bucket("sssp", carry,
                                                 delta=delta), 0), nbk - 1)
        assert band == min(tf.priority_bucket("pagerank", carry, reps=reps),
                           nbk - 1)
        assert tf.priority_bucket("pagerank", carry) == jf.priority_bucket(
            "pagerank", carry)
        arg = lambda i, c=carry: jnp.int32(c)  # noqa: E731
        assert div == min(max(int(jdiv(arg)), 0), nbk - 1)
        assert band == min(max(int(jband(arg)), 0), nbk - 1)
    rule = ("linear_desc", 3, KP_T.total, nbk)
    for bound in [0, 1, KP_T.total // 3, KP_T.total - 1, KP_T.total]:
        b = tmk.bucket_of(rule, [0, 0, 0, bound, 0, 0], nbk)
        assert b == tb.bnb_bucket(KP_T, bound, nbk) == jb.bnb_bucket(
            KP_J, bound, nbk)
    assert tf.default_delta(TG) == jf.default_delta(JG)
    assert tmk.bucket_of(None, [9] * 6, nbk) == 0


def test_env_variables_honoured_or_refused(monkeypatch):
    """Each of the five variables the JAX scheduler reads: the age and
    bucket knobs take effect (word for word with JAX in the cases above),
    the quiesce stride is parsed as JAX parses it (and, without
    checkpointing, changes nothing), and a trace or checkpoint that the
    environment turns on builds the recorder / the poll as JAX's does."""
    def build():
        return tmk.Megakernel(["fib", "sum"], capacity=64,
                              num_values=4 * 64 + 16, device="cpu")

    def jbuild():
        return jmk.Megakernel(kernels=[("k", lambda ctx: None)], capacity=8,
                              num_values=8, succ_capacity=8, interpret=True)

    for v, cap in (("1", 2048), ("64", 64), ("banana", 2048)):
        monkeypatch.setenv("HCLIB_TPU_TRACE", v)
        mk, mj = build(), jbuild()
        assert mk.trace.capacity == mj.trace.capacity == cap
    for v in ("0", "-3", ""):
        monkeypatch.setenv("HCLIB_TPU_TRACE", v)
        assert build().trace is jbuild().trace is None
    monkeypatch.delenv("HCLIB_TPU_TRACE")
    monkeypatch.setenv("HCLIB_TPU_CHECKPOINT", "1")
    mk, mj = build(), jbuild()
    assert mk.checkpoint is mj.checkpoint is True
    monkeypatch.setenv("HCLIB_TPU_CHECKPOINT", "0")
    assert build().checkpoint is jbuild().checkpoint is False
    monkeypatch.delenv("HCLIB_TPU_CHECKPOINT")
    for v, want in (("5", 5), ("banana", 1), ("-2", 1)):
        monkeypatch.setenv("HCLIB_TPU_QUIESCE_STRIDE", v)
        mj = jmk.Megakernel(kernels=[("k", lambda ctx: None)], capacity=8,
                            num_values=8, succ_capacity=8, interpret=True)
        assert build().quiesce_stride == mj.quiesce_stride == want
    monkeypatch.delenv("HCLIB_TPU_QUIESCE_STRIDE")
    monkeypatch.setenv("HCLIB_TPU_LANE_MAX_AGE", "12")
    assert build().lane_max_age == 12
    fk = tf.bfs_kernel()
    assert tf.make_frontier_megakernel(fk, TG, device="cpu"
                                       ).lane_max_age == 12
    monkeypatch.setenv("HCLIB_TPU_LANE_MAX_AGE", "banana")
    with pytest.raises(ValueError, match="LANE_MAX_AGE"):
        build()
    monkeypatch.delenv("HCLIB_TPU_LANE_MAX_AGE")
    monkeypatch.setenv("HCLIB_TPU_PRIORITY_BUCKETS", "4")
    assert build().priority_buckets == 4
    fmk = tf.make_frontier_megakernel(tf.sssp_kernel(), TG, width=4,
                                      device="cpu")
    assert fmk.priority_buckets == 4 and fmk.si_claim[3] == 4
    assert not fmk.batch_specs[0][1].prefetch
    assert tb.make_bnb_megakernel(KP_T, width=4,
                                  device="cpu").priority_buckets == 4
    for v in ("banana", "9", "1"):
        monkeypatch.setenv("HCLIB_TPU_PRIORITY_BUCKETS", v)
        with pytest.raises(ValueError, match="PRIORITY_BUCKETS|priority"):
            build()


def test_knob_validation_and_prebuilt_guards():
    """tests/test_frontier.py:464,477 and tests/test_priority.py:179's
    checks on the port's spelling."""
    with pytest.raises(ValueError, match="lane_max_age"):
        tw.make_fib_megakernel(64, device="cpu").__class__(
            ["fib", "sum"], lane_max_age=-1, device="cpu")
    for nbk in (1, tmk.BK_MAX + 1):
        with pytest.raises(ValueError, match="priority_buckets"):
            tmk.Megakernel(["fib", "sum"], priority_buckets=nbk,
                           device="cpu")
    with pytest.raises(ValueError, match="priority"):
        tmk.BatchSpec(2, priority=3)
    with pytest.raises(ValueError, match="prefetch"):
        tmk.Megakernel(["fr_sssp"], route={"fr_sssp": tmk.BatchSpec(
            4, prefetch=True)}, priority_buckets=4, device="cpu")
    with pytest.raises(ValueError, match="batched arm"):
        tf.make_frontier_megakernel(tf.sssp_kernel(), TG, width=0,
                                    priority_buckets=4, device="cpu")
    with pytest.raises(ValueError, match="batched arm"):
        tb.make_bnb_megakernel(KP_T, width=0, priority_buckets=4,
                               device="cpu")
    mk = tf.make_frontier_megakernel(tf.bfs_kernel(), TG, width=8,
                                     device="cpu")
    assert mk.lane_max_age == 32  # 4 * width
    n2, s2, d2, w2 = tw.rmat_edges(4, efactor=4, seed=9)
    with pytest.raises(ValueError, match="frontier layout"):
        tf.run_frontier("bfs", tf.Graph(n2, s2, d2, w2), 0, mk=mk,
                        device="cpu")
    fk = tf.bfs_kernel()
    tf.make_frontier_megakernel(fk, TG, device="cpu")
    with pytest.raises(ValueError, match="graph layout"):
        tf.make_frontier_megakernel(fk, tf.Graph(n2, s2, d2, w2),
                                    device="cpu")
    bmk = tb.make_bnb_megakernel(KP_T, width=4, device="cpu")
    with pytest.raises(ValueError, match="knapsack"):
        tb.run_bnb(tb.make_knapsack(12, seed=6), mk=bmk, device="cpu")


def test_const_rule_plain_and_checks():
    """The ``const`` rule (dyngraph's UPDATE and QUERY lanes; JAX's
    ``lambda arg: jnp.int32(c)``): bucket c clipped into [0, nbk), the arg
    word unread; its parameter checks."""
    for c in (-3, 0, 1, 5, 9, (1 << 31) - 1, -(1 << 31)):
        for nbk in (2, 4, tmk.BK_MAX):
            for args in ([0] * 6, [7, -1, 1 << 20, 3, 2, 9]):
                want = int(np.clip(c, 0, nbk - 1))
                assert tmk.bucket_of(("const", 0, c), args, nbk) == want
                assert tmk.bucket_of(("const", 5, c), args, nbk) == want
    assert tmk.BatchSpec(4, priority=("const", 0, 1)).priority == (
        "const", 0, 1)
    for bad in (("const", 0), ("const", 0, 1, 2), ("const", 0, 1 << 31),
                ("const", 0, -(1 << 31) - 1), ("const", 6, 1),
                ("const", 0, 1.5)):
        with pytest.raises(ValueError):
            tmk.BatchSpec(4, priority=bad)
    assert tmk.PRIORITY_RULES["const"] == 4


def test_refusals_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="A11"):
        tf.run_frontier("bfs", TG, 0, placement=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        tf.run_frontier("bfs", TG, 0, runner="resident", device="cpu")
    # The recorder and the poll are ported (ROADMAP A9): a traced run
    # carries JAX's ring (tests/test_torch_tracebuf.py), and a checkpoint
    # build is JAX's.
    _, info = tf.run_frontier("bfs", TG, 0, trace=1024, device="cpu")
    assert info["trace"]["rings"][0]["capacity"] == 1024
    assert "lane_partial_age" in info["tiers"]
    mt = tf.make_frontier_megakernel(tf.bfs_kernel(), TG, checkpoint=True,
                                     device="cpu")
    mj = jf.make_frontier_megakernel(jf.bfs_kernel(), JG, checkpoint=True,
                                     interpret=True)
    assert mt.checkpoint is mj.checkpoint is True
    assert mt.quiesce_stride == mj.quiesce_stride
    # The spare-aware spawner is ported (dyngraph); a user-defined one is
    # user code on the card.
    with pytest.raises(NotImplementedError, match="A4"):
        tf.bfs_kernel(spawn=lambda ctx, u, carry: None)
    with pytest.raises(NotImplementedError, match="A4"):
        tmk.BatchSpec(4, priority=("nearest", 2, 1))
    with pytest.raises(NotImplementedError, match="A4"):
        tmk.BatchSpec(4, priority=lambda arg: arg(2))
    tk, bounds, tile = tw.map_loop(16)
    out, info = tfa.run_forasync_device(tk, bounds, tile, {
        "vin": tw.map_data(16)[0], "vout": tw.map_data(16)[1]},
        trace=64, device="cpu")
    recs = info["trace"]["rings"][0]["records"]
    assert info["trace"]["rings"][0]["capacity"] == 64
    assert (recs[0, 0], recs[-1, 0]) == (tmk.TR_ROUND_BEGIN,
                                         tmk.TR_ROUND_END)
    assert int(recs[-1, 2]) == info["executed"] == 16
