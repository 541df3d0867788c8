"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the test, never at import) where
``torch.cuda.is_available()`` is False. On a machine with an H100 run

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports the JAX package, which
the machine with the card does not have). ``chip_smoke.py`` holds the
same kernels to their plain versions at full size.
"""

import ctypes

import numpy as np
import pytest
import torch

from hclib_tpu_torch.device import cholesky as tc
from hclib_tpu_torch.device import bnb as tb
from hclib_tpu_torch.device import dyngraph as td
from hclib_tpu_torch.device import forasync_tier as tfa
from hclib_tpu_torch.device import frontier as tf
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import smithwaterman as ts
from hclib_tpu_torch.device import sw_pallas as tsp
from hclib_tpu_torch.device import tracebuf as ttb
from hclib_tpu_torch.device import vector_engine as tv
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device import uts_vec as tuv
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder
from hclib_tpu_torch.device.uts_fused import uts_fused
from hclib_tpu_torch.models import uts as tm
from hclib_tpu_torch.models.cholesky import make_spd
from hclib_tpu_torch.models.smithwaterman import random_seq, sw_seq
from hclib_tpu_torch.ops.tiles import split_bf16, unsplit

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _raw(mk, b, reps=1, stage_all=False, fuel=1 << 22, data=None,
         ivalues=None, quiesce=None):
    """Every output of one launch: the state, tstats, data and, on an
    observed build, qstat, the ring's header and its decoded records."""
    st = mk.state(b, data=data, ivalues=ivalues)
    mk.launch(st, fuel=fuel, reps=reps, stage_all_values=stage_all,
              quiesce=quiesce)
    out = {k: st[k].cpu() for k in ("tasks", "ready", "counts", "ivalues",
                                     "tstats", "qstat") if k in st}
    out.update({f"data.{k}": v.cpu() for k, v in st["data"].items()})
    if "trace" in st:
        ring = st["trace"].cpu()
        out["trace.header"] = ring[:ttb.HDR]
        out["trace.records"] = torch.from_numpy(
            ttb.decode_ring(ring.numpy())["records"])
    return out


@pytest.mark.parametrize("n", [11, 15])
def test_megakernel_fib_equals_plain(card, n):
    b = TaskGraphBuilder()
    b.add(tw.FIB, args=[n], out=0)
    got = _raw(tw.make_fib_megakernel(768, device="cuda"), b)
    want = _raw(tw.make_fib_megakernel(768, device="cpu"), b)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("reps,stage_all", [(3, False), (2, True)])
def test_megakernel_reps_equal_plain(card, reps, stage_all):
    b = TaskGraphBuilder()
    b.add(tw.FIB, args=[9], out=0)
    got = _raw(tw.make_fib_megakernel(64, device="cuda"), b, reps, stage_all)
    want = _raw(tw.make_fib_megakernel(64, device="cpu"), b, reps, stage_all)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_megakernel_uts_equals_plain(card):
    b = TaskGraphBuilder()
    b.add(tw.UTS_NODE, args=[1, 0])
    got = _raw(tw.make_uts_megakernel(device="cuda"), b)
    want = _raw(tw.make_uts_megakernel(device="cpu"), b)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n,tile", [(256, 128), (512, 256)])
def test_megakernel_cholesky_equals_plain(card, n, tile):
    a = make_spd(n).astype(np.float32)
    lg, ig = tc.device_cholesky(a, tile=tile, device="cuda")
    lc, ic = tc.device_cholesky(a, tile=tile, device="cpu")
    ref = lc.double()
    assert (lg.cpu().double() - ref).abs().max() / ref.abs().max() < 1e-5
    assert ig["executed"] == ic["executed"]


def test_standalone_tile_bodies_equal_plain(card):
    """One fused step by each standalone entry against its plain version
    on the same inputs, at tile 256 with factor_base 128."""
    nt, ts = 3, 256
    a = make_spd(nt * ts, seed=5).astype(np.float32)
    bufs = tc.cholesky_buffers(a, nt, ts, device="cuda")
    steps = [
        lambda d, plain: (tc.potrf_plain if plain else tc.potrf)(
            d["tiles"], d["linvsp"], 0, 128),
        lambda d, plain: (tc.trsmcol_plain if plain else tc.trsmcol)(
            d["tiles"], d["linvsp"], d["lsp"], 0),
        lambda d, plain: (tc.updrow_plain if plain else tc.updrow)(
            d["tiles"], d["lsp"], 2, 0),
    ]
    for n_done, step in enumerate(steps, 1):
        got = {k: v.clone() for k, v in bufs.items()}
        want = {k: v.clone() for k, v in bufs.items()}
        step(got, False)
        step(want, True)
        torch.cuda.synchronize()
        ref = want["tiles"].double()
        assert ((got["tiles"].double() - ref).abs().max()
                / ref.abs().max()) < 1e-5
        g = unsplit(*got["linvsp"].unbind(1)).double()
        w = unsplit(*want["linvsp"].unbind(1)).double()
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale < 1e-5
        # Once TRSMCOL ran, the stored L operands are split_bf16 of the
        # stored f32 tiles, bit for bit.
        for i in range(1, nt if n_done >= 2 else 1):
            hi, lo = split_bf16(got["tiles"][i, 0])
            assert torch.equal(hi, got["lsp"][i, 0, 0])
            assert torch.equal(lo, got["lsp"][i, 0, 1])
        bufs = got


def test_trsm_equals_plain(card):
    """The standalone TRSM entry on tile (2, 0) at tile 256 against its
    plain version; its stored split is split_bf16 of its own result."""
    nt, ts = 3, 256
    a = make_spd(nt * ts, seed=5).astype(np.float32)
    bufs = tc.cholesky_buffers(a, nt, ts, device="cuda")
    tc.potrf_plain(bufs["tiles"], bufs["linvsp"], 0, 128)
    got = {k: v.clone() for k, v in bufs.items()}
    want = {k: v.clone() for k, v in bufs.items()}
    tc.trsm(got["tiles"], got["linvsp"], got["lsp"], 2, 0)
    tc.trsm_plain(want["tiles"], want["linvsp"], want["lsp"], 2, 0)
    torch.cuda.synchronize()
    ref = want["tiles"][2, 0].double()
    assert ((got["tiles"][2, 0].double() - ref).abs().max()
            / ref.abs().max()) < 1e-5
    assert torch.equal(got["tiles"][1, 0], want["tiles"][1, 0])
    hi, lo = split_bf16(got["tiles"][2, 0])
    assert torch.equal(hi, got["lsp"][2, 0, 0])
    assert torch.equal(lo, got["lsp"][2, 0, 1])


# The small trees of tests/test_uts_vec.py, with their root targets.
UTS_SMALL = {
    "fixed": (tm.UTSParams(shape=tm.FIXED, gen_mx=7, b0=4.0, root_seed=19),
              256),
    "linear": (tm.UTSParams(shape=tm.LINEAR, gen_mx=8, b0=4.0,
                            root_seed=34), 128),
    "cyclic": (tm.UTSParams(shape=tm.CYCLIC, gen_mx=1, b0=6.0,
                            root_seed=502), 8),
}


@pytest.mark.parametrize("name", sorted(UTS_SMALL))
def test_uts_kernel_equals_plain(card, name):
    """The fused kernel's counts against the plain lockstep engine (run on
    the CPU, where it is quicker than as ~1,500 small launches a step) and
    the sequential spec (integers: exact)."""
    p, target = UTS_SMALL[name]
    got = uts_fused(p, target_roots=target, lanes=(8, 128), timing_reps=1)
    want = tuv.uts_vec(p, target_roots=target, device="cpu")
    assert got["roots"] == want["roots"] > 0
    triple = lambda r: (r["nodes"], r["leaves"], r["max_depth"])  # noqa: E731
    assert triple(got) == triple(want) == tm.count_seq(p)


# The batch tier (K1) with its batched bodies (K2-K4): the card's whole
# output state, tstats included, equals the plain core's word for word.

@pytest.mark.parametrize("n,fuel", [(11, 1 << 22), (13, 500)])
def test_batch_tier_fib_equals_plain(card, n, fuel):
    """fib_batch; at fuel 500 fib(13) runs out and spills its lane."""
    b = TaskGraphBuilder()
    b.add(tw.FIB, args=[n], out=0)
    got = _raw(tw.make_fib_megakernel(768, batch_width=8, device="cuda"), b,
               fuel=fuel)
    want = _raw(tw.make_fib_megakernel(768, batch_width=8, device="cpu"), b,
                fuel=fuel)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_batch_tier_uts_equals_plain(card):
    b = TaskGraphBuilder()
    b.add(tw.UTS_NODE, args=[1, 0])
    got = _raw(tw.make_uts_megakernel(batch_width=8, device="cuda"), b)
    want = _raw(tw.make_uts_megakernel(batch_width=8, device="cpu"), b)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_updrow_batch_equals_scalar(card):
    """The batched Cholesky factor on the card is bit-identical to the
    scalar-UPDROW one, and the standalone batched entry to four UPDROWs."""
    a = make_spd(768).astype(np.float32)
    lb, ib = tc.device_cholesky(a, tile=128, device="cuda")
    ls, _ = tc.device_cholesky(a, tile=128, batch_updrow=False, device="cuda")
    assert torch.equal(lb, ls)
    assert ib["tiers"]["batch_tasks"] == 15 and ib["tiers"]["spilled"] == 0
    bufs = tc.cholesky_buffers(a, 6, 128, device="cuda")
    tc.potrf_plain(bufs["tiles"], bufs["linvsp"], 0, 128)
    tc.trsmcol_plain(bufs["tiles"], bufs["linvsp"], bufs["lsp"], 0)
    rows = [(5, 0), (4, 0), (3, 0), (2, 0)]
    got, want = bufs["tiles"].clone(), bufs["tiles"].clone()
    tc.updrow_batch(got, bufs["lsp"], rows)
    for i, k in rows:
        tc.updrow(want, bufs["lsp"], i, k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,chunk,width", [(512, 1, 2), (1280, 8, 2)])
def test_sw_engines_equal_plain(card, n, chunk, width):
    """sw_tile and sw_wave_batch (with its cp.async prefetch) against the
    plain core: every output buffer and tstats equal; H = sw_seq."""
    a, b = random_seq(n, 5), random_seq(n, 6)
    nt = n // ts.T
    data = ts.sw_wave_buffers(a, b)
    data["htiles"] = np.zeros((nt, nt, ts.T, ts.T), np.int32)
    graph = ts.build_sw_wave_graph(nt, nt, chunk=chunk)
    got = _raw(ts.make_sw_wave_megakernel(nt, nt, chunk=chunk, width=width,
                                          device="cuda"), graph, data=data)
    want = _raw(ts.make_sw_wave_megakernel(nt, nt, chunk=chunk, width=width,
                                           device="cpu"), graph, data=data)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if chunk == 1:  # mid-waves queue 3-4 descriptors: prefetch engages
        assert int(want["tstats"][4]) > 0
    ref = torch.from_numpy(sw_seq(a, b)[1:, 1:])
    score, h, _ = ts.device_sw(a, b, device="cuda")
    assert torch.equal(h.cpu(), ref) and score == int(ref.max())
    hw = got["data.htiles"].transpose(1, 2).reshape(n, n)
    assert torch.equal(hw, ref)


# The vector tier (row 1i) and the batched SW score kernel (row 3).

@pytest.mark.parametrize("max_steps", [7, 40, tv.NO_LIMIT])
@pytest.mark.parametrize("family", ["vfib14", "nqueens6"])
@pytest.mark.parametrize("lanes", [(1, 8), (2, 8), (8, 128)])
def test_subtree_engine_equals_plain(card, lanes, family, max_steps):
    """The standalone engine against the plain runner, truncated runs
    included: nodes, sums, overflow flag and steps equal."""
    if family == "vfib14":
        spec, frame, count = tv.fib_spec(16, lanes), (14,), 2
    else:
        spec, frame, count = tv.nqueens_spec(6, lanes), (0, 0, 0), 6
    got = tv.subtree_run(spec, frame, count, max_steps, device="cuda")
    want = tv.subtree_run(spec, frame, count, max_steps, device="cpu")
    assert got == want


def test_subtree_engine_overflow_equals_plain(card):
    spec = tv.fib_spec(3, (1, 8))
    got = tv.subtree_run(spec, (12,), 2, 100000, device="cuda")
    assert got == tv.subtree_run(spec, (12,), 2, 100000, device="cpu")
    assert got[2]


@pytest.mark.parametrize("name", ["vfib20", "nqueens8", "routed"])
def test_vector_tables_equal_plain(card, name):
    """device_vfib(20), device_nqueens(8) and a routed fib graph: the
    card's whole output state equals the plain core's."""
    b = TaskGraphBuilder()
    if name == "vfib20":
        make = lambda d: tw.make_vfib_megakernel(22, device=d)  # noqa: E731
        b.add(tw.VFIB, args=[20], out=0)
    elif name == "nqueens8":
        make = lambda d: tmk.Megakernel(  # noqa: E731
            [("vnqueens", tv.nqueens_spec(8))], capacity=64, num_values=16,
            succ_capacity=8, device=d)
        b.add(tw.VNQUEENS, args=[0], out=0)
    else:
        make = lambda d: tmk.Megakernel(  # noqa: E731
            ["fib", "sum"], route={"fib": tv.fib_spec(14, (1, 8))},
            capacity=16, num_values=16, succ_capacity=8, device=d)
        t0 = b.add(tw.FIB, args=[9], out=0)
        t1 = b.add(tw.FIB, args=[10], out=1)
        b.add(tw.SUM, args=[0, 1], deps=[t0, t1], out=2)
        b.reserve_values(3)
    got, want = _raw(make("cuda"), b), _raw(make("cpu"), b)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    v, info = (tw.device_vfib(20) if name == "vfib20" else
               tw.device_nqueens(8) if name == "nqueens8" else (None, None))
    if v is not None:
        assert v == int(want["ivalues"][0]) and info["executed"] == int(
            want["counts"][5])


@pytest.mark.parametrize("B,n,m", [(9, 64, 256), (6, 97, 128), (5, 50, 45),
                                   (3, 33, 300)])
def test_sw_scores_equal_plain(card, B, n, m):
    rng = np.random.default_rng(B)
    a = rng.integers(0, 4, (B, n)).astype(np.int32)
    b = rng.integers(0, 4, (B, m)).astype(np.int32)
    got = tsp.sw_scores_pallas(a, b)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    want = tsp.sw_scores_plain(at.T.contiguous(), bt.T.contiguous())
    assert torch.equal(got, want)
    assert got.tolist() == [int(sw_seq(a[i], b[i]).max()) for i in range(B)]


# The forasync tile tier (row 1k) and the arrayadd tile (row 1h').

FA_LOOPS = {
    # bench.py --forasync's stencil size; rows alternate 16- and 8-byte
    # aligned (W + 2 = 1026 int32)
    "stencil": lambda: (tw.stencil_loop(64, 1024),
                        tw.stencil_data(64, 1024)),
    # 85-wide tiles: slab rows start 4 bytes off, 87-word rows have tails
    "stencil_odd": lambda: (tw.stencil_loop(24, 510, th=8, tw=85),
                            tw.stencil_data(24, 510, seed=4)),
    "map": lambda: (tw.map_loop(64), tw.map_data(64)),
    # 3 x 33 blocks: 99 words, so blocks start 4 bytes off 16
    "map_odd": lambda: (tw.map_loop(16, th=3, tw=33),
                        tw.map_data(16, th=3, tw=33, seed=6)),
}


def _fa_pair(loop, width, prefetch, fuel=1 << 22):
    (tk, bounds, tile), arrays = FA_LOOPS[loop]()
    data = dict(zip(tk.data_specs, arrays))
    b = TaskGraphBuilder()
    total = tfa.seed_tiles(b, bounds, tile)
    out = {}
    for d in ("cuda", "cpu"):
        mk = tfa.make_forasync_megakernel(tk, width=width, prefetch=prefetch,
                                          capacity=total + 8, device=d)
        out[d] = _raw(mk, b, fuel=fuel, data=data)
    return out["cuda"], out["cpu"], arrays


@pytest.mark.parametrize("width,prefetch", [(0, True), (4, True), (4, False),
                                            (8, True), (8, False)])
@pytest.mark.parametrize("loop", sorted(FA_LOOPS))
def test_forasync_equals_plain(card, loop, width, prefetch):
    """The scalar and batched tile bodies against the plain core: the whole
    output state, tstats and both buffers (halo included) word for word,
    and the output equal to the numpy reference."""
    got, want, (src, _) = _fa_pair(loop, width, prefetch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = (tw.stencil_reference(src) if loop.startswith("stencil")
           else tw.map_reference(src))
    dst = got["data.gout" if loop.startswith("stencil") else "data.vout"]
    assert np.array_equal(dst.numpy(), ref)
    if width and prefetch:
        assert int(want["tstats"][4]) > 0  # prefetch hits


@pytest.mark.parametrize("loop", ["stencil", "map"])
def test_forasync_fuel_cut_equals_plain(card, loop):
    """Cut by fuel mid-loop at width 8 with the prefetch: lane entries
    spill to the ring head, no copy outlives the run, state equal."""
    got, want, _ = _fa_pair(loop, 8, True, fuel=20)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["tstats"][6]) > 0 and int(want["counts"][3]) > 0


def test_arrayadd_equals_plain(card):
    b = TaskGraphBuilder()
    for t in range(64):
        b.add(tw.ADD_TILE, args=[t])
    rng = np.random.default_rng(2)
    data = {k: rng.standard_normal((64, 8, 128)).astype(np.float32)
            for k in ("a", "b")}
    data["c"] = np.zeros((64, 8, 128), np.float32)
    got, want = (_raw(tw.make_arrayadd_megakernel(64, device=d), b,
                      data=data) for d in ("cuda", "cpu"))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["data.c"],
                       torch.from_numpy(data["a"] + data["b"]))
    a, b_, c, info = tw.device_arrayadd(16)
    assert np.array_equal(c.cpu().numpy(), a + b_) and info["executed"] == 16


@pytest.mark.parametrize("width,prefetch", [(0, True), (8, True),
                                            (8, False)])
def test_tile_rounds_equal_plain(card, width, prefetch):
    """The standalone tile entry (no scheduler) against the plain rounds."""
    (tk, bounds, tile), (gin, gout) = FA_LOOPS["stencil_odd"]()
    args = tfa.tile_arg_table(bounds, tile)
    outs = {}
    for d in ("cuda", "cpu"):
        mk = tfa.make_forasync_megakernel(tk, width=width, prefetch=prefetch,
                                          device=d)
        data = {"gin": torch.from_numpy(gin).to(d),
                "gout": torch.from_numpy(gout).to(d)}
        tfa.tile_rounds(mk, args, data)
        outs[d] = data["gout"].cpu()
    assert torch.equal(outs["cuda"], outs["cpu"])
    assert np.array_equal(outs["cuda"].numpy(), tw.stencil_reference(gin))


# The graph frontier and branch-and-bound in the policy instance (kMode 4):
# bench_graph's R-MAT parameters at scale 7, and the 12-item knapsack.
FR_GRAPH = tf.Graph(*tw.rmat_edges(7, efactor=8, seed=7))


def _fr_pair(kind, width, fuel=1 << 22, nbk=0):
    outs = []
    for d in ("cuda", "cpu"):
        fk = tf.pagerank_kernel() if kind == "pagerank" \
            else tf._KINDS[kind]()
        mk = tf.make_frontier_megakernel(fk, FR_GRAPH, width=width,
                                         capacity=2048, priority_buckets=nbk,
                                         device=d)
        b, iv, data = tf.frontier_state(kind, FR_GRAPH, mk, m0=1 << 12)
        outs.append(_raw(mk, b, fuel=fuel, data=data, ivalues=iv))
    return outs


@pytest.mark.parametrize("width,fuel", [(0, 1 << 22), (8, 1 << 22),
                                        (8, 60)])
@pytest.mark.parametrize("kind", ["bfs", "sssp", "pagerank"])
def test_frontier_equals_plain(card, kind, width, fuel):
    """Scalar, width 8 with the edge-slab prefetch and the age trigger,
    and cut by fuel with a prefetch in flight (the spill word for word)."""
    got, want = _fr_pair(kind, width, fuel)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if fuel < 1 << 22:
        assert int(want["tstats"][6]) > 0  # spilled
    elif kind != "pagerank":
        st = FR_GRAPH.st_base
        ref = tf.host_bfs(FR_GRAPH) if kind == "bfs" else tf.host_sssp(
            FR_GRAPH)
        assert np.array_equal(got["ivalues"][st:st + FR_GRAPH.n].numpy(),
                              ref)


def test_delta_sssp_equals_plain(card):
    got, want = _fr_pair("sssp", 8, nbk=8)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["tstats"][10]) > 0  # bucket fires


@pytest.mark.parametrize("width,nbk", [(0, 0), (4, 0), (4, 8)])
def test_bnb_equals_plain(card, width, nbk):
    kp = tb.make_knapsack(12, seed=5)
    outs = []
    for d in ("cuda", "cpu"):
        mk = tb.make_bnb_megakernel(kp, width=width, priority_buckets=nbk,
                                    device=d)
        b, iv = tb.bnb_state(kp, mk)
        outs.append(_raw(mk, b, ivalues=iv))
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert int(outs[0]["ivalues"][tb.V_BEST]) == tb.host_knapsack_opt(kp)


@pytest.mark.parametrize("name", ["fib9_age1", "fib10_buckets4_age3"])
def test_policy_instance_fib_equals_plain(card, name):
    """The age and bucket policies on the fib bodies (the fault the port
    had: HCLIB_TPU_LANE_MAX_AGE=1 at width 4)."""
    outs = []
    for d in ("cuda", "cpu"):
        if name == "fib9_age1":
            mk = tmk.Megakernel(["fib", "sum"], route={
                "fib": tmk.BatchSpec(4)}, capacity=64,
                num_values=4 * 64 + 16, succ_capacity=64,
                uses_row_values=True, lane_max_age=1, device=d)
        else:
            mk = tmk.Megakernel(["fib", "sum"], route={
                "fib": tmk.BatchSpec(2, priority=("div", 0, 1))},
                capacity=128, num_values=4 * 128 + 16, succ_capacity=8,
                uses_row_values=True, priority_buckets=4, lane_max_age=3,
                device=d)
        b = TaskGraphBuilder()
        b.add(tw.FIB, args=[9 if name == "fib9_age1" else 10], out=0)
        outs.append(_raw(mk, b))
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    if name == "fib9_age1":
        assert outs[0]["tstats"][8] == 100 and outs[0]["counts"][2] == 11


@pytest.mark.parametrize("width", [0, 8])
def test_expand_rounds_equal_plain(card, width):
    """The standalone EXPAND entry (no scheduler) on the seed rows."""
    outs = []
    for d in ("cuda", "cpu"):
        mk = tf.make_frontier_megakernel(tf.sssp_kernel(), FR_GRAPH,
                                         width=width, capacity=2048,
                                         device=d)
        b, iv, data = tf.frontier_state("sssp", FR_GRAPH, mk)
        st = mk.state(b, data=data, ivalues=iv)
        tf.expand_rounds(mk, st, range(int(st["counts"][2])))
        outs.append({k: st[k].cpu() for k in ("tasks", "ready", "counts",
                                               "ivalues")})
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# The dynamic-graph tier: the JAX tests' graph and stream, and a stream
# that fills vertex 0's full block, takes its spare rows and then drops.
DG_GRAPH = tw.rmat_edges(5, efactor=4, seed=9)
DG_UPS = [(1, 5, 3), (2, 7, 1), (0, 9, 2), (4, 3, 6)]
DG_FULL = (8, np.concatenate([np.zeros(128, np.int64), [1]]),
           np.concatenate([1 + np.arange(128) % 7, [2]]).astype(np.int64))
DG_SPARE_UPS = [(0, 1 + i % 7, 1 + i % 3) for i in range(132)] + [(1, 3, 1)]


def _dg_graph(name):
    if name == "jax_tests":
        return td.DynGraph(*DG_GRAPH, spare_blocks=2, upd_cap=16), DG_UPS
    n, src, dst = DG_FULL
    spare = 0 if name == "exhaustion" else 1
    ups = [(0, 7, 1), (1, 3, 1)] if name == "exhaustion" else DG_SPARE_UPS
    return td.DynGraph(n, src, dst, np.ones(len(src), np.int64),
                       spare_blocks=spare, upd_cap=160), ups


def _dg_raw(name, kind, width, nbk=0, fuel=1 << 22, reps=1):
    outs = []
    for d in ("cuda", "cpu"):
        g, ups = _dg_graph(name)
        for up in ups:
            g.add_update(*up)
        mk = td.make_dyngraph_megakernel(
            kind, g, width=width, priority_buckets=nbk,
            capacity=768 if kind == "pagerank" else 512, device=d)
        b, iv, data = td.dyngraph_state(kind, g, mk, queries=[0, 5, 7],
                                        m0=4096)
        outs.append(_raw(mk, b, reps=reps, fuel=fuel, data=data,
                         ivalues=iv))
    return outs


@pytest.mark.parametrize("name,kind,width,nbk,fuel", [
    ("jax_tests", "sssp", 0, 0, 1 << 22), ("jax_tests", "bfs", 4, 0, 1 << 22),
    ("jax_tests", "bfs", 4, 2, 1 << 22), ("jax_tests", "pagerank", 0, 0,
                                          1 << 22),
    ("jax_tests", "pagerank", 4, 0, 1 << 22), ("jax_tests", "sssp", 4, 0, 40),
    ("spares", "sssp", 0, 0, 1 << 22), ("spares", "sssp", 4, 0, 1 << 22),
    ("spares", "bfs", 4, 2, 1 << 22)])
def test_dyngraph_equals_plain(card, name, kind, width, nbk, fuel):
    """The UPDATE, QUERY and clamped EXPAND bodies on the whole state,
    both edge buffers included."""
    got, want = _dg_raw(name, kind, width, nbk, fuel)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if name == "spares":
        assert int(want["ivalues"][td.V_FREE]) == 1
        assert int(want["ivalues"][td.V_DROPPED]) > 0


def test_dyngraph_reps_equal_plain(card):
    """reps=2 re-stages the state but not the edge buffers (as JAX)."""
    got, want = _dg_raw("spares", "sssp", 0, reps=2)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_dyngraph_exhaustion_raises_like_plain(card):
    got, want = _dg_raw("exhaustion", "bfs", 0)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    g, ups = _dg_graph("exhaustion")
    with pytest.raises(RuntimeError, match="overflow"):
        td.run_dyngraph("bfs", g, 0, updates=ups, width=0, device="cuda")


@pytest.mark.parametrize("width", [0, 8])
def test_run_dyngraph_equals_host(card, width):
    g, ups = _dg_graph("jax_tests")
    r, info = td.run_dyngraph("sssp", g, 0, updates=ups, queries=[5],
                              width=width, device="cuda")
    assert np.array_equal(r, td.host_dyngraph("sssp", g, 0))
    assert info["updates_applied"] == len(ups) and info["dropped"] == 0


# The flight recorder and the quiesce poll (the observed instances): a
# traced, checkpoint-built run, then one quiesced at a round boundary on a
# ring a quarter of the full run's records (its cursor wraps) and resumed,
# on the card and on the plain core, in each of instances 0-5.
def _obs_cases():
    """name -> (make(device, ring capacity), builder, data, ivalues,
    quiesce)."""
    def obs(cap):
        return dict(trace=cap, checkpoint=True)
    fib = TaskGraphBuilder()
    fib.add(tw.FIB, args=[11], out=0)
    uts = TaskGraphBuilder()
    uts.add(tw.UTS_NODE, args=[1, 0])
    routed = TaskGraphBuilder()
    t0 = routed.add(tw.FIB, args=[9], out=0)
    t1 = routed.add(tw.FIB, args=[10], out=1)
    routed.add(tw.SUM, args=[0, 1], deps=[t0, t1], out=2)
    routed.reserve_values(3)
    a, b = random_seq(512, 5), random_seq(512, 6)
    sw = ts.sw_wave_buffers(a, b)
    sw["htiles"] = np.zeros((4, 4, 128, 128), np.int32)
    (stk, bounds, tile), arrays = FA_LOOPS["stencil"]()
    stencil = TaskGraphBuilder()
    ntiles = tfa.seed_tiles(stencil, bounds, tile)
    g = DG_GRAPH
    cases = {
        "fib11_lean": (lambda d, c: tw.make_fib_megakernel(
            768, quiesce_stride=4, device=d, **obs(c)), fib, None, None, 300),
        "uts_w8": (lambda d, c: tw.make_uts_megakernel(
            batch_width=8, device=d, **obs(c)), uts, None, None, 2000),
        "sw512_w2": (lambda d, c: ts.make_sw_wave_megakernel(
            4, 4, chunk=1, width=2, device=d, **obs(c)),
            ts.build_sw_wave_graph(4, 4, chunk=1), sw, None, 7),
        "vector_routed": (lambda d, c: tmk.Megakernel(
            ["fib", "sum"], route={"fib": tv.fib_spec(14, (1, 8))},
            capacity=16, num_values=16, succ_capacity=8, device=d, **obs(c)),
            routed, None, None, 1),
        "stencil_w8": (lambda d, c: tfa.make_forasync_megakernel(
            stk, width=8, capacity=ntiles + 8, device=d, **obs(c)), stencil,
            dict(zip(stk.data_specs, arrays)), None, 20),
    }
    for key, nbk in (("sssp_b8", 8),):
        def make(d, c=4096, nbk=nbk):
            return tf.make_frontier_megakernel(
                tf.sssp_kernel(), FR_GRAPH, width=8, capacity=2048,
                priority_buckets=nbk, device=d, **obs(c))
        mk = make("cpu")
        fb, iv, data = tf.frontier_state("sssp", FR_GRAPH, mk)
        cases[key] = (make, fb, data, iv, 100)
    dg = td.DynGraph(*g, spare_blocks=2, upd_cap=16)
    for up in DG_UPS:
        dg.add_update(*up)

    def make_dg(d, c=4096):
        mk = td.make_dyngraph_megakernel("sssp", dg, width=4, capacity=512,
                                         device=d, **obs(c))
        td._bind_updates(mk, dg)
        return mk
    db, div, ddata = td.dyngraph_state("sssp", dg, make_dg("cpu"),
                                       queries=[0, 5])
    cases["dyngraph_w4"] = (make_dg, db, ddata, div, 6)
    return cases


OBS = _obs_cases()


@pytest.mark.parametrize("name", sorted(OBS))
def test_observed_instances_equal_plain(card, name):
    """The decoded ring and its header, qstat and the whole output state of
    a traced run and of a quiesced one equal the plain core's; the
    quiesced state resumes to the same final state on both."""
    make, b, data, iv, q = OBS[name]
    res = {}
    for d in ("cuda", "cpu"):
        mk = make(d, 4096)
        full = _raw(mk, b, data=data, ivalues=iv)
        wrap = max(1, int(full["trace.header"][0]) // 4)
        cut = _raw(make(d, wrap), b, data=data, ivalues=iv, quiesce=q)
        ivr, dr, info = mk.resume(
            mk.run(b, data=data, ivalues=iv, quiesce=q)[2]["state"])
        res[d] = (full, cut, ivr, {k: v.cpu() for k, v in dr.items()}, info)
    (fg, cg, ivg, dg_, ig), (fw, cw, ivw, dw, iw) = res["cuda"], res["cpu"]
    for got, want in ((fg, fw), (cg, cw)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert int(cw["qstat"][0]) == 1 and int(fw["qstat"][0]) == 0
    assert int(cw["counts"][3]) > 0  # quiesced mid-graph
    assert int(cw["trace.header"][0]) > len(cw["trace.records"]) == wrap
    assert np.array_equal(ivg, ivw) and ig["executed"] == iw["executed"]
    for k in dw:
        assert torch.equal(dg_[k], dw[k]), k
    assert iw["pending"] == 0


# ------------------------------------------------- the streaming front door

STREAM_CASES = ("fib_firehose", "lanes_park", "expiry_quarantine", "abort",
                "quiesce_restore", "serve7", "frontier9")


def _stream_holds():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import stream_holds

    return stream_holds


@pytest.mark.parametrize("trace", [None, 256])
@pytest.mark.parametrize("name", STREAM_CASES)
def test_stream_equals_plain(card, name, trace):
    """The stream kernel (csrc/stream.cuh, instances 0, 4 and 5) against
    the plain stream: every entry's echoed control block, the final
    state, the futures, the info and the decoded trace records."""
    h = _stream_holds()
    assert set(STREAM_CASES) == set(h.CASES)
    h.compare(h.run_case(name, "cuda", trace), h.run_case(name, "cpu", trace))


def test_stream_refuses_tables_without_an_instance(card):
    from hclib_tpu_torch.device.inject import StreamingMegakernel

    mk = tc.make_cholesky_megakernel(2, tile=64, fused_only=True,
                                     batch_updrow=False, device="cuda")
    sm = StreamingMegakernel(mk)
    sm.close()
    with pytest.raises(NotImplementedError, match="A14"):
        sm.run_stream(tc.build_cholesky_graph(2))


MESH_CASES = ("sharded_nosteal_8", "sharded_steal_8", "sharded_steal_8_b8",
              "sharded_hop_4", "ring_3", "ring_6", "ring_6_abort",
              "ring_3_b8", "ring_1", "resident_2", "resident_4",
              "resident_8_hops", "resident_8_abort", "resident_8_b8",
              "user_sharded_8", "user_resident_8", "pgas_2", "pgas_4",
              "pgas_8", "pgas_steal_8", "homed_2", "homed_8", "homed_3d",
              "homed_8_b8", "atomics_4", "inject_steal_8", "inject_pgas_4",
              "inject_pgas_steal_8", "compose_4", "five_way_1", "volume_1",
              "tenants_4", "fault_steal_8", "fault_steal_8_b8",
              "fault_user_steal_4", "fault_pgas_steal_8", "fault_credits_2",
              "fault_dead_4", "fault_wedge_2")


def _mesh_holds():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import mesh_holds

    return mesh_holds


@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_equals_plain(card, name):
    """The mesh kernels (csrc/mesh.cuh: the sharded runner's grid launch,
    the ring, the resident kernel steal-only and its PGAS configuration;
    csrc/user.cuh's scheduler for user tables) against their plain
    versions: every device's value slots and counts row, the rounds, the
    tier counters, the fault stats, the rows each device exported, the
    messages and puts it sent and the data buffers."""
    h = _mesh_holds()
    assert set(MESH_CASES) == set(h.CASES)
    h.compare(h.run_case(name, "cuda"), h.run_case(name, "cpu"), name)


@pytest.mark.parametrize("kind", ["ici_ring", "resident_steal"])
def test_mesh_refuses_more_ctas_than_the_card_holds(card, kind):
    """A steal kernel's CTAs spin on each other: a mesh larger than the
    co-resident CTA count is refused before any launch."""
    from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
    from hclib_tpu_torch.parallel.mesh import cuda_mesh

    limit = tmk.mesh_coresident(kind, 0)
    assert 1 <= limit <= torch.cuda.get_device_properties(0) \
        .multi_processor_count
    ndev = limit + 1
    if kind == "resident_steal":
        ndev = 1 << limit.bit_length()  # a power of two above the limit
    elif ndev & (ndev - 1) == 0:
        ndev += 1  # the ring runs on meshes that are not powers of two
    mk = tw.make_fib_megakernel(64, device="cuda")
    bs = [TaskGraphBuilder() for _ in range(ndev)]
    bs[0].add(tw.FIB, args=[5], out=0)
    m = ICIStealMegakernel(mk, cuda_mesh(ndev), migratable_fns=[tw.FIB])
    with pytest.raises(RuntimeError, match=f"holds {limit} at once"):
        m.run(bs)


def test_mesh_spin_timeout_raises(card):
    """A wait past its deadline stops the mesh and raises with the
    device, round, hop and wait (a zero deadline: the first wait that is
    not met at once)."""
    h = _mesh_holds()
    from hclib_tpu_torch.device import stress
    from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
    from hclib_tpu_torch.parallel.mesh import cuda_mesh

    m = ICIStealMegakernel(stress.forest_megakernel(h.ROOTS, h.CAP),
                           cuda_mesh(2), migratable_fns=[tw.FIB])
    m.timeout_s = 0.0
    with pytest.raises(RuntimeError, match="timed out"):
        m.run(h.builders(2, False), quantum=64)


@pytest.mark.parametrize("name", ["chain_free", "mixed", "ufib"])
def test_user_table_equals_plain(card, name):
    """A user-body table on one device (csrc/user.cuh mk_user_kernel:
    the alloc/free chain, fib and sum beside a user BUMP, fib written as
    user bodies) against the plain core: the task table, ready ring,
    counts and value slots."""
    h = _mesh_holds()
    assert set(h.USER_CASES) == {"chain_free", "mixed", "ufib"}
    got, want = h.run_user_case(name, "cuda"), h.run_user_case(name, "cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_user_forest_equals_plain(card):
    """A forest of user-written fib roots through the sharded runner's
    grid launch of the user library's scheduler, one CTA a device: every
    device's value slots and counts row as the plain version's."""
    h = _mesh_holds()
    (iv_c, ic), (iv_p, ip) = (h.user_forest(16, 128, 9, d)
                              for d in ("cuda", "cpu"))
    np.testing.assert_array_equal(iv_c, iv_p)
    np.testing.assert_array_equal(ic["per_device_counts"],
                                  ip["per_device_counts"])


def test_user_library_holds_one_variant(card):
    """A table's library holds the instances of one variant: a table
    without ctx.pgas launched under the PGAS configuration builds and
    runs the PGAS variant, and the non-PGAS variant refuses a PGAS
    launch."""
    from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel
    from hclib_tpu_torch.parallel.mesh import cuda_mesh

    mk = tmk.Megakernel(
        [("b", lambda ctx: ctx.set_value(0, ctx.value(0) + 1),
          "ctx.set_value(0, ctx.value(0) + 1);")],
        data_specs={"heap": ((4, 128), torch.int32)}, capacity=8,
        num_values=8, succ_capacity=8)
    bs = [TaskGraphBuilder() for _ in range(2)]
    bs[1].add(0)
    pg = PGASMegakernel(mk, cuda_mesh(2), channels={"c0": ("heap", 1)})
    iv, _, info = pg.run(bs, data={"heap": np.zeros((2, 4, 128), np.int32)})
    assert iv[:, 0].tolist() == [0, 1] and info["pending"] == 0
    out = ctypes.c_int(0)
    lib = mk.user_library(False)
    fn = lib.hclib_user_coresident
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    assert fn(2, 0, 0, 1, ctypes.byref(out)) != 0  # no PGAS instance
    assert fn(2, 0, 1, 0, ctypes.byref(out)) == 0 and out.value >= 1


def test_user_library_that_does_not_build_raises(card):
    """nvcc's refusal of a user body comes back as the error, with its
    stderr; nothing runs the Python body instead."""
    mk = tmk.Megakernel([("bad", lambda ctx: None, "this is not C++;")],
                        capacity=8, num_values=8, succ_capacity=8)
    b = TaskGraphBuilder()
    b.add(0)
    with pytest.raises(RuntimeError, match="nvcc failed") as e:
        mk.run(b)
    assert "error" in str(e.value)


def test_pgas_protocol_fault_stops_the_mesh(card):
    """A put on an undeclared channel stops the mesh and raises naming
    it, on the card as the plain version raises."""
    from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel
    from hclib_tpu_torch.parallel.mesh import cuda_mesh

    mk = tmk.Megakernel(
        [("p", lambda ctx: ctx.pgas.put(1, 3, 0, 0),
          "ctx.pgas.put(1, 3, 0, 0);")],
        data_specs={"heap": ((4, 128), torch.int32)}, capacity=8,
        num_values=8, succ_capacity=8)
    bs = [TaskGraphBuilder() for _ in range(2)]
    bs[0].add(0)
    pg = PGASMegakernel(mk, cuda_mesh(2), channels={"c0": ("heap", 1)})
    with pytest.raises(RuntimeError, match="undeclared channel"):
        pg.run(bs, data={"heap": np.zeros((2, 4, 128), np.int32)})


def test_lock_fifo_overflow_raises_on_card(card):
    """Four lockers on a lock whose FIFO holds one waiter: the owner CTA
    sets OVF_LOCKQ and the run raises naming the lock FIFO, as the plain
    version does."""
    from hclib_tpu_torch.device.resident import (ResidentKernel,
                                                 lock_block_slots)
    from hclib_tpu_torch.parallel.mesh import cpu_mesh, cuda_mesh

    def lock1(ctx):
        row = ctx.spawn(1, dep_count=1)
        ctx.pgas.lock(0, 8, row, 1)

    def crit(ctx):
        ctx.pgas.unlock(0, 8, 1)

    for device, mesh in (("cuda", cuda_mesh(4)), ("cpu", cpu_mesh(4))):
        mk = tmk.Megakernel(
            [("lock1", lock1, """
  const int row = ctx.spawn(1, nullptr, 0, 1);
  ctx.pgas.lock(0, 8, row, 1);"""),
             ("crit", crit, "ctx.pgas.unlock(0, 8, 1);")],
            capacity=16, num_values=32, succ_capacity=8, device=device)
        bs = [TaskGraphBuilder() for _ in range(4)]
        for b in bs:
            b.add(0)
            b.reserve_values(8 + lock_block_slots(1))
        with pytest.raises(RuntimeError, match="lock FIFO"):
            ResidentKernel(mk, mesh, steal=False).run(bs)


def test_builtin_only_homed_library_holds(card):
    """A table of built-in bodies alone (fib and sum) runs the migrating
    configuration from a user library with no user body: it builds,
    holds the migrating instance only, and equals the plain run word for
    word (value slots, counts, rounds, proxies, built-in messages)."""
    h = _mesh_holds()
    mk = h.homed_megakernel(64, 0, "cuda")
    assert not mk.user_bodies
    src = mk.user_source(True, home=True)
    assert "#define HCLIB_USER_PGAS 2" in src and "user_body_0" not in src
    lib = mk.user_library(True, home=True)
    out = ctypes.c_int(0)
    fn = lib.hclib_user_coresident
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    assert fn(2, 0, 1, 2, ctypes.byref(out)) == 0 and out.value >= 8
    assert fn(0, 0, 1, 0, ctypes.byref(out)) != 0  # no mk_user_kernel
    h.compare(h.run_case("homed_3d", "cuda"), h.run_case("homed_3d", "cpu"),
              "homed_3d")


PHASE29 = ("compose_4", "five_way_1", "volume_1", "inject_128", "tenants_128")


@pytest.mark.parametrize("arm", PHASE29)
def test_inject_phase_arm_equals_plain(card, arm):
    """chip_smoke.py's phase 29 arms (the resident kernel's injecting
    instances): JAX's three compositions that inject, the forest with 256
    injected FIB rows on every ring of 128 CTAs and the four tenant lanes
    on 128 CTAs, each exact (JAX's assertions) and equal to its plain run
    word for word: value slots, counts, rounds, fault stats, the heap,
    and the tctl echo and the table's stats on the tenant mesh."""
    h = _mesh_holds()
    assert set(PHASE29) == set(h.PHASE29)
    h.compare(h.run_arm(arm, "cuda"), h.run_arm(arm, "cpu"), arm)


def test_inject_library_holds_only_injecting_instances(card):
    """A table's injecting library (HCLIB_USER_INJECT) holds the resident
    kernel's injecting instance of its variant alone, and a launch
    without the ring (or a plain library's launch with one) is refused
    before the kernel runs."""
    h = _mesh_holds()
    mk = h.homed_megakernel(64, 0, "cuda")
    src = mk.user_source(False, inject=True)
    assert "#define HCLIB_USER_INJECT 1" in src
    lib = mk.user_library(False, inject=True)
    out = ctypes.c_int(0)
    fn = lib.hclib_user_coresident
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    assert fn(2, 0, 1, 0, ctypes.byref(out)) == 0 and out.value >= 8
    assert fn(0, 0, 1, 0, ctypes.byref(out)) != 0  # no mk_user_kernel
    assert fn(1, 0, 1, 0, ctypes.byref(out)) != 0  # no ring kernel
    launch = lib.hclib_user_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [ctypes.POINTER(tmk.MeshHost)] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    host = tmk.MeshHost()
    host.ndev = 2
    assert launch(ctypes.byref(host), 2, 0, 1, 0, None) != 0


PHASE30 = ("drop_2", "dup_2", "delay_2", "wedge_2", "dead_8", "uts_16",
           "forest_16")


@pytest.mark.parametrize("arm", PHASE30)
def test_fault_phase_arm_equals_plain(card, arm):
    """chip_smoke.py's phase 30 arms (resident_kernel<.., kFault>): JAX's
    fault tests at their shapes (the dropped, duplicated and delayed
    credit and the credit_timeout=0 plans on 2 CTAs, the dead chip on 8),
    UTS depth 20 on 16 CTAs with a dead device and credit faults, and the
    forest steal-only on 16 CTAs with its whole queue re-homed: each
    exact (JAX's assertions; the wedge raising its StallError) and equal
    to its plain run word for word, fault stats included."""
    h = _mesh_holds()
    assert set(PHASE30) == set(h.PHASE30)
    got, want = h.run_fault_arm(arm, "cuda"), h.run_fault_arm(arm, "cpu")
    h.compare(got, want, arm)
    if arm == "wedge_2":
        assert got["stall"] == want["stall"]


def test_fault_libraries_hold_only_fault_instances(card):
    """A table's library with the fault layer (HCLIB_USER_FAULT) holds the
    resident kernel's fault instance of its variant alone; a launch
    without the plan (or a plain library's with one) is refused before
    the kernel runs, and so is the built-in library's fault mode without
    a plan."""
    from hclib_tpu_torch import _build
    from hclib_tpu_torch.device import stress

    mk = stress.fault_megakernel(64, "cuda")
    assert "#define HCLIB_USER_FAULT 1" in mk.user_source(True, True,
                                                          fault=True)
    out = ctypes.c_int(0)
    for variant, pgas, home in ((0, False, False), (1, True, False),
                                (2, True, True)):
        lib = mk.user_library(pgas, home, fault=True)
        fn = lib.hclib_user_coresident
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        assert fn(2, 0, 1, variant, ctypes.byref(out)) == 0
        assert out.value >= 16
        assert fn(2, 0, 0, variant, ctypes.byref(out)) != 0  # steal=False
        assert fn(0, 0, 1, variant, ctypes.byref(out)) != 0
        launch = lib.hclib_user_launch
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.POINTER(tmk.MeshHost)] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        host = tmk.MeshHost()
        host.ndev = 2
        assert launch(ctypes.byref(host), 2, 0, 1, variant, None) != 0
    assert tmk.mesh_coresident("resident_steal", 2) >= 16
    lib = _build.library("megakernel")
    fn = lib.hclib_mesh_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(tmk.MeshHost)] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    host = tmk.MeshHost()
    host.ndev = 2
    assert fn(ctypes.byref(host), 2, 2, 1, 0, None) != 0  # no plan
    assert fn(ctypes.byref(host), 1, 2, 1, 0, None) != 0  # ring: no mode 2


OBS_CASES = ("obs_uts_2", "obs_uts_8", "obs_uts_wrap_2", "obs_uts_b4_4",
             "obs_forest_8", "obs_ring_3", "obs_ring_3_b8",
             "obs_fault_steal_8", "obs_fault_steal_8_b8", "obs_waits_2",
             "obs_homed_2", "obs_inject_4", "obs_inject_q2_4",
             "obs_tenants_4", "obs_fault_credits_2", "obs_waits_8",
             "obs_inject_8", "obs_tenants_8", "obs_fault_credits_8",
             "obs_fault_credits_ckpt_8")


@pytest.mark.parametrize("name", OBS_CASES)
def test_observed_mesh_equals_plain(card, name):
    """The observed instances (kObs: resident_kernel's flight recorder
    and quiesce word in megakernel.cu's steal-only instances, with and
    without lanes and the fault layer, and in the user libraries' PGAS,
    migrating, injecting, tenant and fault variants; ici_ring_kernel's
    recorder) against their plain versions word for word: the state each
    quiesce exports, the wait table, the ring residue and ictl, every
    device's decoded records, and the resumed run."""
    h = _mesh_holds()
    assert set(OBS_CASES) == set(h.OBS_CASES)
    h.compare(h.run_obs_case(name, "cuda"), h.run_obs_case(name, "cpu"),
              name)


def test_traced_user_table_refuses_its_one_device_launch(card):
    """A traced or checkpoint-built user table records and quiesces on
    the card under the resident kernel and the ring; its one-device
    scheduler (mk_user_kernel) has no recorder and refuses (A4)."""
    from hclib_tpu_torch.device import stress

    for kw in (dict(trace=64), dict(checkpoint=True)):
        mk = tmk.Megakernel([("bump", stress._bump0, stress.BUMP0_CUDA)],
                            capacity=64, num_values=8, succ_capacity=8,
                            device="cuda", **kw)
        b = TaskGraphBuilder()
        b.add(0, args=[1])
        with pytest.raises(NotImplementedError, match="A4"):
            mk.run(b)


RING_CASES = ("ring_pgas_3", "ring_pgas_6", "ring_pgas_3_traced",
              "ring_pgas_6_traced", "ring_abort_6", "ring_dryrun4_3",
              "ring_dryrun4_6", "ring_fan_6_b8")


@pytest.mark.parametrize("name", RING_CASES)
def test_pgas_ring_equals_plain(card, name):
    """PGASMegakernel's ring kernel (csrc/mesh.cuh pgas_ring_kernel, a
    mesh whose size is not a power of two) at 3 and 6 CTAs, traced and
    not, against its plain version: every device's value slots and counts
    row, the rounds, the tier counters, aborted, the messages, puts and
    stat words sent, the heap and every device's decoded records."""
    h = _mesh_holds()
    assert set(RING_CASES) == set(h.RING_CASES)
    h.compare(h.run_ring_case(name, "cuda"), h.run_ring_case(name, "cpu"),
              name)


def test_pgas_ring_refusals_on_card(card):
    """The ring kernel's ctx.pgas has no atomics: a CUDA body calling one
    stops the mesh with its error; a mesh of more CTAs than the card
    holds at once is refused with a ValueError naming the limit."""
    from hclib_tpu_torch.device import stress
    from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel
    from hclib_tpu_torch.parallel.mesh import cuda_mesh

    mk = tmk.Megakernel(
        [("f", lambda ctx: ctx.pgas.fadd(1, 0, 1),
          "ctx.pgas.fadd(1, 0, 1);")],
        data_specs={"heap": ((4, 128), torch.int32)}, capacity=8,
        num_values=8, succ_capacity=8)
    bs = [TaskGraphBuilder() for _ in range(3)]
    bs[0].add(0)
    with pytest.raises(RuntimeError, match="ring kernel"):
        PGASMegakernel(mk, cuda_mesh(3), channels={"c0": ("heap", 1)}).run(
            bs, data={"heap": np.zeros((3, 4, 128), np.int32)})
    mk = stress.put_consume_megakernel()
    limit = mk.coresident("pgas_ring", 0, pgas=True, steal=False)
    assert 1 <= limit <= torch.cuda.get_device_properties(0) \
        .multi_processor_count
    ndev = limit + 1 if limit & (limit + 1) else limit + 2
    bs, waits, heap = stress.dryrun_builders(4, ndev)
    with pytest.raises(ValueError, match=f"holds {limit} at once"):
        PGASMegakernel(mk, cuda_mesh(ndev), channels={"c0": ("heap", 1)}
                       ).run(bs, data={"heap": heap}, waits=waits)
