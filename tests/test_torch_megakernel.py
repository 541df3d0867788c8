"""The port's scheduler against the JAX megakernel: the raw kernel outputs
of ``jax.jit(mk._build_raw(fuel))`` in interpret mode and the port's
``Megakernel.launch`` on the CPU, fed identical state, must agree word
for word across the task table, ready ring, counts and value slots."""

import jax
import numpy as np
import pytest
import torch

from hclib_tpu.device import megakernel as jmk
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder

FUEL = 1 << 22


def _fib_graph(B, n):
    b = B()
    b.add(jw.FIB, args=[n], out=0)
    return b, None


def _csr_graph(B, num_values):
    """tests/test_device.py:53-68: A -> B0..B4 -> C over preset slots."""
    b = B()
    a = b.add(jw.SUM, args=[0, 1], out=2)
    bs = [b.add(jw.SUM, args=[2, 0], out=4 + i, deps=[a]) for i in range(5)]
    b.add(jw.SUM, args=[4, 5], out=3, deps=bs)
    iv = np.zeros(num_values, np.int32)
    iv[0], iv[1] = 1, 2
    return b, iv


def _uts_graph(B):
    b = B()
    b.add(jw.UTS_NODE, args=[1, 0])
    return b, None


def _staged(mk, b, ivalues):
    tasks, succ, ring, counts = b.finalize(
        capacity=mk.capacity, succ_capacity=mk.succ_capacity
    )
    if ivalues is None:
        ivalues = np.zeros(mk.num_values, np.int32)
    else:
        counts = counts.copy()
        jmk.Megakernel.widen_value_alloc(counts, ivalues)
    return tasks, succ, ring, counts, ivalues


def _jax_raw(mk, staged):
    with jax.default_device(jax.devices("cpu")[0]):
        outs = jax.jit(mk._build_raw(FUEL))(*staged)
    return [np.asarray(o) for o in outs[:4]]


def _port_raw(mk, staged):
    st = state.from_numpy(*staged, device="cpu")
    disp = mk.launch(st, FUEL)
    tasks, _, ready, counts, ivalues, _ = state.to_numpy(st)
    return [tasks, ready, counts, ivalues], mk.fold_dispatches(disp)


CASES = {
    "fib11": (lambda: jw.make_fib_megakernel(768, interpret=True),
              lambda: tw.make_fib_megakernel(768, device="cpu"),
              lambda B, nv: _fib_graph(B, 11)),
    "csr_fanout": (lambda: jw.make_fib_megakernel(64, interpret=True),
                   lambda: tw.make_fib_megakernel(64, device="cpu"),
                   _csr_graph),
    "uts_default": (lambda: jw.make_uts_megakernel(interpret=True),
                    lambda: tw.make_uts_megakernel(device="cpu"),
                    lambda B, nv: _uts_graph(B)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def raw_pair(request):
    make_j, make_t, graph = CASES[request.param]
    mj, mt = make_j(), make_t()
    bj, ivj = graph(JBuilder, mj.num_values)
    bt, ivt = graph(TBuilder, mt.num_values)
    sj = _staged(mj, bj, ivj)
    st = _staged(mt, bt, ivt)
    for x, y in zip(sj, st):
        assert x.tobytes() == y.tobytes()
    port, disp = _port_raw(mt, st)
    return request.param, _jax_raw(mj, sj), port, disp


@pytest.mark.parametrize("part", ["tasks", "ready", "counts", "ivalues"])
def test_raw_state_word_for_word(raw_pair, part):
    _, jax_out, port_out, _ = raw_pair
    i = ["tasks", "ready", "counts", "ivalues"].index(part)
    assert jax_out[i].dtype == port_out[i].dtype == np.int32
    assert jax_out[i].shape == port_out[i].shape
    assert np.array_equal(jax_out[i], port_out[i])


def test_raw_results(raw_pair):
    name, jax_out, port_out, disp = raw_pair
    counts, iv = port_out[2], port_out[3]
    assert counts[tmk.C_PENDING] == 0 and counts[tmk.C_OVERFLOW] == 0
    if name == "fib11":
        assert iv[0] == 89 and counts[tmk.C_EXECUTED] == 430
        assert disp == {"fib": 287, "sum": 143}
        # The entry point reports what the raw state says.
        v, info = tw.device_fib(11, device="cpu")
        assert v == 89 and info["executed"] == 430
        assert info["allocated"] == jax_out[2][tmk.C_ALLOC]
        assert info["value_alloc"] == jax_out[2][tmk.C_VALLOC]
    elif name == "uts_default":
        assert iv[0] == 5332 and counts[tmk.C_EXECUTED] == 5332
    else:
        assert iv[2] == 3 and iv[3] == 8 and list(iv[4:9]) == [4] * 5
        assert counts[tmk.C_EXECUTED] == 7


@pytest.mark.parametrize("reps,stage_all", [(3, False), (2, True)])
def test_reps_and_staging_match_jax(reps, stage_all):
    """reps > 1 re-stages the input state and accumulates C_EXECUTED;
    stage_all_values stages every value slot (the _kernel reps loop)."""
    mj = jw.make_fib_megakernel(64, interpret=True)
    mt = tw.make_fib_megakernel(64, device="cpu")
    staged = _staged(mj, _fib_graph(JBuilder, 7)[0], None)
    staged[4][-1] = 5  # a slot above value_alloc: staged only with stage_all
    with jax.default_device(jax.devices("cpu")[0]):
        outs = jax.jit(mj._build_raw(FUEL, reps=reps,
                                     stage_all_values=stage_all))(*staged)
    st = state.from_numpy(*staged, device="cpu")
    mt.launch(st, FUEL, reps=reps, stage_all_values=stage_all)
    port = state.to_numpy(st)
    for got, want in zip((port[0], port[2], port[3], port[4]), outs[:4]):
        assert np.array_equal(got, np.asarray(want))
    assert port[3][tmk.C_EXECUTED] == reps * 61  # 41 fib + 20 sum tasks


def test_stall_raises_like_jax():
    errors = []
    for mk, B in ((jw.make_fib_megakernel(64, interpret=True), JBuilder),
                  (tw.make_fib_megakernel(64, device="cpu"), TBuilder)):
        b = B()
        t = b.add(jw.SUM, args=[0, 0], out=1)
        b._rows[t][1] = 1  # an unsatisfiable dependency
        with pytest.raises(RuntimeError, match="stalled") as e:
            mk.run(b)
        errors.append(e.value)
    assert type(errors[1]).__name__ == "StallError"
    assert str(errors[0]) == str(errors[1])
    assert errors[0].stats["pending"] == errors[1].stats["pending"] == 1


def test_overflow_raises_like_jax():
    msgs = []
    with pytest.raises(RuntimeError, match="overflow") as e:
        jw.device_fib(12, capacity=8, interpret=True)
    msgs.append(str(e.value))
    with pytest.raises(RuntimeError, match="overflow") as e:
        tw.device_fib(12, capacity=8, device="cpu")
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="row-owned"):
        tw.device_fib(14, capacity=64, num_values=16, device="cpu")


def test_fault_mix_matches_jax():
    rng = np.random.default_rng(7)
    r = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    g = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    r[:4] = [2**31 - 1, -2**31, 0, -1]
    g[:4] = [2**31 - 1, -2**31, -1, 0]
    for seed, site, k in ((19, 0, 0), (19, 3, 0), (-5, 7, 2), (2**40, 1, 9)):
        ref = np.asarray(jmk.fault_mix(seed, site, jax.numpy.asarray(r), k,
                                       jax.numpy.asarray(g)))
        got = tmk.fault_mix(seed, site, r, k, g)
        assert np.array_equal(ref, got)
        assert [tmk.fault_mix(seed, site, int(a), k, int(b))
                for a, b in zip(r[:64], g[:64])] == list(ref[:64])


def _uts_replay(max_depth, seed=19, q_millis=440, m_children=4):
    """Level-by-level numpy replay of the UTS tree, independent of any
    scheduler: child c of (node, depth) exists iff depth == 0 or
    fault_mix(seed, c, node, 0, depth) < q_millis; its id is
    node*31 + 7c+1 + depth in int32."""
    def i32(x):
        return ((x + 2**31) % 2**32) - 2**31

    nodes, total = np.array([1], np.int64), 0
    for depth in range(max_depth + 1):
        total += len(nodes)
        if depth == max_depth:
            break
        kids = []
        for c in range(m_children):
            const = (c * 2654435761 + seed * 2246822519) & 0x7FFFFFFF
            x = i32(i32(nodes * -1640531527) + i32(depth * 69069) + const)
            x = x ^ (x >> 13)
            x = i32(x * 1274126177)
            x = x ^ (x >> 16)
            keep = ((x & 0x7FFFFFFF) % 1000 < q_millis) | (depth == 0)
            kids.append(i32(nodes[keep] * 31 + 7 * c + 1 + depth))
        nodes = np.concatenate(kids)
    return total


def test_uts_tree_counts_pinned():
    """5,332 nodes at the default depth 12 and 498,965 at depth 20 (what
    chip_smoke pins on the card); the port's scheduler agrees at 14."""
    assert _uts_replay(12) == 5332
    assert _uts_replay(20) == 498965
    nodes, info = tw.device_uts_mk(device="cpu", max_depth=14, capacity=4096)
    assert nodes == info["executed"] == _uts_replay(14)


@pytest.mark.parametrize("kw", [
    {"lane_max_age": 4}, {"trace": 64}, {"checkpoint": True},
    {"priority_buckets": 2}, {"verify": True},
])
def test_left_out_options_raise(kw):
    """The options still left out (verify) raise naming their ROADMAP
    item; the lane-age and bucket knobs, the recorder and the quiesce
    poll are ported and taken as JAX takes them (their runs are held to
    JAX word for word in tests/test_torch_priority.py,
    test_torch_tracebuf.py and test_torch_checkpoint.py)."""
    (name, value), = kw.items()
    if name == "verify":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmk.Megakernel(["fib", "sum"], device="cpu", **kw)
        return
    mk = tmk.Megakernel(["fib", "sum"], device="cpu", **kw)
    mj = jmk.Megakernel(kernels=[("k", lambda ctx: None)], capacity=8,
                        num_values=8, succ_capacity=8, interpret=True, **kw)
    if name == "trace":
        assert mk.trace.capacity == mj.trace.capacity == value
        assert mk.trace.words == mj.trace.words
        assert mk.checkpoint is mj.checkpoint is False
    elif name == "checkpoint":
        assert mk.checkpoint is mj.checkpoint is True
        assert mk.trace is mj.trace is None
        assert mk.quiesce_stride == mj.quiesce_stride == 1
        for q in (None, False, True, 7):
            assert np.array_equal(tmk.Megakernel.quiesce_words(q),
                                  jmk.Megakernel.quiesce_words(q))
    else:
        assert getattr(mk, name) == getattr(mj, name) == value


def test_kernel_table_names():
    with pytest.raises(ValueError, match="unknown kernel"):
        tmk.Megakernel(["addtile"], device="cpu")
    mk = tmk.Megakernel(
        ["potrf", "trsm"],
        data_specs={"tiles": ((1, 1, 128, 128), torch.float32),
                    "linvsp": ((1, 2, 128, 128), torch.bfloat16),
                    "lsp": ((1, 1, 2, 128, 128), torch.bfloat16)},
        params={"tile": 128, "factor_base": 128, "nt": 1}, device="cpu")
    assert mk.fn_of == {"potrf": 0, "trsm": 1}
    # Bodies are appended, never renumbered.
    assert tmk.BODIES.index("trsm") == 6
    # batch_width routes FIB through the batch tier; SUM stays scalar.
    mk = tw.make_fib_megakernel(64, batch_width=8, device="cpu")
    assert mk.body_names == ["fib", "sum", "fib_batch"]
    v, info = tw.device_fib(9, capacity=64, batch_width=8, device="cpu")
    assert v == 34 and info["dispatch"]["fib"] == 0
    assert info["tiers"]["routed"] == info["tiers"]["batch_tasks"] == 109
