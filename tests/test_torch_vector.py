"""The port's vector (subtree) tier against the JAX package's, on the CPU.

The plain subtree runner must give JAX's ``make_subtree_runner`` result
``(nodes, accs, over)`` for every ``max_steps``, truncated runs included
(a cut run pins the exact order of the lock-step ``step`` and the steal
rotation of ``balance``); and a megakernel whose table runs a vector
family (``device_vfib``, ``device_nqueens``, a routed fib) must leave
JAX's whole output state (task table, ready ring, counts, value slots)
word for word. The JAX programs are jitted once each, with ``n`` and
``max_steps`` traced, and compiled on threads while the next one is
lowered.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hclib_tpu.device import megakernel as jmk
from hclib_tpu.device import vector_engine as jv
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import vector_engine as tv
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.models.nqueens import KNOWN_COUNTS, count_seq

NO_LIMIT = (1 << 31) - 1
FUEL = 1 << 22
PARTS = ["tasks", "ready", "counts", "ivalues"]
FIB_N = [0, 1, 2, 3, 5, 10, 14]
FIB_STEPS = [NO_LIMIT, 7, 40]
NQ_N = [1, 4, 5, 6]
NQ_STEPS = [NO_LIMIT, 25]


def fib(n):
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def tree_tasks(n):
    """Nodes of fib's naive recursion tree, 2*fib(n+1) - 1."""
    return 2 * fib(n + 1) - 1


@pytest.fixture(autouse=True)
def _reference_without_hclint(monkeypatch):
    """The JAX reference megakernels are built without their build-time
    verifier (hclint): a host analysis that cannot change the compiled
    program, and seconds of test time."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")


# --------------------------------------------------- the JAX programs

def _fib_runner(lanes, max_n):
    spec = jv.fib_spec(max_n=max_n, lanes=lanes)

    def run(n, max_steps):
        nodes, accs, over = jv.make_subtree_runner(spec, max_steps=max_steps)(
            (n,), jnp.where(n >= 2, 2, 0))
        return nodes, accs["value"], over

    return run, (jnp.int32(0), jnp.int32(0))


def _nq_runner(n):
    spec = jv.nqueens_spec(n, lanes=(2, 8))

    def run(max_steps):
        nodes, accs, over = jv.make_subtree_runner(spec, max_steps=max_steps)(
            spec.seed((jnp.int32(0),))[0], n)
        return nodes, accs["solutions"], over

    return run, (jnp.int32(0),)


def _staged(mk, b):
    tasks, succ, ring, counts = b.finalize(
        capacity=mk.capacity, succ_capacity=mk.succ_capacity)
    return tasks, succ, ring, counts, np.zeros(mk.num_values, np.int32)


def _routed_graph(B):
    """fib(9) and fib(10), each a routed subtree, feed a scalar SUM."""
    b = B()
    t0 = b.add(jw.FIB, args=[9], out=0)
    t1 = b.add(jw.FIB, args=[10], out=1)
    b.add(jw.SUM, args=[0, 1], deps=[t0, t1], out=2)
    b.reserve_values(3)
    return b


def _one_task(fn, args):
    def graph(B):
        b = B()
        b.add(fn, args=args, out=0)
        return b
    return graph


# name: (JAX megakernel, port megakernel, graph)
TABLES = {
    "device_vfib_10": (
        lambda: jw.make_vfib_megakernel(max_n=12, lanes=(1, 8),
                                        interpret=True),
        lambda: tw.make_vfib_megakernel(max_n=12, lanes=(1, 8),
                                        device="cpu"),
        _one_task(jw.VFIB, [10])),
    "device_nqueens_6": (
        lambda: jmk.Megakernel(
            kernels=[("vnqueens", jv.nqueens_spec(6, lanes=(1, 8)))],
            capacity=64, num_values=16, succ_capacity=8, interpret=True),
        lambda: tmk.Megakernel(
            [("vnqueens", tv.nqueens_spec(6, lanes=(1, 8)))],
            capacity=64, num_values=16, succ_capacity=8, device="cpu"),
        _one_task(jw.VNQUEENS, [0])),
    "routed_fib": (
        lambda: jmk.Megakernel(
            kernels=[("fib", jw._fib_kernel), ("sum", jw._sum_kernel)],
            auto_route={"fib": jv.fib_spec(max_n=14, lanes=(1, 8))},
            capacity=16, num_values=16, succ_capacity=8, interpret=True),
        lambda: tmk.Megakernel(
            ["fib", "sum"], route={"fib": tv.fib_spec(14, (1, 8))},
            capacity=16, num_values=16, succ_capacity=8, device="cpu"),
        _routed_graph),
}


def _runner_jobs():
    jobs = {f"fib{r}x{c}": _fib_runner((r, c), 14) for r, c in
            ((1, 8), (2, 8))}
    jobs["fib_overflow"] = _fib_runner((1, 8), 3)
    jobs.update({f"nq{n}": _nq_runner(n) for n in NQ_N})
    return {k: (None, lambda fn=fn, args=args: jax.jit(fn).lower(*args))
            for k, (fn, args) in jobs.items()}


def _table_jobs():
    jobs = {}
    for key, (mk_j, _, graph) in TABLES.items():
        mj = mk_j()
        jobs[key] = (mj, lambda mj=mj, graph=graph: jax.jit(
            mj._build_raw(FUEL)).lower(*_staged(mj, graph(JBuilder))))
    return jobs


_BUILT: dict = {}


def _program(name):
    """The compiled JAX program of ``name`` (a runner or a megakernel
    table). The first call lowers every program in turn, the tables
    first, and compiles each on a thread while the next one lowers (XLA's
    compile releases the GIL)."""
    if not _BUILT:
        group = {**_table_jobs(), **_runner_jobs()}
        pool = ThreadPoolExecutor(len(group))
        with jax.default_device(jax.devices("cpu")[0]):
            for key, (mj, lower) in group.items():
                _BUILT[key] = (mj, pool.submit(lower().compile))
        pool.shutdown(wait=False)
    mj, fut = _BUILT[name]
    return mj, fut.result()


def _jax_run(name, *args):
    _, prog = _program(name)
    nodes, acc, over = prog(*(jnp.int32(a) for a in args))
    return int(nodes), int(acc), bool(over)


# ------------------------------------------- the plain runner vs JAX's

@pytest.mark.parametrize("max_steps", FIB_STEPS)
@pytest.mark.parametrize("n", FIB_N)
@pytest.mark.parametrize("lanes", [(1, 8), (2, 8)])
def test_fib_runner_like_jax(lanes, n, max_steps):
    want = _jax_run(f"fib{lanes[0]}x{lanes[1]}", n, max_steps)
    spec = tv.fib_spec(max_n=14, lanes=lanes)
    got = tv.make_subtree_runner(spec, max_steps=max_steps)(
        (n,), 2 if n >= 2 else 0)
    assert (got[0], got[1]["value"], got[2]) == want
    if max_steps == NO_LIMIT:
        # Leaf seeds (n < 2) do no vector work; the bridge adds them.
        assert got[0] + 1 == (tree_tasks(n) if n >= 2 else 1)
        assert got[1]["value"] == (fib(n) if n >= 2 else 0)
        assert not got[2]
    # The standalone wrapper on a CPU tensor is the same plain run.
    nodes, accs, over, steps = tv.subtree_run(
        spec, (n,), 2 if n >= 2 else 0, max_steps, device="cpu")
    assert (nodes, accs, over) == got and steps <= max_steps


def test_runner_stack_overflow_like_jax():
    """max_n=3 gives a 5-level stack, too shallow for fib(12): the flag
    is raised and the clamped pushes leave JAX's (wrong) counts."""
    want = _jax_run("fib_overflow", 12, 100000)
    got = tv.make_subtree_runner(tv.fib_spec(max_n=3, lanes=(1, 8)),
                                 max_steps=100000)((12,), 2)
    assert (got[0], got[1]["value"], got[2]) == want
    assert got[2]


@pytest.mark.parametrize("max_steps", NQ_STEPS)
@pytest.mark.parametrize("n", NQ_N)
def test_nqueens_runner_like_jax(n, max_steps):
    want = _jax_run(f"nq{n}", max_steps)
    spec = tv.nqueens_spec(n, lanes=(2, 8))
    got = tv.make_subtree_runner(spec, max_steps=max_steps)(
        *spec.seed((0,) * 6))
    assert (got[0], got[1]["solutions"], got[2]) == want
    if max_steps == NO_LIMIT:
        assert (got[1]["solutions"], got[0]) == count_seq(n)


def test_nqueens_sequential_counts():
    for n in range(1, 9):
        assert count_seq(n)[0] == KNOWN_COUNTS[n]
    assert count_seq(4) == (2, 16)


# ---------------------------------- vector tables: the whole state


_PAIRS: dict = {}


def _pair(name):
    if name not in _PAIRS:
        mj, prog = _program(name)
        mt = TABLES[name][1]()
        graph = TABLES[name][2]
        sj, st = _staged(mj, graph(JBuilder)), _staged(mt, graph(TBuilder))
        for x, y in zip(sj, st):
            assert x.tobytes() == y.tobytes()
        jax_out = [np.asarray(o) for o in prog(*sj)[:4]]
        s = state.from_numpy(*st, device="cpu")
        disp = mt.fold_dispatches(mt.launch(s, FUEL))
        tasks, _, ready, counts, ivalues, _ = state.to_numpy(s)
        _PAIRS[name] = (jax_out, [tasks, ready, counts, ivalues], disp)
    return _PAIRS[name]


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", sorted(TABLES))
def test_vector_table_state_word_for_word(name, part):
    jax_out, port_out, _ = _pair(name)
    i = PARTS.index(part)
    assert jax_out[i].dtype == port_out[i].dtype == np.int32
    assert jax_out[i].shape == port_out[i].shape
    assert np.array_equal(jax_out[i], port_out[i])


def test_vector_table_results():
    """What the entry points report equals the raw states above."""
    _, port, disp = _pair("device_vfib_10")
    v, info = tw.device_vfib(10, lanes=(1, 8), device="cpu")
    assert v == port[3][0] == fib(10) == 55
    assert info["executed"] == port[2][tmk.C_EXECUTED] == tree_tasks(10)
    assert disp == info["dispatch"] == {"vfib": 1}
    _, port, _ = _pair("device_nqueens_6")
    v, info = tw.device_nqueens(6, lanes=(1, 8), device="cpu")
    sols, placements = count_seq(6)
    assert v == port[3][0] == sols == 4
    assert info["executed"] == port[2][tmk.C_EXECUTED] == placements + 1
    # The routed graph: SUM of two routed subtrees gives fib(11);
    # executed counts both trees and the SUM task, and no SUM
    # continuation was ever spawned (3 rows).
    _, port, disp = _pair("routed_fib")
    counts, iv = port[2], port[3]
    assert list(iv[:3]) == [fib(9), fib(10), fib(11)]
    assert counts[tmk.C_EXECUTED] == tree_tasks(9) + tree_tasks(10) + 1
    assert counts[tmk.C_ALLOC] == 3 and counts[tmk.C_PENDING] == 0
    assert disp == {"vfib": 2, "sum": 1}


def test_overflow_raises_and_names_the_engine():
    mk = tw.make_vfib_megakernel(max_n=3, lanes=(1, 8), device="cpu")
    b = TBuilder()
    b.add(tw.VFIB, args=[12], out=0)
    with pytest.raises(RuntimeError, match="vector-tier lane stacks"):
        mk.run(b)
    assert mk.stats_dict()["overflow"]


def test_route_validation():
    """JAX's ValueError for an unknown route name, on both packages; the
    port's card-only limits raise too."""
    with pytest.raises(ValueError, match="auto_route"):
        jmk.Megakernel(kernels=[("a", lambda ctx: None)],
                       auto_route={"b": jv.fib_spec(max_n=4, lanes=(1, 8))},
                       interpret=True)
    with pytest.raises(ValueError, match="auto_route"):
        tmk.Megakernel(["fib", "sum"],
                       auto_route={"b": tv.fib_spec(4, (1, 8))},
                       device="cpu")
    with pytest.raises(ValueError, match="VectorTaskSpecs or BatchSpecs"):
        tmk.Megakernel(["fib", "sum"], route={"fib": 3}, device="cpu")
    custom = tv.fib_spec(4, (1, 8))
    custom.name = "mine"
    with pytest.raises(ValueError, match="no CUDA body"):
        tmk.Megakernel([("mine", custom)], device="cpu")
    with pytest.raises(ValueError, match="at most 1024 lanes"):
        tmk.Megakernel([("vfib", tv.fib_spec(4, (16, 128)))], device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        tmk.Megakernel(["vfib"], device="cpu")
