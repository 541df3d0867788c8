"""The port's batch tier against the JAX package's: the raw outputs of
``jax.jit(mk._build_raw(fuel))`` in interpret mode and the port's
``Megakernel.launch`` on the CPU (its plain core), fed identical state,
must agree word for word across the task table, ready ring, counts, value
slots and the tier counters (tstats); and the batched Cholesky factor is
bit-identical to the port's scalar-UPDROW factor and within the JAX tests'
tolerance of JAX's batched factor."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from hclib_tpu.device import cholesky as jc
from hclib_tpu.device import megakernel as jmk
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.models.cholesky import make_spd
from hclib_tpu_torch.device import cholesky as tc
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.runtime.resilience import StallError

FUEL = 1 << 22
# One JAX program serves both fib cases: fib(11) (430 tasks) completes
# within it, fib(13) (1,129 tasks) runs out of fuel and spills its lane.
FIB_FUEL = 500
PARTS = ["tasks", "ready", "counts", "ivalues", "tstats"]
TOL = 1e-5  # tests/test_device_workloads.py's bound on the factor


@pytest.fixture(autouse=True)
def _reference_without_hclint(monkeypatch):
    """The JAX reference megakernels are built without their build-time
    verifier (hclint, on by default under pytest): a host analysis that
    cannot change the compiled program, and seconds of test time."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")


def _graph(B, fn, args, out=None):
    b = B()
    b.add(fn, args=args, **({} if out is None else {"out": out}))
    return b


CASES = {
    "fib11_b8": ("fib", lambda B: _graph(B, jw.FIB, [11], 0)),
    "fib13_b8_out_of_fuel": ("fib", lambda B: _graph(B, jw.FIB, [13], 0)),
    "uts_default_b8": ("uts", lambda B: _graph(B, jw.UTS_NODE, [1, 0])),
}
CHOL_N, CHOL_TILE = 512, 128
CHOL_NT = CHOL_N // CHOL_TILE
# kind: (JAX megakernel, port megakernel, fuel), the longest JAX compile
# first (see _built).
MAKERS = {
    "cholesky": (lambda: jc.make_cholesky_megakernel(
                     CHOL_NT, interpret=True, tile=CHOL_TILE),
                 None, FUEL),
    "uts": (lambda: jw.make_uts_megakernel(interpret=True, batch_width=8),
            lambda: tw.make_uts_megakernel(batch_width=8, device="cpu"),
            FUEL),
    "fib": (lambda: jw.make_fib_megakernel(768, interpret=True,
                                           batch_width=8),
            lambda: tw.make_fib_megakernel(768, batch_width=8, device="cpu"),
            FIB_FUEL),
}
_BUILT: dict = {}


def _jax_args(kind, mj):
    """The JAX raw program's inputs: the fib and UTS cases' first graph,
    and the Cholesky graph with make_spd's tiles (as device_cholesky
    stages them)."""
    if kind == "cholesky":
        fin = jc.build_cholesky_graph(CHOL_NT).finalize(
            capacity=mj.capacity, succ_capacity=mj.succ_capacity)
        data = jc.cholesky_buffers(_chol_input(), CHOL_NT, CHOL_TILE)
        return (*fin, np.zeros(mj.num_values, np.int32), *data.values())
    graph = next(g for k, g in CASES.values() if k == kind)
    return _staged(mj, graph(JBuilder))


def _chol_input():
    return make_spd(CHOL_N).astype(np.float32)


def _built(kind):
    """(JAX megakernel, its compiled raw program, port megakernel) of
    ``kind``. The first call builds all three JAX programs: each is
    lowered in turn while the one before compiles on a thread (XLA's
    compile releases the GIL), which saves about ten seconds against
    building them one after another."""
    if not _BUILT:
        pool = ThreadPoolExecutor(len(MAKERS))
        with jax.default_device(jax.devices("cpu")[0]):
            for k, (make_j, make_t, fuel) in MAKERS.items():
                mj = make_j()
                lowered = jax.jit(mj._build_raw(fuel)).lower(
                    *_jax_args(k, mj))
                _BUILT[k] = (mj, pool.submit(lowered.compile),
                             make_t and make_t())
        pool.shutdown(wait=False)
    mj, compiled, mt = _BUILT[kind]
    return mj, compiled.result(), mt


def _staged(mk, b):
    tasks, succ, ring, counts = b.finalize(
        capacity=mk.capacity, succ_capacity=mk.succ_capacity
    )
    return tasks, succ, ring, counts, np.zeros(mk.num_values, np.int32)


_PAIRS: dict = {}


def _pair(name):
    """(name, JAX megakernel, port megakernel, JAX raw outputs, port raw
    outputs) of case ``name``, computed once."""
    if name not in _PAIRS:
        _PAIRS[name] = _run_pair(name)
    return _PAIRS[name]


@pytest.fixture(params=sorted(CASES))
def raw_pair(request):
    return _pair(request.param)


def _run_pair(name):
    kind, graph = CASES[name]
    mj, program, mt = _built(kind)
    sj, st = _staged(mj, graph(JBuilder)), _staged(mt, graph(TBuilder))
    for x, y in zip(sj, st):
        assert x.tobytes() == y.tobytes()
    jax_out = [np.asarray(o) for o in program(*sj)[:5]]
    s = state.from_numpy(*st, device="cpu")
    mt.launch(s, MAKERS[kind][2])
    tasks, _, ready, counts, ivalues, _ = state.to_numpy(s)
    port_out = [tasks, ready, counts, ivalues, s["tstats"].numpy()]
    return name, mj, mt, jax_out, port_out


@pytest.mark.parametrize("part", PARTS)
def test_raw_state_word_for_word(raw_pair, part):
    _, _, _, jax_out, port_out = raw_pair
    i = PARTS.index(part)
    assert jax_out[i].dtype == port_out[i].dtype == np.int32
    assert jax_out[i].shape == port_out[i].shape
    assert np.array_equal(jax_out[i], port_out[i])


def test_tier_stats_decode_like_jax(raw_pair):
    name, mj, mt, jax_out, port_out = raw_pair
    tiers = mt.decode_tier_stats(port_out[4])
    assert tiers == mj.decode_tier_stats(jax_out[4])
    counts = port_out[2]
    if name == "fib11_b8":
        assert port_out[3][0] == 89 and counts[tmk.C_EXECUTED] == 430
        # FIB batched (287 tasks), SUM scalar (143).
        assert tiers["batch_tasks"] == tiers["routed"] == 287
        assert tiers["scalar_tasks"] == 143 and tiers["spilled"] == 0
    elif name == "uts_default_b8":
        assert port_out[3][0] == 5332 and tiers["batch_tasks"] == 5332
    else:
        # Out of fuel with lane entries unrun: they spill to the ring
        # head, so C_HEAD went negative by the spilled count.
        assert tiers["spilled"] > 0
        assert counts[tmk.C_HEAD] == -tiers["spilled"]
        assert counts[tmk.C_PENDING] > 0


def test_fuel_exhaustion_raises_like_jax():
    """The entry point raises StallError with the pending and executed
    counts of JAX's raw run (fib(13) at the shared fuel)."""
    _, _, mt, jax_out, _ = _pair("fib13_b8_out_of_fuel")
    with pytest.raises(StallError, match="stalled") as e:
        mt.run(_graph(TBuilder, tw.FIB, [13], 0), fuel=FIB_FUEL)
    stats = e.value.stats
    assert stats["pending"] == jax_out[2][jmk.C_PENDING]
    assert stats["executed"] == jax_out[2][jmk.C_EXECUTED]
    assert stats["tiers"]["spilled"] > 0
    assert mt.stats_dict()["tiers"] == stats["tiers"]


def test_batchspec_validation():
    """JAX's checks and messages, on the port's spelling of a spec."""
    for spec in (lambda width: jmk.BatchSpec(lambda ctx: None, width=width),
                 tmk.BatchSpec):
        with pytest.raises(ValueError, match="width"):
            spec(width=0)
    with pytest.raises(ValueError, match="width"):
        tmk.BatchSpec(9)  # more than the slot rows a round publishes
    with pytest.raises(ValueError, match="drain"):
        jmk.BatchSpec(lambda ctx: None, width=2, prefetch=True)
    with pytest.raises(ValueError, match="drain"):
        tmk.Megakernel(["fib", "sum"], route={
            "fib": tmk.BatchSpec(2, prefetch=True)}, device="cpu")
    with pytest.raises(ValueError, match="route"):
        tmk.Megakernel(["fib"], route={"uts_node": tmk.BatchSpec()},
                       device="cpu")
    with pytest.raises(ValueError, match="fib"):  # names what batches
        tmk.Megakernel(["fib", "sum"], route={"sum": tmk.BatchSpec()},
                       device="cpu")
    with pytest.raises(ValueError, match="BatchSpec"):
        tmk.Megakernel(["fib", "sum"], route={"fib": 8}, device="cpu")
    with pytest.raises(ValueError, match="batch-routed"):
        tmk.Megakernel(["sw_wave"], device="cpu")
    mk = tmk.Megakernel(["fib", "sum", "uts_node"], route={
        "uts_node": tmk.BatchSpec(2), "fib": tmk.BatchSpec(4)}, device="cpu")
    # Lanes in F_FN order: the lowest F_FN fires first.
    assert [(f, s.width, b) for f, s, b in mk.batch_specs] == [
        (0, 4, "fib_batch"), (2, 2, "uts_node_batch")]
    assert mk.body_names == ["fib", "sum", "uts_node", "fib_batch",
                             "uts_node_batch"]


def test_cholesky_batched_updrow_like_jax():
    """n=512, tile 128 (tests/test_batch_tier.py's shape): the batched
    factor is bit-identical to the port's scalar-UPDROW factor, within TOL
    of JAX's batched factor (device_cholesky's program: the default,
    batched table at the default fuel), with JAX's tier counters."""
    mj, program, _ = _built("cholesky")
    outs = program(*_jax_args("cholesky", mj))
    lj = np.tril(jc._from_tiles(np.asarray(outs[4]), CHOL_NT, CHOL_TILE))
    a = _chol_input()
    lb, ib = tc.device_cholesky(a, device="cpu")
    ls, is_ = tc.device_cholesky(a, batch_updrow=False, device="cpu")
    assert torch.equal(lb, ls)
    assert "tiers" not in is_ and ib["executed"] == is_["executed"] == 13
    lb64 = lb.numpy().astype(np.float64)
    assert np.max(np.abs(lb64 - lj)) / np.max(np.abs(lj)) < TOL
    assert np.max(np.abs(lb64 @ lb64.T - a)) / np.max(np.abs(a)) < TOL
    assert ib["tiers"] == mj.decode_tier_stats(np.asarray(outs[-1]))
    assert ib["tiers"]["batch_tasks"] == 6 and ib["tiers"]["scalar_tasks"] == 7
    assert ib["dispatch"] == {"potrf": 4, "trsm": 0, "updrow": 0,
                              "trsmcol": 3, "updrow_batch": 3}
