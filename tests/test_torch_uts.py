"""The port's UTS engine against the JAX package's, on the CPU.

Integers only, so every comparison is exact: SHA-1 against ``hashlib``
and the JAX ``sha1_child``; host seeding, threshold tables and the plain
lockstep engine's per-lane planes and step count against
``hclib_tpu.device.uts_vec`` word for word; ``uts_fused(device="cpu")``
against the sequential spec ``count_seq``.

The JAX engine runs one program that ``tests/test_uts_vec.py`` compiles
too (its table path at stack 10 with a 100-column table, 8 x 128 lanes),
for both T3 and LINEAR gen_mx=8, so these tests add no XLA compile shape
of their own and pay that compile once.
"""

import hashlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hclib_tpu.device import uts_vec as juv
from hclib_tpu.models import uts as jm
from hclib_tpu.ops import sha1 as js
from hclib_tpu_torch.device import uts_vec as tuv
from hclib_tpu_torch.device.uts_fused import uts_dfs, uts_fused
from hclib_tpu_torch.models import uts as tm
from hclib_tpu_torch.ops import sha1 as ts

# (shape, gen_mx, b0, seed): the small trees of tests/test_uts_vec.py.
TREES = {
    "fixed_t3": (tm.FIXED, 5, 4.0, 42),
    "linear": (tm.LINEAR, 8, 4.0, 34),
    "cyclic": (tm.CYCLIC, 1, 6.0, 502),
    "expdec": (tm.EXPDEC, 3, 3.0, 502),
}
TARGET = {"fixed_t3": 64, "linear": 128, "cyclic": 8, "expdec": 16}


def _params(name):
    shape, gen_mx, b0, seed = TREES[name]
    return (tm.UTSParams(shape=shape, gen_mx=gen_mx, b0=b0, root_seed=seed),
            jm.UTSParams(shape=shape, gen_mx=gen_mx, b0=b0, root_seed=seed))


def test_sha1_bit_exact():
    rng = np.random.default_rng(7)
    n = 256
    st = rng.integers(0, 2**32, (5, n), dtype=np.uint64).astype(np.uint32)
    st[:, 0] = 0
    st[:, 1] = 0xFFFFFFFF
    ch = rng.integers(0, 2**31, n).astype(np.uint32)
    ch[:2] = [0, 0x7FFFFFFF]
    want = np.array([
        struct.unpack(">5I", hashlib.sha1(
            b"".join(struct.pack(">I", int(x)) for x in st[:, j])
            + struct.pack(">I", int(ch[j]))).digest())
        for j in range(n)
    ], np.uint32).T
    got_t = ts.sha1_child([torch.from_numpy(s.astype(np.int64)) for s in st],
                          torch.from_numpy(ch.astype(np.int64)))
    got_np = ts.sha1_child_np(list(st), ch)
    got_j = js.sha1_child([jnp.asarray(s) for s in st], jnp.asarray(ch), jnp)
    for i in range(5):
        assert np.array_equal(got_t[i].numpy().astype(np.uint32), want[i])
        assert np.array_equal(got_np[i], want[i])
        assert np.array_equal(np.asarray(got_j[i]), want[i])
    # The root rule: one 20-byte message through sha1_block.
    words = ts.sha1_block_np(
        [np.zeros(1, np.uint32)] * 4 + [np.full(1, 29, np.uint32),
                                        np.full(1, 0x80000000, np.uint32)]
        + [np.zeros(1, np.uint32)] * 9 + [np.full(1, 160, np.uint32)])
    assert struct.pack(">5I", *(int(w[0]) for w in words)) == tm.root_state(29)


@pytest.mark.parametrize("name", sorted(TREES))
def test_host_seed_equals_jax(name):
    tp, jp = _params(name)
    got = tuv._host_seed(tp, TARGET[name])
    want = juv._host_seed(jp, TARGET[name])
    assert got[:4] == want[:4]
    assert got[4].dtype == want[4].dtype and np.array_equal(got[4], want[4])
    assert got[5].dtype == want[5].dtype and np.array_equal(got[5], want[5])


@pytest.mark.parametrize("name", sorted(TREES))
def test_threshold_tables_equal_jax(name):
    tp, jp = _params(name)
    assert tuv.depth_cap(tp) == juv.depth_cap(jp)
    assert np.array_equal(tuv.child_thresholds(tp.b0),
                          juv.child_thresholds(jp.b0))
    cap = tuv.depth_cap(tp) or 9
    t = tuv.padded_threshold_table(tp, cap, min_cols=100)
    assert np.array_equal(t, juv.padded_threshold_table(jp, cap, min_cols=100))
    assert np.array_equal(tuv.padded_threshold_table(tp, cap, max_rows=127),
                          juv.padded_threshold_table(jp, cap, max_rows=127))
    assert np.array_equal(tuv.inrow_threshold_table(t, 128),
                          juv.inrow_threshold_table(t, 128))


def test_count_children_forms_agree():
    """The per-depth table and the FIXED list count as the scalar spec
    does."""
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.integers(0, 2**31, (8, 128)).astype(np.int32))
    r[0, :3] = torch.tensor([0, 2**31 - 1, 1073741824], dtype=torch.int32)
    depth = torch.from_numpy(rng.integers(0, 20, (8, 128)).astype(np.int32))
    p = tm.UTSParams(shape=tm.LINEAR, gen_mx=8, b0=4.0, root_seed=1)
    tab = tuv.padded_threshold_table(p, 9)
    rows = tuv.make_count_children(None, 8,
                                   table=torch.from_numpy(tab))(r, depth)
    f = tm.UTSParams(shape=tm.FIXED, gen_mx=8, b0=4.0, root_seed=1)
    fixed = tuv.make_count_children(
        tuple(int(t) for t in tuv.child_thresholds(4.0)), 8)(r, depth)
    for j in range(0, 128, 7):
        state = b"\x00" * 16 + struct.pack(">I", int(r[0, j]))
        d = int(depth[0, j])
        assert int(rows[0, j]) == tm.num_children(p, state, d)
        assert int(fixed[0, j]) == tm.num_children(f, state, d)


# Both trees run the JAX engine's table path at stack 10 with a (16, 100)
# table and 4096 padded roots: the one program that tests/test_uts_vec.py
# compiles for its depth-varying matrix, so the two cases share a single
# compile (and that test's, where they meet in one process). T3 is also
# run through the port's FIXED fast path at the stack (8) of
# tests/test_uts_vec.py's T3 case; that run must equal its table run word
# for word, so the FIXED path is held to JAX's through it.
ENGINE_CASES = {
    "fixed_t3": dict(stack_pad=8),
    "linear": dict(stack_pad=10, table_cols=100),
}
MAX_STEPS = (1 << 31) - 1


@pytest.fixture(scope="module")
def jax_table_runs():
    """Per tree: the staged table-path inputs and the JAX engine's output
    on them (one compile for both trees)."""
    cpu = jax.devices("cpu")[0]
    runs = {}
    for name in sorted(ENGINE_CASES):
        tp, _ = _params(name)
        seed = tuv._host_seed(tp, TARGET[name])
        sg = tuv.stage_roots(tp, seed[3], seed[4], seed[5], stack_pad=10,
                             table_cols=100)
        tab = tuv.padded_threshold_table(tp, tuv.depth_cap(tp), min_cols=100)
        assert tab.shape == (16, 100) and sg.pstate.shape == (5, 4096)
        args = [jax.device_put(x, cpu) for x in (
            jnp.asarray(sg.pstate), jnp.asarray(sg.pcount), jnp.asarray(tab),
            jnp.int32(sg.gen_mx), jnp.int32(sg.d0), jnp.int32(sg.nroots))]
        want = juv._uts_dfs(*args, stack_size=10, thresholds=None,
                            max_steps=MAX_STEPS, lanes=(8, 128),
                            min_idle_div=8)
        runs[name] = (seed, sg, tab, [np.asarray(w) for w in want])
    return runs


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_plain_engine_equals_jax_word_for_word(name, jax_table_runs):
    tp, _ = _params(name)
    seed, sg, tab, want = jax_table_runs[name]
    args, kw = sg.engine_args("cpu", MAX_STEPS, (8, 128))
    got = tuv._uts_dfs(*args[:2], torch.from_numpy(tab), *args[3:],
                       **dict(kw, stack_size=10, thresholds=None))
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    assert got[3] == int(want[3]) > 0
    assert got[4] is bool(want[4]) is False
    # The engine's own staging (the FIXED fast path for T3, at stack 8)
    # and the kernel's wrapper, which takes the plain engine for CPU
    # tensors, give the same planes and steps.
    own = tuv.stage_roots(tp, seed[3], seed[4], seed[5], **ENGINE_CASES[name])
    args, kw = own.engine_args("cpu", MAX_STEPS, (8, 128))
    for run in (tuv._uts_dfs(*args, **kw), uts_dfs(*args, **kw)):
        assert all(torch.equal(a, b) for a, b in zip(run[:3], got[:3]))
        assert run[3:] == got[3:]


@pytest.mark.parametrize("name", sorted(TREES))
def test_uts_fused_cpu_exact(name):
    tp, _ = _params(name)
    kw = {"depth_bound": 9} if tp.shape == tm.EXPDEC else {}
    r = uts_fused(tp, target_roots=TARGET[name], device="cpu", **kw)
    assert r["roots"] > 0  # the engine, not the host BFS, did the work
    assert (r["nodes"], r["leaves"], r["max_depth"]) == tm.count_seq(tp)
    assert r["device_nodes"] == r["nodes"] - r["host_seed_nodes"]
    assert 0 < r["lane_efficiency"] <= 1


def test_uts_vec_entry_and_count_seq_match_jax():
    r = tuv.uts_vec(tm.T3, target_roots=64, device="cpu", stack_pad=8)
    assert (r["nodes"], r["leaves"], r["max_depth"]) == tm.count_seq(tm.T3)
    assert tm.count_seq(tm.T3) == jm.count_seq(jm.T3)
    tiny = tm.UTSParams(shape=tm.FIXED, gen_mx=2, b0=1.0, root_seed=3)
    r = uts_fused(tiny, target_roots=10_000, device="cpu")
    assert r["roots"] == 0 and r["steps"] == 0
    assert (r["nodes"], r["leaves"], r["max_depth"]) == tm.count_seq(tiny)


def test_expdec_depth_bound_raises():
    p = tm.UTSParams(shape=tm.EXPDEC, gen_mx=3, b0=3.0, root_seed=502)
    _, _, true_maxd = tm.count_seq(p)
    with pytest.raises(RuntimeError, match="depth bound"):
        uts_fused(p, target_roots=8, device="cpu",
                  depth_bound=max(2, true_maxd - 2))


def test_steps_and_lanes_limits_raise():
    with pytest.raises(RuntimeError, match="ran out of steps"):
        uts_fused(tm.T3, target_roots=64, max_steps=3, device="cpu")
    with pytest.raises(ValueError, match="128"):
        uts_fused(tm.T3, lanes=(8, 64), device="cpu")
