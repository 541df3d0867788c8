"""User-defined task bodies in the port (hclib_tpu_torch/device/
megakernel.py ``Megakernel(kernels=[(name, fn[, cuda])])``, csrc/user.cuh):
the plain core runs the Python body, the card a library built from the
CUDA source given with it.

Held to the JAX package's interpret-mode megakernel on the same tables,
word for word: tests/test_device.py's alloc/free bodies (recycled blocks,
a leak that overflows, a double free) and a table that mixes the
built-in fib and sum bodies with a user body. Then the meta layout the
two sides share (csrc/layout.cuh against megakernel.py), the generated
library source, and the refusals.
"""

import os
import re

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.megakernel import Megakernel as JMegakernel
from hclib_tpu_torch import _build
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.device.megakernel import Megakernel

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hclib_tpu_torch", "csrc")


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


# tests/test_device.py's bodies, as JAX (pl.when) and plain bodies, and
# the CUDA statements a card-bound table gives with them.

def j_chain_free(ctx):
    base = ctx.alloc_values(2)
    ctx.set_value(base, ctx.arg(0))
    ctx.free_values(base)
    n = ctx.arg(0)

    @pl.when(n > 0)
    def _():
        ctx.spawn(0, [n - 1])


def j_chain_leak(ctx):
    base = ctx.alloc_values(2)
    ctx.set_value(base, ctx.arg(0))
    n = ctx.arg(0)

    @pl.when(n > 0)
    def _():
        ctx.spawn(0, [n - 1])


def j_double_free(ctx):
    base = ctx.alloc_values(2)
    ctx.free_values(base)
    ctx.free_values(base)


def chain_free(ctx):
    base = ctx.alloc_values(2)
    ctx.set_value(base, ctx.arg(0))
    ctx.free_values(base)
    if ctx.arg(0) > 0:
        ctx.spawn(0, [ctx.arg(0) - 1])


def chain_leak(ctx):
    base = ctx.alloc_values(2)
    ctx.set_value(base, ctx.arg(0))
    if ctx.arg(0) > 0:
        ctx.spawn(0, [ctx.arg(0) - 1])


def double_free(ctx):
    base = ctx.alloc_values(2)
    ctx.free_values(base)
    ctx.free_values(base)


CHAIN_FREE_CUDA = """
  const int base = ctx.alloc_values(2);
  ctx.set_value(base, ctx.arg(0));
  ctx.free_values(base);
  if (ctx.arg(0) > 0) {
    const int a = ctx.arg(0) - 1;
    ctx.spawn(0, &a, 1);
  }
"""

CHAIN_LEAK_CUDA = """
  const int base = ctx.alloc_values(2);
  ctx.set_value(base, ctx.arg(0));
  if (ctx.arg(0) > 0) {
    const int a = ctx.arg(0) - 1;
    ctx.spawn(0, &a, 1);
  }
"""

DOUBLE_FREE_CUDA = """
  const int base = ctx.alloc_values(2);
  ctx.free_values(base);
  ctx.free_values(base);
"""

BUMP_CUDA = "ctx.set_value(1, ctx.value(1) + ctx.arg(0));"


def bump1(ctx):
    ctx.set_value(1, ctx.value(1) + ctx.arg(0))


def _pair(jbody, tbody, cuda, capacity, num_values, tasks):
    """(JAX's, the port's) (ivalues, info) or the exception each raised,
    for one user-body table on the same tasks."""
    out = []
    for B, mk in (
        (JBuilder, lambda: JMegakernel(kernels=[("k", jbody)],
                                       capacity=capacity,
                                       num_values=num_values,
                                       succ_capacity=8, interpret=True)),
        (TBuilder, lambda: Megakernel([("k", tbody, cuda)],
                                      capacity=capacity,
                                      num_values=num_values,
                                      succ_capacity=8, device="cpu")),
    ):
        b = B()
        for args in tasks:
            b.add(0, args=args)
        try:
            iv, _, info = mk().run(b)
            out.append((np.asarray(iv), info))
        except RuntimeError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("name", ["free", "leak", "double_free"])
def test_alloc_free_values_equal_jax(name):
    """200 chained alloc(2)/free rounds through a 16-word value buffer
    recycle 3 blocks; without the free the 4th allocation overflows; a
    double free clamps the stack and overflows. Each as JAX."""
    jbody, tbody, cuda, nv, tasks = {
        "free": (j_chain_free, chain_free, CHAIN_FREE_CUDA, 16, [[200]]),
        "leak": (j_chain_leak, chain_leak, CHAIN_LEAK_CUDA, 16, [[200]]),
        "double_free": (j_double_free, double_free, DOUBLE_FREE_CUDA, 8,
                        [[], [], []]),
    }[name]
    jout, tout = _pair(jbody, tbody, cuda, 16, nv, tasks)
    if name == "free":
        (jiv, ji), (tiv, ti) = jout, tout
        np.testing.assert_array_equal(jiv, tiv)
        for k in ("executed", "pending", "allocated", "value_alloc",
                  "overflow"):
            assert ji[k] == ti[k], (k, ji[k], ti[k])
        assert ti["executed"] == 201 and not ti["overflow"]
    else:
        assert isinstance(jout, RuntimeError) and isinstance(tout,
                                                             RuntimeError)
        assert re.search("free_values|overflow", str(tout))
        assert "value slots" in str(tout)


def test_alloc_values_k_above_a_block_bumps_exactly():
    """k > VBLOCK bumps exactly k slots and never recycles; past the end
    it overflows with a clamped base."""
    got = []

    def body(ctx):
        got.append(ctx.alloc_values(6))
        got.append(ctx.alloc_values(6))

    mk = Megakernel([("k", body)], capacity=4, num_values=12,
                    succ_capacity=8, device="cpu")
    b = TBuilder()
    b.add(0)
    with pytest.raises(RuntimeError, match="value slots"):
        mk.run(b)
    # The first takes 6 slots at the bump cursor; the second does not fit
    # in 12 and returns the clamped base 12 - 6.
    assert got[0] + 12 > 12 and got[1] == 6, got


def test_alloc_values_refuses_row_owned_blocks():
    mk = Megakernel([("k", chain_free)], capacity=4, num_values=64,
                    succ_capacity=8, uses_row_values=True, device="cpu")
    b = TBuilder()
    b.add(0, args=[1])
    with pytest.raises(ValueError, match="row_values"):
        mk.run(b)


def test_mixed_builtin_and_user_table_equals_jax():
    """fib and sum (built-in names in the port, JAX's workload bodies in
    JAX) beside a user body in one table: fib(9) into slot 0 while five
    BUMPs add into slot 1; value slots, counts and the task table as
    JAX's."""
    cap = 128
    nv = tmk.VBLOCK * cap + 16

    def j_bump1(ctx):
        ctx.set_value(1, ctx.value(1) + ctx.arg(0))

    jm = JMegakernel(kernels=[("fib", jw._fib_kernel),
                              ("sum", jw._sum_kernel), ("bump", j_bump1)],
                     capacity=cap, num_values=nv, succ_capacity=8,
                     interpret=True, uses_row_values=True)
    tm = Megakernel(["fib", "sum", ("bump", bump1, BUMP_CUDA)],
                    capacity=cap, num_values=nv, succ_capacity=8,
                    uses_row_values=True, device="cpu")
    outs = []
    for B, mk in ((JBuilder, jm), (TBuilder, tm)):
        b = B()
        b.add(0, args=[9], out=0)
        for i in range(5):
            b.add(2, args=[i + 1])
        b.reserve_values(2)
        iv, _, info = mk.run(b)
        outs.append((np.asarray(iv), info))
    (jiv, ji), (tiv, ti) = outs
    np.testing.assert_array_equal(jiv, tiv)
    for k in ("executed", "pending", "allocated", "value_alloc"):
        assert ji[k] == ti[k], (k, ji[k], ti[k])
    assert tiv[0] == 34 and tiv[1] == 15
    assert ti["dispatch"] == {"fib": 109, "sum": 54, "bump": 5}
    assert tm.body_id("bump") == len(tmk.BODIES)
    assert tm.body_id("fib") == tmk.BODIES.index("fib")


# ------------------------------------------------- the shared meta layout


def _cuda_constants():
    """The constexpr ints of the headers csrc/megakernel.cu includes,
    evaluated in order."""
    seen, order = set(), []

    def walk(name):
        if name in seen or not os.path.exists(os.path.join(CSRC, name)):
            return
        seen.add(name)
        src = open(os.path.join(CSRC, name)).read()
        for inc in re.findall(r'#include "([^"]+)"', src):
            walk(inc)
        order.append(src)

    walk("megakernel.cu")
    env = {}
    for src in order:
        for decl in re.findall(r"constexpr int ([^;]+);", src):
            for part in re.split(r",\s*(?=[A-Z_]+\s*=)", decl):
                k, v = (x.strip() for x in part.split("=", 1))
                try:
                    env[k] = eval(v, {"__builtins__": {}}, dict(env))
                except (NameError, SyntaxError, TypeError):
                    pass
    return env, "\n".join(order)


def test_meta_layout_matches_the_cuda_side():
    """csrc/megakernel.cu (through csrc/layout.cuh) and megakernel.py
    derive every meta section from one body count, MAX_BODIES."""
    env, src = _cuda_constants()
    for name in ("MAX_PARAMS", "MAX_BODIES", "MAX_FNS", "META_FN_OF_BODY",
                 "META_BODY_OF_FN", "META_BATCH", "VEC_WORDS", "META_VEC",
                 "META_SLAB", "MAX_SLAB_WORDS", "META_PRIO", "NDISPATCH",
                 "SLAB_HDR", "SLAB_WORDS", "PRIO_WORDS"):
        assert env[name] == getattr(tmk, name), name
    assert tmk.META_BODY_OF_FN == tmk.META_FN_OF_BODY + tmk.MAX_BODIES
    assert tmk.NDISPATCH == tmk.MAX_BODIES
    # The built-in body ids: megakernel.py BODIES, in the enum's order.
    enum = re.search(r"enum \{\s*(B_FIB[^}]*)\}", src).group(1)
    ids = [x.strip() for x in enum.split(",") if x.strip()]
    assert ids[-1] == "NBODY" and len(ids) - 1 == len(tmk.BODIES)
    assert len(tmk.BODIES) < tmk.MAX_BODIES


def test_user_source_and_library_key():
    """The generated library source holds the variant's two macros, each
    user body's statements in its own function and the switch over them;
    the key follows the text, and each variant is a library of its own."""
    mk = Megakernel(["fib", ("a", bump1, BUMP_CUDA),
                     ("b", chain_free, CHAIN_FREE_CUDA)], device="cpu")
    src = mk.user_source()
    assert src.startswith("#define HCLIB_USER_LANES 0\n"
                          "#define HCLIB_USER_PGAS 0\n"
                          '#include "user.cuh"')
    assert "__device__ void user_body_0(Ctx& ctx) {\n" + BUMP_CUDA in src
    assert "user_body_1(ctx);" in src and "case 1:" in src
    other = Megakernel([("a", bump1, BUMP_CUDA + " ")], device="cpu")
    assert _build.user_key(src) != _build.user_key(other.user_source())
    assert _build.user_key(src) == _build.user_key(mk.user_source())
    assert "#define HCLIB_USER_PGAS 1\n" in mk.user_source(pgas=True)
    assert _build.user_key(src) != _build.user_key(mk.user_source(True))
    assert mk.uses_pgas_text() is False
    routed = Megakernel(["fib", "sum", ("a", bump1, BUMP_CUDA)],
                        route={"fib": tmk.BatchSpec(4)}, device="cpu")
    assert routed.user_source().startswith("#define HCLIB_USER_LANES 1\n")


@pytest.mark.parametrize("cuda, pgas", [
    ("ctx.pgas.put(1, 0, 0, 0);", True),
    ("ctx . pgas.am(0, 0);", True),
    ("// no pgas here\nctx.set_value(0, 1);", False),
    ("const int pgas_like = ctx.arg(0); ctx.set_value(0, pgas_like);",
     False),
])
def test_uses_pgas_text_matches_ctx_pgas(cuda, pgas):
    """A table is taken for a PGAS one (refused under other runners, built
    as the PGAS variant) when a body names ctx.pgas, not when "pgas"
    appears elsewhere in its text."""
    mk = Megakernel([("a", bump1, cuda)], device="cpu")
    assert mk.uses_pgas_text() is pgas
    assert ("#define HCLIB_USER_PGAS 1" in mk.user_source()) is pgas


def test_user_written_fib_equals_the_builtin_fib():
    """fib written as user bodies (scripts/mesh_holds.py UFIB / USUM: the
    built-in fib's spawn order through ctx) on the plain core: the value
    slots, counts and ready ring of the built-in fib's run on the same
    seed, and the sharded runner's user forest exact."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import mesh_holds as h

    mk = h.user_megakernel(256, "cpu")
    st = mk.state(h.user_builder("ufib", 14))
    mk.launch(st)
    ref = Megakernel(["fib", "sum"], capacity=256,
                     num_values=st["ivalues"].numel(), succ_capacity=8,
                     uses_row_values=True, device="cpu")
    b = TBuilder()
    b.add(0, args=[14], out=0)
    b.reserve_values(1)
    rst = ref.state(b)
    ref.launch(rst)
    assert int(st["ivalues"][0]) == 377
    for k in ("ivalues", "counts", "ready"):
        assert torch.equal(st[k], rst[k]), k
    iv, info = h.user_forest(8, 64, 9, "cpu")
    assert info["executed"] == 64 * (109 + 54)
    assert (iv[:, :64].sum(axis=0) == 34).all()


# ------------------------------------------------------------- refusals


def test_card_table_needs_cuda_source():
    """A card-bound table whose user body has no CUDA source raises at
    construction: no Python body runs on the host for the card."""
    with pytest.raises(ValueError, match="no CUDA source"):
        Megakernel(["fib", "sum", ("bump", bump1)])
    with pytest.raises(ValueError, match="no CUDA source"):
        Megakernel([("bump", bump1)], device="cuda")


def test_card_user_table_refuses_what_its_library_lacks():
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        Megakernel(["potrf", ("bump", bump1, BUMP_CUDA)], device="cuda")
    # A traced or checkpoint-built user table runs on the card under the
    # resident kernel and the ring (their observed instances): the card's
    # table check passes it; only its one-device launch refuses
    # (tests/test_torch_cuda.py).
    for kw in (dict(trace=64), dict(checkpoint=True)):
        mk = Megakernel(["fib", "sum", ("bump", bump1, BUMP_CUDA)],
                        device="cpu", **kw)
        mk._check_user_card(None)


def test_user_table_errors():
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        Megakernel([("bump", bump1)], route={"bump": tmk.BatchSpec(4)},
                   device="cpu")
    with pytest.raises(ValueError, match="repeat"):
        Megakernel(["fib", ("fib", bump1)], device="cpu")
    with pytest.raises(ValueError, match="at most 32"):
        Megakernel([(f"u{i}", bump1) for i in range(33)], device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        Megakernel(["addtile"], device="cpu")
    with pytest.raises(ValueError, match="table entry"):
        Megakernel([("bump", 3)], device="cpu")
