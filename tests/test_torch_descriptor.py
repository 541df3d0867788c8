"""The port's descriptor ABI against the JAX package's: every constant
equal, and ``TaskGraphBuilder.finalize()`` byte-identical."""

import numpy as np
import pytest

import hclib_tpu.device.descriptor as jd
import hclib_tpu.device.megakernel as jmk
import hclib_tpu_torch.device.descriptor as td
import hclib_tpu_torch.device.megakernel as tmk
from hclib_tpu.device.cholesky import build_cholesky_graph as j_chol_graph
from hclib_tpu_torch.device.cholesky import build_cholesky_graph as t_chol_graph

DESC_NAMES = [
    "DESC_WORDS", "NO_TASK", "F_FN", "F_DEP", "F_SUCC0", "F_SUCC1",
    "F_CSR_OFF", "F_CSR_N", "F_A0", "F_OUT", "F_HOME", "F_HROW", "F_VMASK",
    "NUM_ARGS", "RING_ROW", "TEN_ID", "TEN_EXPIRED", "TEN_DEADLINE_MS",
    "TEN_TOKEN", "TEN_ADMIT_ROUND",
]
MK_NAMES = [
    "VBLOCK", "OVF_ROWS", "OVF_VALUES", "OVF_ENGINE", "OVF_OUTBOX",
    "OVF_WAITS", "OVF_LOCKQ", "OVF_PROMISE", "C_HEAD", "C_TAIL", "C_ALLOC",
    "C_PENDING", "C_VALLOC", "C_EXECUTED", "C_OVERFLOW", "C_ROUNDS",
    "C_VBASE",
]


@pytest.mark.parametrize("name", DESC_NAMES)
def test_descriptor_constant_equal(name):
    assert getattr(td, name) == getattr(jd, name)


@pytest.mark.parametrize("name", MK_NAMES)
def test_megakernel_constant_equal(name):
    assert getattr(tmk, name) == getattr(jmk, name)


def test_decode_overflow_equal():
    for mask in range(0, 129):
        assert tmk.decode_overflow(mask) == jmk.decode_overflow(mask)


def _csr(mod):
    b = mod.TaskGraphBuilder()
    a = b.add(0, args=[1])
    deps = [b.add(0, args=[2], deps=[a]) for _ in range(5)]
    b.add(0, args=[3], deps=deps)
    return b, dict(capacity=16, succ_capacity=16)


def _reserved(mod):
    b = mod.TaskGraphBuilder()
    b.add(1, args=[0, 1], out=2)
    b.add(1, args=[2, 0], out=5, deps=[0])
    b.reserve_values(9)
    return b, {}


def _chol(fused):
    def make(mod):
        build = t_chol_graph if mod is td else j_chol_graph
        return build(4, fused_trsm=fused), dict(capacity=32,
                                                 succ_capacity=128)
    return make


@pytest.mark.parametrize(
    "case", [_csr, _reserved, _chol(True), _chol(False)],
    ids=["csr_fanout", "reserve_values", "cholesky4_fused",
         "cholesky4_unfused"],
)
def test_finalize_byte_identical(case):
    bj, kw = case(jd)
    bt, _ = case(td)
    for x, y in zip(bj.finalize(**kw), bt.finalize(**kw)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert bj.num_tasks == bt.num_tasks


def test_finalize_errors_match():
    for mod in (jd, td):
        b = mod.TaskGraphBuilder()
        with pytest.raises(ValueError, match="at most 6 args"):
            b.add(0, args=list(range(7)))
        for _ in range(3):
            b.add(0)
        with pytest.raises(ValueError, match="exceed capacity"):
            b.finalize(capacity=2)
    assert np.array_equal(
        jd.TaskGraphBuilder().finalize()[3], td.TaskGraphBuilder().finalize()[3]
    )
