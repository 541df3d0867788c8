"""PGASMegakernel on a mesh whose size is not a power of two (the port's
ring kernel: hclib_tpu_torch/device/pgas_kernel.py ``_plain_pgas_ring``,
csrc/mesh.cuh ``pgas_ring_kernel``) held to the JAX package's
``PGASMegakernel._kernel``.

One run of JAX's Mosaic-interpreted ring kernel (a module fixture, ~35-60
s): 3 devices, each putting a heap row into its right neighbour and
sending it three BUMPs paced over rounds (am_window 2), the consumers of
devices 1 and 2 parked on host waits, device 0's spawned by a body and
parked by a device-side wait_until, every device traced (64 records).
It is compared word for word: every device's value slots and counts row,
the rounds, the heap and every device's decoded records. The rest runs on
the port's plain version at 3, 5 and 6 devices, held to the assertions
JAX makes: the multi-chip dry run's phase 4, the PGAS exchange with its
burst, an abort, a batch-routed table at width 8, the overflow and stall
errors, the waits= refusals, a checkpoint-built table, and row 6's
``ctx.pgas`` without the atomics.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.megakernel import Megakernel as JMegakernel
from hclib_tpu.device.pgas_kernel import PGASMegakernel as JPGAS
from hclib_tpu.parallel.mesh import cpu_mesh as jax_mesh
from hclib_tpu_torch.device import stress
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.device.megakernel import C_ROUNDS, Megakernel
from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel
from hclib_tpu_torch.device.resident import ring_stat_words
from hclib_tpu_torch.parallel.mesh import cpu_mesh
from hclib_tpu_torch.runtime.resilience import StallError

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import mesh_holds  # noqa: E402

FILL = np.iinfo(np.int32).max  # Mosaic interpret's unwritten words
ROWS, COLS = 8, 128
PUT, CONSUME, BUMP, SPAWN = range(4)


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


# One table for both packages. PUT: my heap row 0 into device arg0's row
# arg1 on channel 0, then three BUMPs of its slot 1 (1 + 10 me + i).
# CONSUME: slot arg0 = channel 0's count. BUMP: slot arg0 += arg1. SPAWN:
# a CONSUME into slot 2, parked by a device-side wait on (channel 0, 1).

def put3(ctx):
    p = ctx.pgas
    p.put(ctx.arg(0), 0, ctx.arg(1), 0)
    for i in range(3):
        p.am(ctx.arg(0), BUMP, args=[1, 1 + 10 * p.me + i])


def consume(ctx):
    ctx.set_value(ctx.arg(0), ctx.pgas.count(0))


def bump(ctx):
    ctx.set_value(ctx.arg(0), ctx.value(ctx.arg(0)) + ctx.arg(1))


def spawn(ctx):
    ctx.pgas.wait_until(0, 1, ctx.spawn(CONSUME, args=[2], dep_count=1))


TABLE = [("put", put3), ("consume", consume), ("bump", bump),
         ("spawn", spawn)]


def heap(ndev, rows=ROWS):
    """Device d's row r holds 1000 d + r."""
    return (1000 * np.arange(ndev, dtype=np.int32)[:, None, None]
            + np.arange(rows, dtype=np.int32)[None, :, None]
            + np.zeros((1, 1, COLS), np.int32))


def load(B, ndev=3):
    """Every device: PUT at its right neighbour's row 1 + d; device 0 a
    SPAWN, the others a CONSUME [0] parked on the host wait (c0, 1)."""
    bs = [B() for _ in range(ndev)]
    waits = [[] for _ in range(ndev)]
    for d, b in enumerate(bs):
        b.add(PUT, args=[(d + 1) % ndev, 1 + d])
        if d == 0:
            b.add(SPAWN)
        else:
            waits[d].append((0, 1, b.add(CONSUME, args=[0])))
    return bs, waits


def tmk(table=TABLE, **kw):
    return Megakernel(table, data_specs={"heap": ((ROWS, COLS),
                                                  torch.int32)},
                      capacity=32, num_values=8, succ_capacity=8,
                      device="cpu", **kw)


def port_run(ndev=3, table=TABLE, mk_kw=None, **kw):
    bs, waits = load(TBuilder, ndev)
    pg = PGASMegakernel(tmk(table, **(mk_kw or {})), cpu_mesh(ndev),
                        channels={"c0": ("heap", 1)}, am_window=2)
    return pg.run(bs, data={"heap": heap(ndev)}, waits=waits, **kw)


@pytest.fixture(scope="module")
def mosaic3():
    mk = JMegakernel(
        kernels=TABLE,
        data_specs={"heap": jax.ShapeDtypeStruct((ROWS, COLS), np.int32)},
        capacity=32, num_values=8, succ_capacity=8, interpret=True,
        trace=64)
    bs, waits = load(JBuilder)
    pg = JPGAS(mk, jax_mesh(3, axis_name="q"), channels={"c0": ("heap", 1)},
               am_window=2)
    assert pg._resident is None  # JAX's ring kernel, row 6
    return (pg.run(bs, data={"heap": heap(3)}, waits=waits),
            port_run(mk_kw=dict(trace=64)))


def _masked_equal(j, t, what):
    j, t = np.asarray(j), np.asarray(t)
    assert j.shape == t.shape, what
    m = j != FILL
    np.testing.assert_array_equal(j[m], t[m], err_msg=what)


def test_ring_kernel_equals_jax_word_for_word(mosaic3):
    (jiv, jdata, ji), (tiv, tdata, ti) = mosaic3
    _masked_equal(jiv, tiv, "ivalues")
    _masked_equal(ji["per_device_counts"], ti["per_device_counts"], "counts")
    assert ji["rounds"] == ti["rounds"]
    _masked_equal(jdata["heap"], tdata["heap"].numpy(), "heap")
    for k in ("executed", "pending", "aborted"):
        assert ji[k] == ti[k], k
    jr, tr = ji["trace"]["rings"], ti["trace"]["rings"]
    assert len(jr) == len(tr) == 3
    for d, (a, b) in enumerate(zip(jr, tr)):
        assert (a["written"], a["dropped"]) == (b["written"], b["dropped"])
        _masked_equal(a["records"], b["records"], f"device {d} records")


def test_ring_kernel_run_holds_its_assertions(mosaic3):
    """The fixture's outcome on the port: each CONSUME saw the one put,
    each device's slot 1 the three BUMPs of its left neighbour, each
    landed row its neighbour's row 0, the AMs paced one a round."""
    _, (iv, data, info) = mosaic3
    assert iv[1:, 0].tolist() == [1, 1] and iv[0, 2] == 1
    assert iv[:, 1].tolist() == [3 * (1 + 10 * ((d - 1) % 3)) + 3
                                 for d in range(3)]
    h = data["heap"].numpy()
    for d in range(3):
        assert (h[(d + 1) % 3, 1 + d] == 1000 * d).all()
    assert info["executed"] == 16 and info["pending"] == 0
    assert info["rounds"] >= 3  # three AMs a target, one a round
    ex = info["exchange"]
    assert ex["ams"] == [3] * 3 and ex["puts"] == [1] * 3
    assert ex["stat_words"] == [info["rounds"] * ring_stat_words(3, 1)] * 3


# --------------------------------------------- the port alone, 3, 5, 6


@pytest.mark.parametrize("ndev", [3, 5, 6])
def test_dryrun_phase4_at_any_size(ndev):
    """__graft_entry__.py:200-215's phase 4 literally: PUT at the right
    neighbour, CONSUME parked on (c0, 1), the AM'd CONSUME."""
    bs, waits, heap4 = stress.dryrun_builders(4, ndev)
    pg = PGASMegakernel(stress.put_consume_megakernel("cpu"),
                        cpu_mesh(ndev, axis_name="queues"),
                        channels={"c0": ("heap", 1)})
    assert pg._resident is None
    iv, _, info = pg.run(bs, data={"heap": heap4}, waits=waits)
    assert info["pending"] == 0
    assert all(int(iv[d, 0]) >= 1 for d in range(ndev))
    assert info["rounds"] == 2 and info["executed"] == 3 * ndev


@pytest.mark.parametrize("ndev", [3, 5, 6])
def test_pgas_exchange_with_burst(ndev):
    iv, data, info = mesh_holds.ring_run("pgas", ndev, "cpu")
    stress.check_pgas(iv, data["heap"].numpy(), info, ndev, True)


@pytest.mark.parametrize("ndev", [3, 5, 6])
def test_abort_exits_in_lockstep(ndev):
    """One device's abort word stops the whole mesh after the round that
    folds it: every device at the same round, pending left."""
    flags = [0] * ndev
    flags[ndev // 2] = 1
    iv, data, info = mesh_holds.ring_run("pgas", ndev, "cpu", abort=flags)
    assert info["aborted"] and info["pending"] > 0
    assert (info["per_device_counts"][:, C_ROUNDS] == info["rounds"]).all()
    assert info["rounds"] == 1


@pytest.mark.parametrize("ndev", [3, 5, 6])
def test_batch_routed_table_at_width_8(ndev):
    """FIB routed through the batch tier at width 8, its roots sent as
    active messages (mesh_holds' fan: exact inside); the tier counters
    reconcile with the executed count."""
    iv, _, info = mesh_holds.ring_run("fan", ndev, "cpu")
    tiers = info["tiers"]
    assert len(tiers) == ndev
    batched = sum(t["batch_tasks"] for t in tiers)
    scalar = sum(t["scalar_tasks"] for t in tiers)
    assert batched + scalar == info["executed"] and batched > 0


def test_overflow_and_stall_raise_with_jax_texts():
    def flood(ctx):
        for _ in range(5):
            ctx.pgas.am(0, BUMP, args=[4, 1])

    table = TABLE[:3] + [("spawn", flood)]
    with pytest.raises(RuntimeError, match="pgas kernel overflow: task "
                       "table, value slots, outbox, or wait table "
                       "exceeded"):
        PGASMegakernel(tmk(table), cpu_mesh(3), outbox=4).run(
            _spawns(3), data={"heap": heap(3)})
    bs = [TBuilder() for _ in range(3)]
    t = bs[1].add(CONSUME, args=[0])
    with pytest.raises(StallError, match=r"pgas kernel stalled: 1 pending "
                       r"after 0 executed \(8 rounds\) - a wait-until whose "
                       "messages never arrive"):
        PGASMegakernel(tmk(), cpu_mesh(3), channels={"c0": ("heap", 1)}).run(
            bs, data={"heap": heap(3)}, waits=[[], [(0, 1, t)], []],
            max_rounds=8)


def _spawns(ndev):
    bs = [TBuilder() for _ in range(ndev)]
    bs[0].add(SPAWN)
    return bs


def test_waits_refusals_with_jax_texts():
    pg = PGASMegakernel(tmk(), cpu_mesh(3), channels={"c0": ("heap", 1)},
                        max_waits=1)
    bs = _spawns(3)
    for waits, match in (([[(0, 1, 0), (0, 1, 0)]], r"device 0: too many "
                          r"waits \(2\)"),
                         ([[(1, 1, 0)]], "bad channel id 1"),
                         ([[], [(0, 1, 0)]], "device 1: wait names task 0, "
                          "but the partition has 0 tasks")):
        with pytest.raises(ValueError, match=match):
            pg.run(bs, data={"heap": heap(3)}, waits=waits)


def test_checkpoint_built_table_runs_as_an_unbuilt_one():
    """JAX's row 6 never reads mk.checkpoint: a checkpoint-built table
    runs word for word as the same table unbuilt."""
    a = port_run(mk_kw=dict(checkpoint=True))
    b = port_run()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2]["per_device_counts"],
                                  b[2]["per_device_counts"])
    assert torch.equal(a[1]["heap"], b[1]["heap"])
    assert a[2]["rounds"] == b[2]["rounds"] and "quiesced" not in a[2]


def test_ring_ctx_pgas_has_no_atomics():
    """Row 6's ctx.pgas is put, am, wait_until, count, me, ndev, nchan:
    a body that calls fadd gets the AttributeError JAX's namespace gives;
    a power-of-two mesh still runs the resident kernel, which has it."""
    def fadd(ctx):
        ctx.pgas.fadd(1, 0, 1)

    table = TABLE[:3] + [("spawn", fadd)]
    with pytest.raises(AttributeError, match="fadd"):
        PGASMegakernel(tmk(table), cpu_mesh(3)).run(
            _spawns(3), data={"heap": heap(3)})
    iv, _, info = PGASMegakernel(tmk(table), cpu_mesh(4)).run(
        _spawns(4), data={"heap": heap(4)})
    assert iv[1, 0] == 1 and info["builtin_ams"]["fadd"][1] == 1
