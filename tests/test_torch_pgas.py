"""The port's PGAS configuration of the resident kernel
(hclib_tpu_torch/device/resident.py, pgas_kernel.py: one-sided puts,
active messages and wait-untils between mesh devices) held to the JAX
package's on the same inputs.

Two runs of JAX's Mosaic-interpreted resident kernel (module fixtures; the
interpreter costs seconds a task, so they stay at a few tasks): two
devices with a put, an active message and a device-side wait_until; four
devices with host-declared waits= and am_window=2, the outbox paced over
rounds. Each is compared word for word: every device's value slots and
counts row, the rounds, the data buffers. The rest of JAX's functional
PGAS tests (tests/test_pgas_kernel.py, tests/test_resident.py) run on the
port's plain version and are held to the assertions JAX makes, as are
the multi-chip dry run's phases 2-4 (__graft_entry__.py) and the
refusals of what is not ported yet.
"""


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
from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
from hclib_tpu_torch.device.megakernel import Megakernel
from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel
from hclib_tpu_torch.device.resident import ResidentKernel, stat_words
from hclib_tpu_torch.device.sharded import ShardedMegakernel
from hclib_tpu_torch.parallel.mesh import CtaMesh, cpu_mesh

ROWS, COLS = 16, 128
PUT, CONSUME, BUMP, SERVE, NOP, EXTRA = range(6)


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


# The kernel table of tests/test_pgas_kernel.py, as plain bodies (the
# port's) and as JAX bodies. PUT: put my heap row arg2 to device arg0's
# row arg1 on channel arg3. CONSUME: record channel 0's count into slot
# arg0. BUMP: ivalues[arg0] += arg1. SERVE: put my row arg1 back to
# requester arg0's row arg2 on the reply channel.

def put(ctx):
    for c in range(ctx.pgas.nchan):
        if ctx.arg(3) == c:
            ctx.pgas.put(ctx.arg(0), c, ctx.arg(1), ctx.arg(2))


def jput(ctx):
    from jax.experimental import pallas as pl

    for c in range(ctx.pgas.nchan):
        @pl.when(ctx.arg(3) == c)
        def _(c=c):
            ctx.pgas.put(ctx.arg(0), c, ctx.arg(1), ctx.arg(2))


def consume(ctx):
    ctx.set_value(ctx.arg(0), ctx.pgas.count(0))


def bump(ctx):
    ctx.set_value(ctx.arg(0), ctx.value(ctx.arg(0)) + ctx.arg(1))


def serve(ctx):
    ctx.pgas.put(ctx.arg(0), 1, ctx.arg(2), ctx.arg(1))


def nop(ctx):
    pass


def spawner(ctx):
    """A device-side wait: spawn a parked CONSUME, register its wait on
    channel 0, and AM a BUMP of 7 into device 0's slot 3."""
    row = ctx.spawn(CONSUME, args=[2], dep_count=1)
    ctx.pgas.wait_until(0, 1, row)
    ctx.pgas.am(0, BUMP, args=[3, 7])


def send_all_of(ndev):
    def send_all(ctx):
        for d in range(ndev):
            ctx.pgas.am(d, BUMP, args=[0, 1 + ctx.pgas.me])
    return send_all


def table(extra=None, jax_bodies=False):
    k = [("put", jput if jax_bodies else put), ("consume", consume),
         ("bump", bump), ("serve", serve), ("nop", nop)]
    return k + ([("extra", extra)] if extra else [])


def jmk(extra=None, capacity=128):
    return JMegakernel(
        kernels=table(extra, True),
        data_specs={"heap": jax.ShapeDtypeStruct((ROWS, COLS), np.int32)},
        capacity=capacity, num_values=64, succ_capacity=64, interpret=True)


def tmk(extra=None, capacity=128):
    return Megakernel(table(extra),
                      data_specs={"heap": ((ROWS, COLS), torch.int32)},
                      capacity=capacity, num_values=64, succ_capacity=64,
                      device="cpu")


def heap(ndev):
    """Device d's row r prefilled with 1000*d + r."""
    h = np.zeros((ndev, ROWS, COLS), np.int32)
    for d in range(ndev):
        for r in range(ROWS):
            h[d, r, :] = 1000 * d + r
    return h


CHANNELS = {"c0": ("heap", 1), "reply": ("heap", 1)}


def assert_same(jout, tout):
    jiv, jdata, ji = jout
    tiv, tdata, ti = tout
    np.testing.assert_array_equal(np.asarray(jiv), tiv)
    np.testing.assert_array_equal(np.asarray(ji["per_device_counts"]),
                                  ti["per_device_counts"])
    assert ji["rounds"] == ti["rounds"]
    np.testing.assert_array_equal(np.asarray(jdata["heap"]),
                                  tdata["heap"].numpy())


def _two_devices(B, make, runner, mesh):
    bs = [B() for _ in range(2)]
    bs[0].add(PUT, args=[1, 0, 5, 0])  # my row 5 -> device 1's row 0
    bs[1].add(EXTRA)
    return runner(make(spawner), mesh(2), channels=CHANNELS).run(
        bs, data={"heap": heap(2)})


def _four_devices(B, make, runner, mesh):
    """Device 0 puts two rows into every other device, whose consumer is
    parked on a host wait (channel 0, need 2); every device AMs a BUMP at
    every device with am_window 2."""
    bs = [B() for _ in range(4)]
    waits = [[] for _ in range(4)]
    for d in range(1, 4):
        bs[0].add(PUT, args=[d, d, 1, 0])
        bs[0].add(PUT, args=[d, d + 8, 2, 0])
        waits[d].append((0, 2, bs[d].add(CONSUME, args=[1])))
    for b in bs:
        b.add(EXTRA)
    return runner(make(send_all_of(4)), mesh(4), channels=CHANNELS,
                  am_window=2).run(bs, data={"heap": heap(4)}, waits=waits)


@pytest.fixture(scope="module")
def mosaic2():
    return (_two_devices(JBuilder, jmk, JPGAS,
                         lambda n: jax_mesh(n, axis_name="q")),
            _two_devices(TBuilder, tmk, PGASMegakernel, cpu_mesh))


@pytest.fixture(scope="module")
def mosaic4():
    return (_four_devices(JBuilder, jmk, JPGAS,
                          lambda n: jax_mesh(n, axis_name="q")),
            _four_devices(TBuilder, tmk, PGASMegakernel, cpu_mesh))


def test_put_am_and_device_wait_equal_jax_at_2_devices(mosaic2):
    jout, tout = mosaic2
    assert_same(jout, tout)
    iv, data, info = tout
    assert iv[1, 2] == 1 and iv[0, 3] == 7
    assert (data["heap"].numpy()[1, 0] == 5).all()
    assert info["pending"] == 0
    assert info["exchange"]["stat_words"] == [
        info["rounds"] * stat_words(2, 2)] * 2


def test_waits_and_paced_ams_equal_jax_at_4_devices(mosaic4):
    jout, tout = mosaic4
    assert_same(jout, tout)
    iv, data, info = tout
    h = data["heap"].numpy()
    for d in range(1, 4):
        assert (h[d, d] == 1).all() and (h[d, d + 8] == 2).all()
        assert iv[d, 1] == 2  # the consumer saw both puts
    assert (iv[:, 0] == 1 + 2 + 3 + 4).all()
    assert info["exchange"]["ams"] == [4] * 4
    assert info["exchange"]["puts"] == [6, 0, 0, 0]


# ------------------------- JAX's functional PGAS tests, on the port alone


def _run(extra, ndev, builders, waits=None, capacity=128, **kw):
    pg = PGASMegakernel(tmk(extra, capacity), cpu_mesh(ndev),
                        channels=CHANNELS, **kw)
    return pg.run(builders, data={"heap": heap(ndev)}, waits=waits)


def test_put_wakes_parked_consumer_across_devices():
    ndev = 4
    bs = [TBuilder() for _ in range(ndev)]
    waits = [[] for _ in range(ndev)]
    for d in range(1, ndev):
        bs[0].add(PUT, args=[d, d % ROWS, 1, 0])
        bs[0].add(PUT, args=[d, (d + 8) % ROWS, 2, 0])
        t = bs[d].add(CONSUME, args=[0], out=0)
        waits[d].append((0, 2, t))
    iv, data, info = _run(None, ndev, bs, waits)
    h = data["heap"].numpy()
    for d in range(1, ndev):
        assert (h[d, d % ROWS] == 1).all()
        assert (h[d, (d + 8) % ROWS] == 2).all()
        assert iv[d, 0] == 2
    assert info["pending"] == 0 and not info["overflow"]


def test_am_targets_specific_device_mid_run():
    ndev = 4
    bs = [TBuilder() for _ in range(ndev)]
    for b in bs:
        b.add(EXTRA)
    iv, _, info = _run(send_all_of(ndev), ndev, bs, am_window=2)
    for d in range(ndev):
        assert iv[d, 0] == sum(1 + s for s in range(ndev))
    assert info["executed"] == ndev + ndev * ndev
    assert info["pending"] == 0


def test_outbox_carries_a_capped_head_over_rounds():
    """Eight AMs at one target with am_window 2: one leaves a round, the
    rest wait in the outbox, FIFO, and every one lands."""
    def burst(ctx):
        for i in range(8):
            ctx.pgas.am(1, BUMP, args=[0, 1 + i])

    bs = [TBuilder() for _ in range(2)]
    bs[0].add(EXTRA)
    iv, _, info = _run(burst, 2, bs, am_window=2)
    assert iv[1, 0] == 36 and info["rounds"] >= 8
    assert info["exchange"]["ams"] == [8, 0]


def test_get_composes_am_and_reply_put():
    ndev, get_row = 4, 3

    def request(ctx):
        d = ctx.arg(0)
        ctx.pgas.am(d, SERVE, args=[0, get_row, d, 0])

    bs = [TBuilder() for _ in range(ndev)]
    waits = [[] for _ in range(ndev)]
    for d in range(1, ndev):
        bs[0].add(EXTRA, args=[d])
    t = bs[0].add(CONSUME, args=[1])
    waits[0].append((1, ndev - 1, t))
    _, data, info = _run(request, ndev, bs, waits, capacity=256)
    h = data["heap"].numpy()
    for d in range(1, ndev):
        assert (h[0, d] == 1000 * d + get_row).all()
    assert info["pending"] == 0


def test_wait_until_device_side_spawn():
    bs = [TBuilder() for _ in range(2)]
    bs[0].add(PUT, args=[1, 0, 5, 0])
    bs[1].add(EXTRA)
    iv, data, info = _run(spawner, 2, bs, capacity=256)
    assert iv[1, 2] == 1
    assert (data["heap"].numpy()[1, 0] == 5).all()
    assert info["pending"] == 0


def test_one_device_self_loop():
    """test_pgas_compiles_and_runs_on_tpu's protocol: a self-put, a
    device-side wait and a self-AM on one device."""
    bs = [TBuilder()]
    bs[0].add(PUT, args=[0, 0, 5, 0])
    bs[0].add(EXTRA)
    iv, data, info = _run(spawner, 1, bs, capacity=256)
    assert iv[0, 2] == 1 and iv[0, 3] == 7
    assert (data["heap"].numpy()[0, 0] == 5).all()
    assert info["pending"] == 0


def _compose_mk(capacity=256):
    def cput(ctx):
        ctx.pgas.put(ctx.arg(0), 0, ctx.arg(1), ctx.arg(2))

    def bump0(ctx):
        ctx.set_value(0, ctx.value(0) + ctx.arg(0))

    return Megakernel([("bump", bump0), ("put", cput),
                       ("consume", consume)],
                      data_specs={"heap": ((8, COLS), torch.int32)},
                      capacity=capacity, num_values=512, succ_capacity=8,
                      device="cpu")


def _compose_heap(ndev):
    h = np.zeros((ndev, 8, COLS), np.int32)
    for d in range(ndev):
        for r in range(8):
            h[d, r, :] = 1000 * d + r
    return h


def test_pgas_on_2d_mesh():
    """tests/test_resident.py::test_pgas_on_2d_mesh: puts cross both axes
    of a 2x2 mesh; consumers wake on arrival."""
    rk = ResidentKernel(_compose_mk(), CtaMesh((2, 2), ("r", "c"),
                                               device="cpu"),
                        channels={"c0": ("heap", 1)}, steal=False)
    bs = [TBuilder() for _ in range(4)]
    waits = [[] for _ in range(4)]
    for d in (1, 2, 3):
        bs[0].add(1, args=[d, d, d])
        waits[d].append((0, 1, bs[d].add(2, args=[1])))
    iv, data, info = rk.run(bs, data={"heap": _compose_heap(4)},
                            waits=waits, quantum=8)
    h = data["heap"].numpy()
    for d in (1, 2, 3):
        assert (h[d, d] == d).all() and iv[d, 1] == 1
    assert info["pending"] == 0


def test_steal_and_pgas_on_3d_mesh():
    """tests/test_resident.py::test_steal_and_pgas_on_3d_mesh with
    homed=False (homed migration is ROADMAP A11b): a skewed bump load
    spreads by stealing while puts cross each axis of a 2x2x2 mesh and
    wake parked consumers, in one kernel."""
    rk = ResidentKernel(_compose_mk(128), CtaMesh((2, 2, 2), ("x", "y", "z"),
                                                  device="cpu"),
                        migratable_fns=[0], homed=False,
                        channels={"c0": ("heap", 1)}, window=4)
    ntasks = 12
    bs = [TBuilder() for _ in range(8)]
    for i in range(ntasks):
        bs[0].add(0, args=[i + 1])
    waits = [[] for _ in range(8)]
    for d in (1, 2, 4, 7):
        bs[0].add(1, args=[d, d % 8, d % 8])
        waits[d].append((0, 1, bs[d].add(2, args=[1])))
    iv, data, info = rk.run(bs, data={"heap": _compose_heap(8)},
                            waits=waits, quantum=4)
    assert info["pending"] == 0
    h = data["heap"].numpy()
    for d in (1, 2, 4, 7):
        assert (h[d, d % 8] == d % 8).all() and iv[d, 1] == 1
    assert int(iv[:, 0].sum()) == ntasks * (ntasks + 1) // 2
    assert int((info["per_device_counts"][:, 5] > 0).sum()) >= 3
    assert sum(info["exchange"]["rows"]) > 0


def test_overflows_raise_after_the_run():
    """A full outbox and a full wait table set their overflow bits; the
    host raises naming them."""
    def flood(ctx):
        for _ in range(5):
            ctx.pgas.am(0, NOP)

    bs = [TBuilder()]
    bs[0].add(EXTRA)
    with pytest.raises(RuntimeError, match="AM outbox"):
        _run(flood, 1, bs, outbox=4)

    def parks(ctx):
        for _ in range(3):
            ctx.pgas.wait_until(0, 1, ctx.spawn(NOP, dep_count=1))

    bs = [TBuilder()]
    bs[0].add(EXTRA)
    with pytest.raises(RuntimeError, match="wait table"):
        _run(parks, 1, bs, max_waits=2)


# --------------------------------- the multi-chip dry run's phases 2-4
# (__graft_entry__.py :149-203, its assertions; the tables and builders
# chip_smoke.py runs on the card)


def test_dryrun_phase2_bulk_synchronous_steal():
    ndev = 8
    ntasks = 8 * ndev
    iv, _, info = ShardedMegakernel(stress.bump_megakernel("cpu"),
                                    cpu_mesh(ndev, axis_name="queues"),
                                    migratable_fns=[0]).run(
        stress.dryrun_builders(2, ndev), steal=True, quantum=4, window=8)
    assert info["pending"] == 0
    assert int(iv[:, 0].sum()) == ntasks * (ntasks + 1) // 2
    assert int((info["per_device_counts"][:, 5] > 0).sum()) > 1


def test_dryrun_phase3_in_kernel_steal():
    ndev = 8
    ntasks = 8 * ndev
    iv, _, info = ICIStealMegakernel(stress.bump_megakernel("cpu"),
                                     cpu_mesh(ndev, axis_name="queues"),
                                     migratable_fns=[0], window=32).run(
        stress.dryrun_builders(3, ndev), quantum=16)
    assert int(iv[:, 0].sum()) == ntasks * (ntasks + 1) // 2
    assert int((info["per_device_counts"][:, 5] > 0).sum()) > 1


def test_dryrun_phase4_one_sided_pgas():
    ndev = 8
    bs, waits, heap4 = stress.dryrun_builders(4, ndev)
    iv, _, info = PGASMegakernel(stress.put_consume_megakernel("cpu"),
                                 cpu_mesh(ndev, axis_name="queues"),
                                 channels={"c0": ("heap", 1)}).run(
        bs, data={"heap": heap4}, waits=waits)
    assert info["pending"] == 0
    assert all(int(iv[d, 0]) >= 1 for d in range(ndev))
    assert (iv[:, 1] == 1).all()  # each AM'd consumer saw the put


def test_pgas_exchange_exact_at_8_devices():
    """stress.pgas_builders' exchange (chip_smoke.py's PGAS arm, cut to 8
    devices), PGAS-only with a burst and with steal beside it."""
    for steal in (False, True):
        bs, waits, h = stress.pgas_builders(8, True, 32 if steal else 0)
        kw = dict(migratable_fns=[stress.PBUMP], homed=False, window=4) \
            if steal else dict(steal=False)
        iv, data, info = ResidentKernel(
            stress.pgas_megakernel(device="cpu"), cpu_mesh(8),
            channels={"c0": ("heap", 1)}, **kw).run(
                bs, data={"heap": h}, waits=waits, quantum=4)
        stress.check_pgas(iv, data["heap"].numpy(), info, 8, True,
                          32 if steal else 0)
        assert (sum(info["exchange"]["rows"]) > 0) == steal


# ----------------------------------------------------------- refusals


ATOMIC_OPS = {
    # op: (ctx.pgas call from device 0 at device 1, device 1's slots 0..3
    # after the run: slot 0 preset 5, slot 2 the reply slot).
    "fadd": (lambda p, row: p.fadd(1, 0, 7), [12, 0, 0, 0]),
    "fadd_get": (lambda p, row: p.fadd_get(1, 0, 7, row, 2), [12, 0, 0, 0]),
    "cswap": (lambda p, row: p.cswap(1, 0, 5, 9, row, 2), [9, 0, 0, 0]),
    "lock": (lambda p, row: p.lock(1, 1, row, 1), [5, 1, 0, 0]),
    "unlock": (lambda p, row: p.unlock(1, 1, 1), [5, 0, 0, 0]),
}


@pytest.mark.parametrize("op", sorted(ATOMIC_OPS))
def test_remote_atomics_and_locks_run(op):
    """Each of ctx.pgas's atomics and lock ops from device 0 at device 1
    (its owner applies it in the receive drain): the owner's slots, the
    reply deposited in device 0's slot 2 and its parked CONSUME (one
    extra dependency) released, where the op replies."""
    call, want = ATOMIC_OPS[op]
    replies = op in ("fadd_get", "cswap", "lock")

    def body(ctx):
        row = ctx.spawn(CONSUME, args=[3], dep_count=1) if replies else 0
        call(ctx.pgas, row)

    bs = [TBuilder() for _ in range(2)]
    bs[0].add(EXTRA)
    iv0 = np.zeros((2, 64), np.int32)
    iv0[1, 0] = 5
    iv0[1, 1] = 1 if op == "unlock" else 0  # a held lock, no waiter
    pg = PGASMegakernel(tmk(body), cpu_mesh(2), channels=CHANNELS)
    iv, _, info = pg.run(bs, data={"heap": heap(2)}, ivalues=iv0)
    assert iv[1, :4].tolist() == want
    assert info["pending"] == 0
    assert info["builtin_ams"][op][1] == 1
    if op in ("fadd_get", "cswap"):
        assert iv[0, 2] == 5 and info["builtin_ams"]["reply"][0] == 1
    assert info["executed"] == 1 + replies


def test_pgas_refuses_a_non_power_of_two_mesh():
    assert PGASMegakernel(tmk(), cpu_mesh(3), channels=CHANNELS)._resident \
        is None
    with pytest.raises(ValueError, match="1D mesh"):
        PGASMegakernel(tmk(), CtaMesh((2, 2), ("a", "b"), device="cpu"))
    with pytest.raises(ValueError, match="no data buffer"):
        PGASMegakernel(tmk(), cpu_mesh(2), channels={"c": ("x", 1)})
    with pytest.raises(ValueError, match="am_window"):
        PGASMegakernel(tmk(), cpu_mesh(2), am_window=1)


def test_pgas_argument_errors():
    bs = [TBuilder() for _ in range(2)]
    bs[0].add(NOP)
    pg = PGASMegakernel(tmk(), cpu_mesh(2), channels=CHANNELS)
    with pytest.raises(ValueError, match="bad channel id"):
        pg.run(bs, data={"heap": heap(2)}, waits=[[(5, 1, 0)], []])
    with pytest.raises(ValueError, match="out of range"):
        pg.run(bs, data={"heap": heap(2)}, waits=[[(0, 1, 9)], []])
    bs = [TBuilder() for _ in range(2)]
    bs[0].add(EXTRA)
    with pytest.raises(ValueError, match="not configured"):
        _run(lambda ctx: ctx.pgas.put(1, 7, 0, 0), 2, bs)


def test_ctx_pgas_exists_only_under_pgas():
    bs = [TBuilder()]
    bs[0].add(0)
    mk = Megakernel([("c", consume)], capacity=8, num_values=8,
                    succ_capacity=8, device="cpu")
    with pytest.raises(AttributeError, match="ctx.pgas"):
        mk.run(bs[0])
