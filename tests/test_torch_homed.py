"""The port's homed migration, value-arg rehydration and remote atomics
and locks (hclib_tpu_torch/device/resident.py's migrating configuration
and built-in active messages; stress.py's unified_load, the dry run's
phase 0 and the lock workload) held to the JAX package.

Two runs of JAX's Mosaic-interpreted resident kernel (module fixtures;
the interpreter costs seconds a round, so they stay at JAX's smallest
shapes): the 2-device fib(6) of JAX's race-detector test, without the
detector (proxies, remote completions, SUM's value args rehydrated), and
the atomics-and-lock table of ``test_remote_atomics_and_lock`` at 4
devices with steal=False. Each is compared word for word with the port's
plain run: every device's value slots and counts row (its executed
count among them) and the rounds; the port's proxies end at 0. JAX's
other homed tests run on the port alone, held to JAX's assertions.
"""


import numpy as np
import pytest

from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.device.megakernel import Megakernel as JMegakernel
from hclib_tpu.device.resident import ResidentKernel as JResident
from hclib_tpu.device.workloads import make_fib_megakernel as jfib_mk
from hclib_tpu.parallel.mesh import cpu_mesh as jax_mesh
from hclib_tpu_torch.device import stress
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.device.megakernel import VBLOCK, Megakernel
from hclib_tpu_torch.device.resident import (
    RC_NAMES,
    ResidentKernel,
    lock_block_slots,
)
from hclib_tpu_torch.device.workloads import make_fib_megakernel
from hclib_tpu_torch.models.fib import fib_seq, task_count
from hclib_tpu_torch.parallel.mesh import CtaMesh, cpu_mesh

FIB, SUM, BUMP = 0, 1, 0
MIGRATE = {FIB: (), SUM: (0, 1)}


@pytest.fixture(scope="module", autouse=True)
def _reference_without_hclint():
    """The JAX megakernels are built without their build-time verifier
    (hclint, a host analysis that cannot change the compiled program)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HCLIB_TPU_VERIFY", "0")
        yield


def _exec_count(n):
    t = task_count(n)
    return t + (t - 1) // 2


def _fib_mk(capacity, batch_width=None):
    """JAX's _fib_mk: row blocks, 16 host slots, one result slot a row."""
    return make_fib_megakernel(
        capacity, num_values=VBLOCK * capacity + 16 + capacity,
        batch_width=batch_width, device="cpu")


def _fib_run(ndev, n, capacity, quantum, mesh=None, **kw):
    rk = ResidentKernel(_fib_mk(capacity), mesh or cpu_mesh(ndev),
                        migratable_fns=MIGRATE, **kw)
    bs = [TBuilder() for _ in range(ndev)]
    bs[0].add(FIB, args=[n], out=0)
    return rk.run(bs, quantum=quantum)


def assert_same(jout, tout):
    jiv, _, ji = jout
    tiv, _, ti = tout
    np.testing.assert_array_equal(np.asarray(jiv), tiv)
    np.testing.assert_array_equal(np.asarray(ji["per_device_counts"]),
                                  ti["per_device_counts"])
    assert ji["rounds"] == ti["rounds"]
    assert ji["executed"] == ti["executed"]
    assert ti["proxies"] == [0] * len(ti["proxies"])


# ------------------------------------------------- the Mosaic fixtures


@pytest.fixture(scope="module")
def mosaic_homed():
    """JAX's 2-device fib(6) (test_migration_race_free_under_detector's
    run without the detector): capacity 64, window 8, quantum 8."""
    mk = jfib_mk(capacity=64, interpret=True,
                 num_values=VBLOCK * 64 + 16 + 64)
    rk = JResident(mk, jax_mesh(2, axis_name="q"), migratable_fns=MIGRATE,
                   window=8, am_window=8)
    bs = [JBuilder() for _ in range(2)]
    bs[0].add(FIB, args=[6], out=0)
    return rk.run(bs, quantum=8), _fib_run(2, 6, 64, 8, window=8,
                                           am_window=8)


# test_remote_atomics_and_lock's table: every device fetch-adds rank + 1
# into device 0's slot 5 twice and takes device 0's lock to bump X and Y;
# device 1 fetch-adds slot 6 and reads the old value back, device 2
# compare-swaps slot 12 (55 -> 77) and reads the old value back.
NDEV, PER, QCAP, LBASE, X, Y = 4, 2, 4, 16, 8, 9
FADD_ALL, ASKER, CONSUME_R, LOCKER_FN, CSECT_FN, SWAPPER = range(6)


def fadd_all(ctx):
    for _ in range(PER):
        ctx.pgas.fadd(0, 5, 1 + ctx.pgas.me)


def asker(ctx):
    row = ctx.spawn(CONSUME_R, args=[3], dep_count=1)
    ctx.pgas.fadd_get(0, 6, 10, row, 3)


def consume_r(ctx):
    ctx.set_value(4, ctx.value(ctx.arg(0)))


def swapper(ctx):
    row = ctx.spawn(CONSUME_R, args=[3], dep_count=1)
    ctx.pgas.cswap(0, 12, 55, 77, row, 3)


def locker(ctx):
    row = ctx.spawn(CSECT_FN, dep_count=1)
    ctx.pgas.lock(0, LBASE, row, QCAP)


def csect(ctx):
    ctx.pgas.fadd(0, X, 1)
    ctx.pgas.fadd(0, Y, 1)
    ctx.pgas.unlock(0, LBASE, QCAP)


ATOMICS = [("fadd_all", fadd_all), ("asker", asker),
           ("consume_r", consume_r), ("locker", locker), ("csect", csect),
           ("swapper", swapper)]


def _atomics(B, rk):
    bs = [B() for _ in range(NDEV)]
    for b in bs:
        b.add(FADD_ALL)
        b.add(LOCKER_FN)
        b.reserve_values(LBASE + lock_block_slots(QCAP))
    bs[1].add(ASKER)
    bs[2].add(SWAPPER)
    iv0 = np.zeros((NDEV, 256), np.int32)
    iv0[0, 6], iv0[0, 12] = 100, 55
    return rk.run(bs, ivalues=iv0, quantum=8)


@pytest.fixture(scope="module")
def mosaic_atomics():
    jmk = JMegakernel(kernels=ATOMICS, capacity=64, num_values=256,
                      succ_capacity=8, interpret=True)
    tmk = Megakernel(ATOMICS, capacity=64, num_values=256, succ_capacity=8,
                     device="cpu")
    return (_atomics(JBuilder, JResident(jmk, jax_mesh(NDEV, axis_name="q"),
                                         steal=False)),
            _atomics(TBuilder, ResidentKernel(tmk, cpu_mesh(NDEV),
                                              steal=False)))


def test_homed_fib_equals_jax_at_2_devices(mosaic_homed):
    jout, tout = mosaic_homed
    assert_same(jout, tout)
    iv, _, info = tout
    assert int(iv[:, 0].sum()) == fib_seq(6)
    assert info["executed"] == _exec_count(6)
    assert info["per_device_counts"][1, 5] > 0
    # Rows with links left as copies, and their completions came home.
    assert max(info["proxies_peak"]) > 0
    assert sum(info["builtin_ams"]["complete"]) > 0


def test_atomics_and_lock_equal_jax_at_4_devices(mosaic_atomics):
    jout, tout = mosaic_atomics
    assert_same(jout, tout)
    iv, _, info = tout
    assert iv[0, 5] == PER * sum(1 + d for d in range(NDEV))
    assert iv[0, 6] == 110 and iv[1, 4] == 100
    assert iv[0, 12] == 77 and iv[2, 4] == 55
    assert iv[0, X] == NDEV and iv[0, Y] == NDEV
    assert iv[0, LBASE] == 0 and iv[0, LBASE + 1] == 0
    assert info["pending"] == 0
    ams = info["builtin_ams"]
    assert set(ams) == set(RC_NAMES.values())
    assert sum(ams["lock"]) == sum(ams["unlock"]) == NDEV
    assert sum(ams["grant"]) == NDEV and sum(ams["complete"]) == 0


# ------------------- JAX's homed tests, on the port alone (JAX's asserts)


def test_skewed_fib_rebalances_across_devices():
    iv, _, info = _fib_run(8, 9, 160, 16, window=8, am_window=8)
    assert info["pending"] == 0
    assert int(iv[:, 0].sum()) == fib_seq(9)
    assert info["executed"] == _exec_count(9)
    assert int((info["per_device_counts"][:, 5] > 0).sum()) >= 4


def test_homed_chain_two_devices_exact():
    iv, _, info = _fib_run(2, 8, 96, 4, window=16, am_window=8)
    assert info["pending"] == 0
    assert int(iv[:, 0].sum()) == fib_seq(8)
    assert info["executed"] == _exec_count(8)
    assert info["per_device_counts"][1, 5] > 0


def test_proxy_cap_throttles_migration_but_stays_exact():
    iv, _, info = _fib_run(2, 8, 96, 4, window=16, am_window=8,
                           proxy_cap=1)
    assert info["pending"] == 0
    assert int(iv[:, 0].sum()) == fib_seq(8)
    assert info["executed"] == _exec_count(8)
    free = _fib_run(2, 8, 96, 4, window=16, am_window=8)[2]
    assert max(info["proxies_peak"]) < max(free["proxies_peak"])


def test_homed_fib_migrates_on_3d_mesh():
    mesh = CtaMesh((2, 2, 2), ("x", "y", "z"), device="cpu")
    iv, _, info = _fib_run(8, 6, 64, 4, mesh=mesh, window=8, am_window=8)
    assert info["pending"] == 0
    assert int(iv[:, 0].sum()) == fib_seq(6)
    assert info["executed"] == _exec_count(6)
    assert int((info["per_device_counts"][:, 5] > 0).sum()) >= 2


def test_successor_free_rows_still_migrate_whole():
    ndev, ntasks = 4, 28
    mk = Megakernel([("bump", stress._bump0, stress.BUMP0_CUDA)],
                    capacity=128, num_values=512, succ_capacity=8,
                    device="cpu")
    rk = ResidentKernel(mk, cpu_mesh(ndev), migratable_fns=[BUMP],
                        window=8)
    bs = [TBuilder() for _ in range(ndev)]
    for i in range(ntasks):
        bs[0].add(BUMP, args=[i + 1])
    iv, _, info = rk.run(bs, quantum=8)
    assert info["pending"] == 0
    assert info["executed"] == ntasks
    assert int(iv[:, 0].sum()) == ntasks * (ntasks + 1) // 2
    assert int((info["per_device_counts"][:, 5] > 0).sum()) >= 3
    # Link-free rows move whole: no proxy, no completion.
    assert max(info["proxies_peak"]) == 0
    assert sum(info["builtin_ams"]["complete"]) == 0


def test_mesh_batch_fib_matches_scalar_resident():
    ndev, n = 4, 9
    runs = []
    for bw in (None, 4):
        rk = ResidentKernel(_fib_mk(160, bw), cpu_mesh(ndev),
                            migratable_fns=MIGRATE, window=8, am_window=8)
        bs = [TBuilder() for _ in range(ndev)]
        bs[0].add(FIB, args=[n], out=0)
        runs.append(rk.run(bs, quantum=16))
    (iv_s, _, info_s), (iv_b, _, info_b) = runs
    assert "tiers" not in info_s
    assert info_b["pending"] == 0
    assert int(iv_b[:, 0].sum()) == int(iv_s[:, 0].sum()) == fib_seq(n)
    assert info_b["executed"] == info_s["executed"] == _exec_count(n)
    tiers = info_b["tiers"]
    assert len(tiers) == ndev
    batched = sum(t["batch_tasks"] for t in tiers)
    scalar = sum(t["scalar_tasks"] for t in tiers)
    assert batched + scalar == info_b["executed"]
    assert tiers[0]["batch_rounds"] > 0
    assert int((info_b["per_device_counts"][:, 5] > 0).sum()) >= 2


def test_value_args_migrate_with_homed_off():
    """homed=False with SUM's value args: only link-free rows move (fib
    roots, and the SUMs of roots: their args dereferenced on the wire,
    rehydrated on the thief); no proxies. A forest of 24 fib(5) roots on
    device 0 of 4, exact."""
    rk = ResidentKernel(_fib_mk(256), cpu_mesh(4), migratable_fns=MIGRATE,
                        homed=False, window=8, am_window=8)
    bs = [TBuilder() for _ in range(4)]
    for r in range(24):
        bs[0].add(FIB, args=[5], out=r)
    for b in bs:
        b.reserve_values(24)
    iv, _, info = rk.run(bs, quantum=2)
    assert info["pending"] == 0
    assert int(iv[:, :24].sum()) == 24 * fib_seq(5)
    assert info["executed"] == 24 * _exec_count(5)
    assert max(info["proxies_peak"]) == 0
    assert sum(info["exchange"]["rows"]) > 0


# ------------------------------- the workloads of chip_smoke's phase 28


def test_dryrun_phase0():
    """The multi-chip dry run's phase 0 at 8 devices: fib(9) home in
    device 0's slot 3, the remote fetch-add of 7 at its owner."""
    iv, info = stress.dryrun0(8, "cpu")
    assert int(iv[0, 3]) == 34 and int(iv[0, 2]) == 7
    assert info["executed"] == _exec_count(9) + 1
    assert int((info["per_device_counts"][:, 5] > 0).sum()) >= 2


@pytest.mark.parametrize("batch_width", [0, 4])
def test_unified_load_quick(batch_width):
    """unified_load at perf_regression's quick size (n 8, fadds 8,
    capacity 256), scalar and width 4: exact totals (held inside)."""
    info = stress.unified_load(n=8, fadds=8, capacity=256,
                               batch_width=batch_width, device="cpu")
    assert info["tasks"] == _exec_count(8) + 8
    assert info["devices_used"] >= 2
    assert ("tiers" in info) == bool(batch_width)


def test_lock_workload_at_8_devices():
    bs, iv0 = stress.lock_builders(8)
    rk = ResidentKernel(stress.lock_megakernel(device="cpu"), cpu_mesh(8),
                        steal=False)
    iv, _, info = rk.run(bs, ivalues=iv0, quantum=8)
    stress.check_locks(iv, info, 8)
    ams = info["builtin_ams"]
    assert ams["lock"][0] == ams["unlock"][0] == 8
    assert ams["cswap"][0] == 8 + 1 and ams["fadd_get"][0] == 1


def test_lock_fifo_overflow_raises():
    """Four lockers on a lock whose FIFO holds one waiter: the owner
    sets OVF_LOCKQ and the run raises naming the lock FIFO."""
    def lock1(ctx):
        row = ctx.spawn(1, dep_count=1)
        ctx.pgas.lock(0, 8, row, 1)

    def crit(ctx):
        ctx.pgas.unlock(0, 8, 1)

    mk = Megakernel([("lock1", lock1), ("crit", crit)], capacity=16,
                    num_values=32, succ_capacity=8, device="cpu")
    bs = [TBuilder() for _ in range(4)]
    for b in bs:
        b.add(0)
        b.reserve_values(8 + lock_block_slots(1))
    with pytest.raises(RuntimeError, match="lock FIFO"):
        ResidentKernel(mk, cpu_mesh(4), steal=False).run(bs)


def test_value_region_overlapping_the_result_slots_raises():
    """Homed migration reserves [num_values - capacity, num_values): a
    table whose row blocks and host slots reach into it is refused."""
    mk = make_fib_megakernel(64, num_values=VBLOCK * 64 + 16 + 32,
                             device="cpu")
    rk = ResidentKernel(mk, cpu_mesh(2), migratable_fns=MIGRATE)
    bs = [TBuilder() for _ in range(2)]
    bs[0].add(FIB, args=[5], out=0)
    with pytest.raises(ValueError, match="overlaps the migration result"):
        rk.run(bs)
    with pytest.raises(ValueError, match="num_values > capacity"):
        ResidentKernel(Megakernel(["fib", "sum"], capacity=64,
                                  num_values=64, succ_capacity=8,
                                  uses_row_values=True, device="cpu"),
                       cpu_mesh(2), migratable_fns=MIGRATE)


def test_builtin_kinds_only_through_their_ops():
    """ctx.pgas.am refuses a built-in kind (fn < 0): the atomics and
    locks send those."""
    mk = Megakernel([("bad", lambda ctx: ctx.pgas.am(1, -3, [0, 1]))],
                    capacity=8, num_values=8, succ_capacity=8, device="cpu")
    bs = [TBuilder() for _ in range(2)]
    bs[0].add(0)
    with pytest.raises(ValueError, match="built-in kinds"):
        ResidentKernel(mk, cpu_mesh(2), steal=False).run(bs)
    mk = Megakernel([("far", lambda ctx: ctx.pgas.fadd(5, 0, 1))],
                    capacity=8, num_values=8, succ_capacity=8, device="cpu")
    with pytest.raises(ValueError, match="outside the mesh"):
        ResidentKernel(mk, cpu_mesh(2), steal=False).run(bs)
