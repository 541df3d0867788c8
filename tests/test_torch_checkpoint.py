"""The port's quiesce protocol and checkpoint runtime
(hclib_tpu_torch/runtime/checkpoint.py) against the JAX package's.

Word for word against JAX in interpret mode: the UTS traversal at
max_depth 8, width 4, built with ``trace=512, checkpoint=True`` (a fuel
cut whose spill is recorded; a quiesce at ``nodes // 3`` with its
exported state and ``info['quiesce']``; its resume to JAX's totals; a
chained quiesce; a threshold past the end), and the 16-vertex dyngraph
update storm of tests/test_checkpoint.py (the exported state, edge
buffers included, and the ``dyngraph`` stamp in the bundle's meta).
Bundles cross both ways: JAX's ``CheckpointBundle.save`` output restores
on the port to JAX's result, and the port's loads with JAX's
``CheckpointBundle.load`` with equal arrays. The port's own: batched
Cholesky and the SW wave (prefetch in flight at the cut) resume bit for
bit to the uninterrupted run, through a bundle on disk. Then the store:
refused corrupt and future-version bundles, publish, retention,
quarantine, the unrecoverable raise, the fault sites (JAX's FaultPlan,
duck-typed), the three environment variables, a mismatched kernel table,
and the refusals that name their ROADMAP items."""

import json
import os

import numpy as np
import pytest
import torch

from hclib_tpu.device import dyngraph as jd
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu.runtime import checkpoint as jc
from hclib_tpu.runtime.resilience import FaultPlan, InjectedFault
from hclib_tpu.runtime.resilience import StallError as JStall
from hclib_tpu_torch.device import cholesky as tch
from hclib_tpu_torch.device import dyngraph as td
from hclib_tpu_torch.device import frontier as tf
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import smithwaterman as tsw
from hclib_tpu_torch.device import tracebuf as ttb
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder
from hclib_tpu_torch.models.cholesky import make_spd
from hclib_tpu_torch.models.smithwaterman import random_seq
from hclib_tpu_torch.runtime import checkpoint as tc
from hclib_tpu_torch.runtime.resilience import StallError as TStall

STATE = ("tasks", "succ", "ready", "counts", "ivalues")
UTS = dict(max_depth=8, batch_width=4, trace=512, checkpoint=True)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")
    for var in ("HCLIB_TPU_TRACE", "HCLIB_TPU_CHECKPOINT",
                "HCLIB_TPU_QUIESCE_STRIDE", "HCLIB_TPU_LANE_MAX_AGE",
                "HCLIB_TPU_PRIORITY_BUCKETS", "HCLIB_TPU_CKPT_DIR",
                "HCLIB_TPU_CKPT_KEEP", "HCLIB_TPU_CKPT_FSYNC"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def uts():
    """The UTS pair, JAX's built once, and the uninterrupted count."""
    jmk = jw.make_uts_megakernel(interpret=True, **UTS)
    tmk_ = tw.make_uts_megakernel(device="cpu", **UTS)
    nodes, info = tw.device_uts_mk(mk=tmk_)
    return jmk, tmk_, nodes, info


def _uts_builder(B):
    b = B()
    b.add(tw.UTS_NODE, args=[1, 0])
    return b


def _runs(uts, fn):
    """fn(mk, Builder) on the JAX then the port megakernel."""
    jmk, tmk_ = uts[0], uts[1]
    return fn(jmk, JBuilder), fn(tmk_, TBuilder)


def same_state(js, ts):
    for k in STATE:
        assert np.array_equal(np.asarray(js[k]), ts[k]), k
    assert set(js["data"]) == set(ts["data"])
    for k, v in js["data"].items():
        v = np.asarray(v)
        v = v.view(np.uint16) if v.dtype.name == "bfloat16" else v
        assert np.array_equal(v, ts["data"][k]), k


def same_trace(ji, ti):
    jr, tr = ji["trace"]["rings"][0], ti["trace"]["rings"][0]
    assert (jr["written"], jr["dropped"]) == (tr["written"], tr["dropped"])
    assert np.array_equal(jr["records"], tr["records"])


def test_uts_fuel_cut_trace_matches_jax(uts):
    """The traced UTS build cut by fuel: the StallError's stats carry the
    ring, whose spill records account for every spilled lane entry."""
    def cut(mk, B):
        with pytest.raises((JStall, TStall)) as e:
            mk.run(_uts_builder(B), fuel=50)
        return e.value.stats
    ji, ti = _runs(uts, cut)
    same_trace(ji, ti)
    jt = {k: v for k, v in ji["tiers"].items()
          if k not in ("build_s", "cache_lookup_s")}
    assert jt == ti["tiers"]
    spills = ttb.records_of(ti["trace"], ttb.TR_SPILL)
    assert int(spills[:, 3].sum()) == ti["tiers"]["spilled"] > 0
    assert ti["quiesced"] is False and "state" not in ti


def test_uts_quiesce_resume_matches_jax(uts):
    """Quiesce at nodes // 3: the exported state and info['quiesce'] are
    JAX's word for word; both resume to JAX's totals; a resumed run
    quiesces again (chained) with JAX's state; the chain completes."""
    nodes, full = uts[2], uts[3]
    (jv, _, ji), (tv, _, ti) = _runs(
        uts, lambda mk, B: mk.run(_uts_builder(B), quiesce=nodes // 3))
    assert ti["quiesced"] is ji["quiesced"] is True and ti["pending"] > 0
    assert ti["quiesce"] == ji["quiesce"]
    assert ti["quiesce"]["executed_at"] >= nodes // 3
    same_state(ji["state"], ti["state"])
    same_trace(ji, ti)
    assert ttb.records_of(ti["trace"], ttb.TR_CKPT)[:, 2].tolist() == [
        ti["pending"]]
    # A snapshot is a copy: a later run leaves it as it was.
    saved = {k: ti["state"][k].copy() for k in STATE}
    jr = uts[0].resume(ji["state"])
    tr = uts[1].resume(ti["state"])
    for k in STATE:
        assert np.array_equal(saved[k], ti["state"][k])
    assert int(tr[0][0]) == int(jr[0][0]) == nodes
    assert tr[2]["executed"] == jr[2]["executed"] == full["executed"]
    # Chained: quiesce the resumed run again, then finish it.
    jq = uts[0].resume(ji["state"], quiesce=nodes // 2)[2]
    tq = uts[1].resume(ti["state"], quiesce=nodes // 2)[2]
    assert tq["quiesce"] == jq["quiesce"] and tq["pending"] > 0
    same_state(jq["state"], tq["state"])
    tv2, _, done = uts[1].resume(tq["state"])
    assert int(tv2[0]) == nodes and done["pending"] == 0


def test_uts_quiesce_past_end_and_off_path(uts):
    """A threshold past the end never fires: the run completes, equal to
    JAX's traced run, with no state; quiesce=False is off; a build
    without checkpoint refuses quiesce=."""
    nodes = uts[2]
    (jv, _, ji), (tv, _, ti) = _runs(
        uts, lambda mk, B: mk.run(_uts_builder(B), quiesce=10 * nodes))
    assert int(tv[0]) == int(jv[0]) == nodes
    assert ti["quiesced"] is False and "state" not in ti
    same_trace(ji, ti)
    assert uts[1].run(_uts_builder(TBuilder), quiesce=False)[2][
        "quiesced"] is False
    plain = tw.make_uts_megakernel(max_depth=8, device="cpu")
    with pytest.raises(ValueError, match="checkpoint=True"):
        plain.run(_uts_builder(TBuilder), quiesce=5)
    assert int(plain.run(_uts_builder(TBuilder), quiesce=False)[0][0]) \
        == nodes


def test_bundles_cross_both_ways(uts, tmp_path):
    """A bundle JAX wrote restores on the port to JAX's count; one the
    port wrote loads with JAX's loader, arrays equal, and restores on
    JAX's megakernel."""
    jmk, tmk_, nodes, _ = uts
    ji = jmk.run(_uts_builder(JBuilder), quiesce=nodes // 2)[2]
    ti = tmk_.run(_uts_builder(TBuilder), quiesce=nodes // 2)[2]
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jc.snapshot_megakernel(jmk, ji).save(jpath)
    stats = tc.snapshot_megakernel(tmk_, ti).save(tpath)
    assert stats["bundle_bytes"] == os.path.getsize(
        os.path.join(tpath, "state.npz"))
    from_jax = tc.CheckpointBundle.load(jpath)
    from_port = jc.CheckpointBundle.load(tpath)
    assert set(from_port.arrays) == set(from_jax.arrays)
    for k, v in from_jax.arrays.items():
        assert np.array_equal(v, from_port.arrays[k]), k
    assert from_port.meta["kernel_names"] == from_jax.meta["kernel_names"]
    fresh = tw.make_uts_megakernel(device="cpu", **UTS)
    tv, _, info = tc.restore_megakernel(jpath, fresh)
    assert int(tv[0]) == nodes and info["pending"] == 0
    jv, _, _ = jc.restore_megakernel(tpath, jmk)
    assert int(jv[0]) == nodes


def test_dyngraph_storm_quiesce_matches_jax():
    """The 16-vertex storm (tests/test_checkpoint.py:1524-1580): quiesce
    at 2 with JAX's exported state, edge buffers included; the bundle
    carries the dyngraph stamp; the resumed fixpoint is host_dyngraph's
    and a bundle restore on a fresh build reaches it too."""
    rng = np.random.default_rng(11)
    n, m = 16, 48
    src, dst, w = (rng.integers(0, n, m), rng.integers(0, n, m),
                   rng.integers(1, 8, m))
    ups = [(1, 5, 3), (2, 7, 1), (0, 9, 2), (4, 3, 6)]
    gj = jd.DynGraph(n, src, dst, w, spare_blocks=2, upd_cap=8)
    gt = td.DynGraph(n, src, dst, w, spare_blocks=2, upd_cap=8)
    for u, v, wt in ups:
        gj.add_update(u, v, wt)
        gt.add_update(u, v, wt)
    mj = jd.make_dyngraph_megakernel("sssp", gj, width=0, interpret=True,
                                     checkpoint=True)
    jd._bind_updates(mj, gj)
    builders, _ = jd._seed_builders(gj, "sssp", 0, 1 << 14, 64, [5],
                                    mj.num_values, 1, lambda i, tot: 0)
    iv = gj.preset_values(mj.num_values, jd.INF)
    iv[gj.st_base] = 0
    _, _, ji = mj.run(builders[0], data=dict(jd.fk_data(gj, mj)),
                      ivalues=iv, quiesce=2)

    def port_mk():
        mk = td.make_dyngraph_megakernel("sssp", gt, width=0,
                                         checkpoint=True, device="cpu")
        td._bind_updates(mk, gt)
        return mk
    mt = port_mk()
    b, ivt, data = td.dyngraph_state("sssp", gt, mt, 0, [5], 1 << 14, 64)
    _, _, ti = mt.run(b, data=data, ivalues=ivt, quiesce=2)
    assert ti["quiesced"] and ti["pending"] > 0
    assert ti["quiesce"] == ji["quiesce"]
    same_state(ji["state"], ti["state"])
    bundle = tc.snapshot_megakernel(mt, ti)
    jbundle = jc.snapshot_megakernel(mj, ji)
    assert bundle.meta["dyngraph"] == jbundle.meta["dyngraph"]
    assert len(bundle.meta["dyngraph"]["updates"]) == 4
    ref = td.host_dyngraph("sssp", gt, 0)
    iv_r = np.asarray(mt.resume(ti["state"])[0], np.int64)
    assert np.array_equal(iv_r[gt.st_base:gt.st_base + n], ref)
    flags = iv_r[gt.flag_base:gt.flag_base + gt.upd_cap]
    vt = iv_r[tf.VT_BASE:tf.VT_BASE + 3 * n].reshape(n, 3)
    assert int((flags != 0).sum()) == 4
    assert int(vt[:, 2].sum()) == int(gt.deg.sum()) + 4
    iv_b = np.asarray(tc.restore_megakernel(bundle, port_mk())[0], np.int64)
    assert np.array_equal(iv_b[gt.st_base:gt.st_base + n], ref)


def test_cholesky_batch_tier_resume_bit_identical(tmp_path):
    """Batched Cholesky (nt=3, tile 128) quiesced mid-graph, restored
    through a bundle on disk (the bf16 split buffers as JAX encodes
    them) on a fresh build: L equals the uninterrupted factor bit for
    bit."""
    nt = 3
    a = make_spd(3 * 128).astype(np.float32)
    full = tch.make_cholesky_megakernel(nt, tile=128, device="cpu")
    _, d_full, i_full = full.run(tch.build_cholesky_graph(nt),
                                 data=tch.cholesky_buffers(a, nt,
                                                           device="cpu"))
    mk = tch.make_cholesky_megakernel(nt, tile=128, checkpoint=True,
                                      device="cpu")
    _, _, iq = mk.run(tch.build_cholesky_graph(nt),
                      data=tch.cholesky_buffers(a, nt, device="cpu"),
                      quiesce=3)
    assert iq["quiesced"] and iq["pending"] > 0
    path = str(tmp_path / "chol")
    tc.snapshot_megakernel(mk, iq).save(path)
    bundle = tc.CheckpointBundle.load(path)
    assert bundle.meta["dtypes"] == {"data/linvsp": "bfloat16",
                                     "data/lsp": "bfloat16"}
    fresh = tch.make_cholesky_megakernel(nt, tile=128, checkpoint=True,
                                         device="cpu")
    _, d_r, i_r = tc.restore_megakernel(bundle, fresh)
    assert i_r["pending"] == 0 and i_r["executed"] == i_full["executed"]
    for k in ("tiles", "linvsp", "lsp"):
        assert torch.equal(bits(d_r[k]), bits(d_full[k])), k


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def test_sw_wave_prefetch_resume_bit_identical():
    """The SW wave at chunk 1, width 2 on 4 x 4 tiles, quiesced at 7 with
    the next batch's prefetch in flight (drained at the cut): the resumed
    H, best score and executed count equal the uninterrupted run's."""
    a, b = random_seq(512, 5), random_seq(512, 6)

    def fresh():
        d = tsw.sw_wave_buffers(a, b)
        d["htiles"] = np.zeros((4, 4, 128, 128), np.int32)
        return d
    full = tsw.make_sw_wave_megakernel(4, 4, chunk=1, width=2, device="cpu")
    iv_f, out_f, i_f = full.run(tsw.build_sw_wave_graph(4, 4, chunk=1),
                                data=fresh())
    mk = tsw.make_sw_wave_megakernel(4, 4, chunk=1, width=2, trace=64,
                                     checkpoint=True, device="cpu")
    _, _, iq = mk.run(tsw.build_sw_wave_graph(4, 4, chunk=1), data=fresh(),
                      quiesce=7)
    assert iq["quiesced"] and iq["pending"] > 0
    assert len(ttb.records_of(iq["trace"], ttb.TR_PREFETCH_DRAIN)) == 1
    iv_r, out_r, i_r = mk.resume(iq["state"])
    assert np.array_equal(out_r["htiles"].numpy(), out_f["htiles"].numpy())
    assert int(iv_r[0]) == int(iv_f[0])
    assert i_r["executed"] == i_f["executed"]


def _bundle(seed: int, nodes_cut: int = 40) -> tc.CheckpointBundle:
    mk = tw.make_uts_megakernel(max_depth=6, seed=seed, checkpoint=True,
                                device="cpu")
    info = mk.run(_uts_builder(TBuilder), quiesce=nodes_cut)[2]
    return tc.snapshot_megakernel(mk, info)


def test_bundle_corruption_and_version_refused(tmp_path):
    path = str(tmp_path / "ckpt")
    _bundle(19).save(path)
    npz = os.path.join(path, "state.npz")
    blob = open(npz, "rb").read()
    with open(npz, "wb") as f:
        f.write(blob[:-8] + b"\x00" * 8)
    with pytest.raises(tc.CheckpointError, match="corrupt"):
        tc.CheckpointBundle.load(path)
    with open(npz, "wb") as f:
        f.write(blob)
    man_path = os.path.join(path, "manifest.json")
    man = json.load(open(man_path))
    for key, value, msg in (("version", 99, "version 99"),
                            ("magic", "something-else", "magic")):
        bad = dict(man, **{key: value})
        json.dump(bad, open(man_path, "w"))
        with pytest.raises(tc.CheckpointError, match=msg) as ei:
            tc.CheckpointBundle.load(path, generation=3)
        assert man_path in str(ei.value)
    json.dump(man, open(man_path, "w"))
    b = tc.CheckpointBundle.load(path)
    assert b.diff(_bundle(19))["equal"]
    d = b.diff(_bundle(20))
    assert not d["equal"] and d["mismatched"]["tasks"]["n"] > 0


def test_store_publish_retention_and_self_heal(tmp_path):
    """gen-N dirs with CURRENT last, keep=2 retention, a newest-first
    load; a corrupted newest generation is quarantined with a typed fault
    and the load falls back, with the CK_* host records."""
    root = str(tmp_path / "store")
    store = tc.BundleStore(root, keep=2, fsync=False)
    bundles = [_bundle(s) for s in (1, 2, 3)]
    assert [store.save(b) for b in bundles] == [1, 2, 3]
    assert store.generations() == [2, 3]
    assert open(os.path.join(root, "CURRENT")).read().strip() == "3"
    got = tc.BundleStore(root, fsync=False).load_latest()
    assert got.diff(bundles[-1])["equal"] and got.generation == 3
    npz = os.path.join(store.path_of(3), "state.npz")
    blob = open(npz, "rb").read()
    with open(npz, "wb") as f:
        f.write(blob[:-4] + b"\xff" * 4)
    healer = tc.BundleStore(root, keep=2, fsync=True)
    back = healer.load_latest()
    assert back.generation == 2 and back.diff(bundles[1])["equal"]
    (f,) = healer.faults
    assert isinstance(f, tc.BundleFault)
    assert (f.generation, f.reason) == (3, "corrupt")
    assert "quarantine" in f.path and os.path.isdir(f.path)
    assert healer.generations() == [2]
    assert [-int(r[2]) - 1 for r in healer.events] == [
        ttb.CK_QUARANTINE, ttb.CK_FALLBACK, ttb.CK_LOAD]
    assert healer.trace_info()["rings"][0]["written"] == 3
    with pytest.raises(tc.CheckpointError, match="keep"):
        tc.BundleStore(root, keep=0)


def test_store_unrecoverable_and_fault_sites(tmp_path):
    """No valid generation raises naming every fault; JAX's FaultPlan
    drives the preempt-mid-save (nothing published) and
    preempt-mid-restore (the retry succeeds) sites."""
    root = str(tmp_path / "store")
    store = tc.BundleStore(root, fsync=False)
    store.save(_bundle(1))
    store.save(_bundle(2))
    for g in store.generations():
        os.remove(os.path.join(store.path_of(g), "manifest.json"))
    healer = tc.BundleStore(root, fsync=False)
    with pytest.raises(tc.CheckpointError) as ei:
        healer.load_latest()
    msg = str(ei.value)
    assert "unrecoverable" in msg and "gen 1" in msg and "gen 2" in msg
    assert all(f.reason == "torn" for f in healer.faults)
    with pytest.raises(tc.CheckpointError, match="no generations"):
        tc.BundleStore(str(tmp_path / "empty"), fsync=False).load_latest()
    root = str(tmp_path / "chaos")
    good = _bundle(3)
    tc.BundleStore(root, fsync=False).save(good)
    writer = tc.BundleStore(root, fsync=False,
                            fault_plan=FaultPlan(seed=0, preempt_save_at=0))
    with pytest.raises(InjectedFault, match="mid-save"):
        writer.save(_bundle(4))
    assert tc.BundleStore(root, fsync=False).generations() == [1]
    assert tc.BundleStore(root, fsync=False).save(_bundle(5)) == 2
    reader = tc.BundleStore(
        root, fsync=False, fault_plan=FaultPlan(seed=0, preempt_restore_at=0))
    with pytest.raises(InjectedFault, match="mid-restore"):
        reader.load_latest()
    assert reader.load_latest().generation == 2


def test_store_env_variables(tmp_path, monkeypatch):
    """HCLIB_TPU_CKPT_DIR roots default_store(); _KEEP sets retention
    (malformed text raises naming it); _FSYNC=0 the fast mode."""
    assert tc.default_store() is None
    root = str(tmp_path / "envstore")
    monkeypatch.setenv("HCLIB_TPU_CKPT_DIR", root)
    monkeypatch.setenv("HCLIB_TPU_CKPT_KEEP", "2")
    monkeypatch.setenv("HCLIB_TPU_CKPT_FSYNC", "0")
    store = tc.default_store()
    assert store.root == root and store.keep == 2 and store.fsync is False
    for s in (1, 2, 3):
        store.save(_bundle(s))
    assert store.generations() == [2, 3]
    monkeypatch.delenv("HCLIB_TPU_CKPT_FSYNC")
    assert tc.default_store().fsync is True
    monkeypatch.setenv("HCLIB_TPU_CKPT_KEEP", "junk")
    with pytest.raises(ValueError, match="HCLIB_TPU_CKPT_KEEP"):
        tc.default_store()


def test_restore_refuses_mismatched_program(tmp_path):
    """F_FN words index the table by position: another table, another
    capacity or a non-megakernel bundle is refused, naming the bundle's
    path and generation; a run that did not quiesce has no state."""
    bundle = _bundle(19)
    store = tc.BundleStore(str(tmp_path / "s"), fsync=False)
    store.save(bundle)
    loaded = store.load_latest()
    other = tmk.Megakernel(["fib", "sum"], capacity=64,
                           num_values=4 * 64 + 16, device="cpu")
    with pytest.raises(tc.CheckpointError, match="kernel_names") as ei:
        tc.restore_megakernel(loaded, other)
    assert "[0] 'fib' here != 'uts_node' in the bundle" in str(ei.value)
    assert "generation 1" in str(ei.value)
    wrong_cap = tw.make_uts_megakernel(max_depth=6, capacity=512,
                                       device="cpu")
    with pytest.raises(tc.CheckpointError, match="capacity"):
        tc.restore_megakernel(bundle, wrong_cap)
    bundle.kind = "stream"
    with pytest.raises(tc.CheckpointError, match="megakernel"):
        tc.restore_megakernel(bundle, wrong_cap)
    with pytest.raises(tc.CheckpointError, match="no quiesced state"):
        tc.snapshot_megakernel(wrong_cap, {"executed": 1})


def _nockpt_stream():
    from hclib_tpu_torch.device.inject import StreamingMegakernel

    return StreamingMegakernel(tw.make_fib_megakernel(device="cpu"))


# The stream and resident-mesh paths (snapshot_stream, restore_stream,
# checkpoint_on_preempt, reshard, snapshot_resident, restore_resident) are
# ported: their cases hold the refusals they now make (a run with no
# quiesced state, a bundle of another kind, a stream that cannot
# quiesce), with JAX's messages; the ids are the ones these cases had
# when the paths were left out.
@pytest.mark.parametrize("call,exc,item", [
    (lambda b: b.reshard(2), tc.CheckpointError,
     "reshard applies to resident-mesh bundles, not megakernel"),
    (lambda b: tc.snapshot_stream(None, {}), tc.CheckpointError,
     "no quiesced state"),
    (lambda b: tc.restore_stream(b, None), tc.CheckpointError,
     "restore_stream got a 'megakernel' bundle"),
    (lambda b: tc.checkpoint_on_preempt(_nockpt_stream()), ValueError,
     "checkpoint=True"),
    (lambda b: tc.snapshot_resident(None, {}), tc.CheckpointError,
     "no quiesced state"),
    (lambda b: tc.restore_resident(b, None), tc.CheckpointError,
     "restore_resident got a 'megakernel' bundle"),
    (lambda b: b.save("/nonexistent/never", metrics=object()),
     NotImplementedError, "A13"),
    (lambda b: tc.BundleStore("/nonexistent/never", metrics=object()),
     NotImplementedError, "A13"),
], ids=["call0-A11", "call1-A10", "call2-A10", "call3-A10", "call4-A11",
        "call5-A11", "call6-A13", "call7-A13"])
def test_left_out_paths_name_their_items(call, exc, item):
    with pytest.raises(exc, match=item):
        call(tc.CheckpointBundle("megakernel", {}, {}))
