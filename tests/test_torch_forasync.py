"""The port's forasync tier against the JAX package's: the tiling math and
its errors; the stencil and map loops' raw outputs (task table, ready ring,
counts, value slots, tstats and every data buffer, halo included) from
JAX's interpret-mode megakernel and the port's plain core, fed identical
state, word for word, at width 0, batched with the prefetch, batched
LIFO, and cut by fuel with lane entries spilled; arrayadd bit for bit;
and the port's refusals. Everything compared is int32 or one f32 add, so
every comparison is exact."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from hclib_tpu.device import forasync_tier as jfa
from hclib_tpu.device import workloads as jw
from hclib_tpu.device.descriptor import TaskGraphBuilder as JBuilder
from hclib_tpu_torch.device import forasync_tier as tfa
from hclib_tpu_torch.device import megakernel as tmk
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import workloads as tw
from hclib_tpu_torch.device.descriptor import TaskGraphBuilder as TBuilder

FUEL = 1 << 22
# 16 tiles at width 4 with the prefetch, cut after the round that
# consumes the first prefetch: 8 executed, 8 lane entries spilled.
CUT_FUEL = 6
CAP = 64  # run_forasync_device's capacity for up to 56 tiles, both packages


@pytest.fixture(autouse=True)
def _reference_without_hclint(monkeypatch):
    """The JAX reference megakernels are built without their build-time
    verifier (hclint, on by default under pytest): a host analysis that
    cannot change the compiled program, and seconds of test time."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")


# ------------------------------------------------------------ tiling math

GRIDS = {
    "2d": ([16, 512], [8, 128]),
    "1d_lo_hi_int_tile": ([(4, 12)], 4),
    "3d": ([4, 6, 8], [2, 3, 4]),
    "mixed_lo_hi": ([(2, 10), 6], 2),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tiling_math_equals_jax(grid):
    bounds, tile = GRIDS[grid]
    got = tfa.tile_grid(bounds, tile)
    assert got == jfa.tile_grid(bounds, tile)
    dims, tdims, counts, total = got
    args = [tfa.tile_args(dims, tdims, counts, f) for f in range(total)]
    assert args == [jfa.tile_args(dims, tdims, counts, f)
                    for f in range(total)]
    assert tfa.tile_arg_table(bounds, tile).tolist() == args
    bj, bt = JBuilder(), TBuilder()
    assert tfa.seed_tiles(bt, bounds, tile) == jfa.seed_tiles(
        bj, bounds, tile) == total
    for x, y in zip(bj.finalize(), bt.finalize()):
        assert x.tobytes() == y.tobytes()


BAD_GRIDS = {
    "ragged": ([10], [4], "divide the bounds exactly"),
    "rank_mismatch": ([8, 8], [4], "tile rank"),
    "4d": ([2, 2, 2, 2], 1, "1-3 dimensions"),
    "empty": ([(3, 3)], 1, "empty dimension"),
    "zero_tile": ([8], [0], "empty dimension"),
}


@pytest.mark.parametrize("bad", sorted(BAD_GRIDS))
def test_tiling_errors_like_jax(bad):
    bounds, tile, msg = BAD_GRIDS[bad]
    for grid in (jfa.tile_grid, tfa.tile_grid):
        with pytest.raises(ValueError, match=msg):
            grid(bounds, tile)


def test_data_factories_and_references_equal_jax():
    assert (tw.MAP_MUL, tw.MAP_ADD) == (jw.MAP_MUL, jw.MAP_ADD)
    for H, W, seed in ((16, 512, 0), (8, 128, 7)):
        gj, gt = jw.stencil_data(H, W, seed), tw.stencil_data(H, W, seed)
        for x, y in zip(gj, gt):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert np.array_equal(jw.stencil_reference(gj[0]),
                              tw.stencil_reference(gt[0]))
    vj, vt = jw.map_data(4, seed=2), tw.map_data(4, seed=2)
    for x, y in zip(vj, vt):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(jw.map_reference(vj[0]), tw.map_reference(vt[0]))


# ------------------------------------------- raw state, word for word

# loop -> (JAX (tk, bounds, tile), port (tk, bounds, tile), data)
LOOPS = {
    "stencil8": (lambda: jw.stencil_loop(16, 512),
                 lambda: tw.stencil_loop(16, 512),
                 lambda: dict(zip(("gin", "gout"), tw.stencil_data(16, 512)))),
    "stencil16": (lambda: jw.stencil_loop(32, 512),
                  lambda: tw.stencil_loop(32, 512),
                  lambda: dict(zip(("gin", "gout"),
                                   tw.stencil_data(32, 512, seed=3)))),
    "map16": (lambda: jw.map_loop(16), lambda: tw.map_loop(16),
              lambda: dict(zip(("vin", "vout"), tw.map_data(16)))),
}
# arm -> (loop, width, prefetch, fuel)
ARMS = {
    "stencil_w0": ("stencil8", 0, True, FUEL),
    "stencil_w4_prefetch": ("stencil8", 4, True, FUEL),
    "stencil_w4_lifo": ("stencil8", 4, False, FUEL),
    "map_w0": ("map16", 0, True, FUEL),
    "map_w8_prefetch": ("map16", 8, True, FUEL),
    "stencil16_w4_fuel_cut": ("stencil16", 4, True, CUT_FUEL),
}
_BUILT: dict = {}


def _staged(loop):
    """The seeded tables (identical in both packages) and the data."""
    make_j, _, data = LOOPS[loop]
    _, bounds, tile = make_j()
    bj, bt = JBuilder(), TBuilder()
    jfa.seed_tiles(bj, bounds, tile)
    tfa.seed_tiles(bt, bounds, tile)
    fj = bj.finalize(capacity=CAP, succ_capacity=8)
    ft = bt.finalize(capacity=CAP, succ_capacity=8)
    for x, y in zip(fj, ft):
        assert x.tobytes() == y.tobytes()
    return ft, data()


def _built(arm):
    """(JAX megakernel, its compiled raw program, its inputs) of ``arm``.
    The first call
    builds every arm's JAX program: each is lowered in turn while the
    ones before compile on threads (XLA's compile releases the GIL)."""
    if not _BUILT:
        pool = ThreadPoolExecutor(4)
        with jax.default_device(jax.devices("cpu")[0]):
            for name, (loop, width, prefetch, fuel) in ARMS.items():
                jtk = LOOPS[loop][0]()[0]
                mj = jfa.make_forasync_megakernel(
                    jtk, width=width, prefetch=prefetch, capacity=CAP,
                    interpret=True)
                fin, data = _staged(loop)
                iv = np.zeros(mj.num_values, np.int32)
                args = (*fin, iv, *data.values())
                lowered = jax.jit(mj._build_raw(fuel)).lower(*args)
                _BUILT[name] = (mj, pool.submit(lowered.compile), args)
        pool.shutdown(wait=False)
    mj, compiled, args = _BUILT[arm]
    return mj, compiled.result(), args


_RUNS: dict = {}


def _run(arm):
    """(JAX raw outputs, port raw outputs, port megakernel), once."""
    if arm not in _RUNS:
        loop, width, prefetch, fuel = ARMS[arm]
        mj, program, args = _built(arm)
        jax_out = [np.asarray(o) for o in program(*args)]
        mt = tfa.make_forasync_megakernel(
            LOOPS[loop][1]()[0], width=width, prefetch=prefetch,
            capacity=CAP, device="cpu")
        fin, data = _staged(loop)
        st = state.from_numpy(*fin, np.zeros(mt.num_values, np.int32),
                              data=data, device="cpu")
        mt.launch(st, fuel)
        tasks, _, ready, counts, ivalues, d = state.to_numpy(st)
        port_out = [tasks, ready, counts, ivalues, *d.values()]
        if width:
            port_out.append(st["tstats"].numpy())
        assert list(d) == list(mj.data_specs)
        _RUNS[arm] = (jax_out, port_out, mt)
    return _RUNS[arm]


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_raw_state_word_for_word_with_jax(arm):
    jax_out, port_out, _ = _run(arm)
    assert len(jax_out) == len(port_out)
    for i, (w, g) in enumerate(zip(jax_out, port_out)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert np.array_equal(g, w), i


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_outputs_and_tiers(arm):
    """The data equal the numpy reference (halo included), the tiers
    JAX's decode, with the prefetch hits and spills the arm implies."""
    loop, width, prefetch, fuel = ARMS[arm]
    jax_out, port_out, mt = _run(arm)
    counts = port_out[2]
    data = LOOPS[loop][2]()
    tiles = 16 if loop != "stencil8" else 8
    if fuel == FUEL:
        src, dst = port_out[4], port_out[5]
        ref = (tw.stencil_reference(src) if loop.startswith("stencil")
               else tw.map_reference(src))
        assert np.array_equal(dst, ref)
        assert np.array_equal(src, list(data.values())[0])
        assert counts[tmk.C_EXECUTED] == tiles
        assert counts[tmk.C_PENDING] == 0
    if not width:
        return
    tiers = mt.decode_tier_stats(port_out[-1])
    assert tiers == jfa.make_forasync_megakernel(
        LOOPS[loop][0]()[0], width=width, prefetch=prefetch, capacity=CAP,
        interpret=True).decode_tier_stats(jax_out[-1])
    if arm == "stencil_w4_prefetch":
        # JAX's test: every batch past the first had its slabs in flight
        # one round early.
        assert tiers["prefetch_hits"] == 4 and tiers["batch_rounds"] == 2
        assert tiers["batch_occupancy"] == 1.0
    elif arm == "stencil_w4_lifo":
        assert tiers["prefetch_hits"] == 0 and tiers["batch_tasks"] == 8
    elif arm == "map_w8_prefetch":
        assert tiers["batch_tasks"] == 16 and tiers["prefetch_hits"] == 8
    else:  # the fuel cut: 2 rounds ran, 8 entries spilled to the head
        assert counts[tmk.C_EXECUTED] == 8 and counts[tmk.C_PENDING] == 8
        assert tiers["spilled"] == 8 and tiers["prefetch_hits"] == 4
        assert counts[tmk.C_HEAD] == -8


def test_entry_points_match_jax():
    """run_forasync_device at both widths (the default width is 8) on the
    stencil, and the map loop, against JAX's entry point: the outputs
    and the tiers."""
    jtk, bounds, tile = jw.stencil_loop(16, 512)
    ttk = tw.stencil_loop(16, 512)[0]
    gin, gout = tw.stencil_data(16, 512)
    ref = tw.stencil_reference(gin)
    for width in (0, None):
        out, info = tfa.run_forasync_device(
            ttk, bounds, tile, {"gin": gin, "gout": gout.copy()},
            width=width, device="cpu")
        assert np.array_equal(out["gout"].numpy(), ref)
        assert info["executed"] == 8
        if width is None:
            assert info["tiers"]["batch_width"] == 8
            assert info["tiers"]["batch_tasks"] == 8
            assert info["tiers"]["prefetch_hits"] == 0  # one round
    assert np.array_equal(gout, np.zeros_like(gout))  # numpy copied in


def test_arrayadd_bit_for_bit_with_jax():
    aj, bj, cj, ij = jw.device_arrayadd(4, interpret=True)
    at, bt, ct, it = tw.device_arrayadd(4, device="cpu")
    assert np.array_equal(at, aj) and np.array_equal(bt, bj)
    assert ct.dtype == torch.float32
    assert ct.numpy().tobytes() == np.asarray(cj).tobytes()
    assert it["executed"] == ij["executed"] == 4
    assert it["dispatch"] == {"add_tile": 4}


def test_tile_rounds_equal_reference():
    """The standalone tile pipeline's plain path (no scheduler) gives the
    loop's output."""
    gin, gout = tw.stencil_data(16, 512, seed=5)
    tk, bounds, tile = tw.stencil_loop(16, 512)
    mk = tfa.make_forasync_megakernel(tk, width=4, device="cpu")
    data = {"gin": torch.from_numpy(gin), "gout": torch.from_numpy(gout)}
    tfa.tile_rounds(mk, tfa.tile_arg_table(bounds, tile), data)
    assert np.array_equal(data["gout"].numpy(), tw.stencil_reference(gin))


# ------------------------------------------------------------ refusals


def test_prebuilt_width_mismatch_raises():
    tk, bounds, tile = tw.stencil_loop(16, 512)
    gin, gout = tw.stencil_data(16, 512)
    mk = tfa.make_forasync_megakernel(tk, width=4, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        tfa.run_forasync_device(tk, bounds, tile, {"gin": gin, "gout": gout},
                                width=0, mk=mk, device="cpu")
    out, info = tfa.run_forasync_device(
        tk, bounds, tile, {"gin": gin, "gout": gout}, mk=mk, device="cpu")
    assert info["tiers"]["batch_width"] == 4


@pytest.mark.parametrize("arg", ["placement", "mesh"])
def test_placement_and_mesh_name_a11(arg):
    tk, bounds, tile = tw.stencil_loop(16, 512)
    gin, gout = tw.stencil_data(16, 512)
    with pytest.raises(NotImplementedError, match="A11"):
        tfa.run_forasync_device(tk, bounds, tile, {"gin": gin, "gout": gout},
                                device="cpu", **{arg: "block"})


def test_uncompiled_family_names_a4():
    spec = ((4, 8, 128), torch.int32)
    s = tfa.Slab("v", "vin", (tfa.affine(1), 0, 0), (8, 128))
    with pytest.raises(NotImplementedError, match="A4"):
        tfa.TileKernel([s], [tfa.Slab("o", "vout", s.start, s.shape)],
                       {"vin": spec, "vout": spec})
    with pytest.raises(ValueError, match="undeclared"):
        tfa.TileKernel([s], [], {"x": spec}, name="fa_map")


def test_oversize_slabs_raise_on_the_host():
    """A tile whose double-buffered slabs pass the shared memory a block
    gives them raises when the table is built, with the limit."""
    tk = tw.stencil_loop(64, 1024, th=64, tw=512)[0]
    with pytest.raises(ValueError, match=str(tmk.TILE_SMEM_LIMIT)):
        tfa.make_forasync_megakernel(tk, width=8, device="cpu")
    tfa.make_forasync_megakernel(tk, width=0, device="cpu")  # one slot fits


def test_slab_geometry_is_checked():
    tk, bounds, tile = tw.stencil_loop(16, 512)
    gin, gout = tw.stencil_data(16, 512)
    bad = tfa.TileKernel(tk.loads, [tfa.Slab("vout", "gout", (
        tfa.affine(0, 1, const=3), tfa.affine(0, 0, 1)), (8, 128))],
        tk.data_specs, name="fa_stencil")
    with pytest.raises(ValueError, match="leaves buffer 'gout'"):
        tfa.run_forasync_device(bad, bounds, tile, {"gin": gin, "gout": gout},
                                device="cpu")
    wrong = tfa.TileKernel(tk.loads, [tfa.Slab("vout", "gout", (
        tfa.affine(0, 1), tfa.affine(0, 0, 1)), (8, 126))], tk.data_specs,
        name="fa_stencil")
    with pytest.raises(ValueError, match="load slabs must be"):
        tfa.make_forasync_megakernel(wrong, device="cpu")
    with pytest.raises(ValueError, match="slabs="):
        tmk.Megakernel(["fa_map"], data_specs=tw.map_loop(4)[0].data_specs,
                       device="cpu")


@pytest.mark.parametrize("value,msg", [("eight", "must be an int"),
                                       ("0", ">= 1")])
def test_malformed_width_env_raises_like_jax(monkeypatch, value, msg):
    monkeypatch.setenv("HCLIB_TPU_FORASYNC_WIDTH", value)
    for default_width in (jfa._default_width, tfa._default_width):
        with pytest.raises(ValueError, match=msg):
            default_width()
    monkeypatch.setenv("HCLIB_TPU_FORASYNC_WIDTH", "3")
    assert tfa._default_width() == jfa._default_width() == 3
