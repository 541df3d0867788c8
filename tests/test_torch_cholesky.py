"""The port's Cholesky tile math and megakernel run against the JAX
package's.

Tolerance: max|port - jax| / max|jax| < 1e-5 for the factor L, the bound
the JAX package's own Cholesky tests hold it to
(tests/test_device_workloads.py). The two differ by rounding: JAX sums
three bf16 products and drops lo*lo, the port multiplies the (hi + lo)
values in f32, and the sums run in another order.

The inverse of a diagonal tile (``linvsp``) and the operands derived from
it (``lsp``) are held against the float64 truth as well: JAX computes the
inverse by a Newton-Schulz iteration on 3-pass bf16 products, which lands
1.6e-5 to 2.4e-5 (relative to the largest entry) from the float64 values,
more than ``TOL``, while the port's f32 forward substitution lands
2.5e-7 from the inverse of one tile. So the port must be at least as close
to the truth as JAX (within ``EXACT_TOL`` for a single tile), and no
further from JAX than ``TOL`` plus JAX's own error. ``split_bf16`` is
bit-exact.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hclib_tpu.device import cholesky as jc
from hclib_tpu.ops import tiles as jt
from hclib_tpu_torch.device import cholesky as tc
from hclib_tpu_torch.models.cholesky import make_spd as t_make_spd
from hclib_tpu.models.cholesky import make_spd as j_make_spd
from hclib_tpu_torch.ops import tiles as tt

TOL = 1e-5
EXACT_TOL = 1e-6


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _bits(a):
    return np.asarray(a).view(np.uint16)


def _unsplit_np(hi, lo):
    f = lambda x: np.asarray(x).view(ml_dtypes.bfloat16).astype(np.float32)  # noqa: E731
    return f(hi) + f(lo)


def test_make_spd_identical():
    assert np.array_equal(t_make_spd(96, seed=3), j_make_spd(96, seed=3))


def test_split_bf16_bit_exact():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 256)) * 10.0 ** rng.integers(
        -20, 20, (64, 256))).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 1.0, 3.0e38, 1e-40, -7.5]
    hj, lj = jt.split_bf16(jnp.asarray(x))
    ht, lt = tt.split_bf16(torch.from_numpy(x))
    assert np.array_equal(_bits(hj), ht.view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(_bits(lj), lt.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("ts,base", [(128, 128), (256, 128)])
def test_factor_and_inv_matches_jax(ts, base):
    a = j_make_spd(ts, seed=ts).astype(np.float32)
    lj, ij = jt.factor_and_inv(jnp.asarray(a), ts, base=base)
    lt, it = tt.factor_and_inv(torch.from_numpy(a), ts, base=base)
    assert _rel(lt.numpy(), lj) < TOL
    assert np.all(np.triu(lt.numpy(), 1) == 0)
    l64 = np.linalg.cholesky(a.astype(np.float64))
    i64 = np.linalg.inv(l64)
    assert _rel(lt.numpy(), l64) < EXACT_TOL
    assert _rel(it.numpy(), i64) < EXACT_TOL
    assert _rel(it.numpy(), ij) < TOL + _rel(ij, i64)


def test_split_products_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((2, 128, 128)).astype(np.float32))
    ah, al = jt.split_bf16(jnp.asarray(a))
    bh, bl = jt.split_bf16(jnp.asarray(b))
    def th(x):
        return torch.from_numpy(_bits(x).view(np.int16).copy()).view(
            torch.bfloat16)

    ref = jt.mm_nt_split(ah, al, bh, bl)
    got = tt.mm_nt_split(th(ah), th(al), th(bh), th(bl))
    assert _rel(got.numpy(), ref) < TOL
    ref = jt.mm_nt_rsplit(jnp.asarray(a), bh, bl)
    got = tt.mm_nt_rsplit(torch.from_numpy(a), th(bh), th(bl))
    assert _rel(got.numpy(), ref) < TOL
    assert _rel(tt.mm_nt(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                jt.mm_nt(jnp.asarray(a), jnp.asarray(b))) < TOL
    assert _rel(tt.mm_nn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                jt.mm_nn(jnp.asarray(a), jnp.asarray(b))) < TOL


CHOL_CASES = {"n256_t128": (256, 128), "n512_t256_b128": (512, 256)}


@pytest.fixture(scope="module", params=sorted(CHOL_CASES))
def chol_pair(request):
    n, tile = CHOL_CASES[request.param]
    nt = n // tile
    a = j_make_spd(n).astype(np.float32)
    mj = jc.make_cholesky_megakernel(nt, interpret=True, tile=tile,
                                     factor_base=128, batch_updrow=False)
    with jax.default_device(jax.devices("cpu")[0]):
        _, dj, ij = mj.run(jc.build_cholesky_graph(nt),
                           data=jc.cholesky_buffers(a, nt, tile))
    mt = tc.make_cholesky_megakernel(nt, tile=tile, factor_base=128,
                                     batch_updrow=False, device="cpu")
    _, dt, it = mt.run(tc.build_cholesky_graph(nt),
                       data=tc.cholesky_buffers(a, nt, tile, device="cpu"))
    # The float64 truth of each buffer: L's tiles and the inverses of its
    # diagonal tiles.
    l64 = jc._to_tiles(np.linalg.cholesky(a.astype(np.float64)), nt, tile)
    l64 = l64.astype(np.float64)
    exact = {
        "linvsp": np.stack([np.linalg.inv(
            np.linalg.cholesky(a[k * tile:(k + 1) * tile,
                                 k * tile:(k + 1) * tile].astype(np.float64)
                               - sum(l64[k, j] @ l64[k, j].T
                                     for j in range(k))))
            for k in range(nt)]),
        "lsp": np.stack([np.stack([
            l64[i, k] if i > k else np.zeros((tile, tile))
            for k in range(nt)]) for i in range(nt)]),
    }
    return a, nt, tile, (dj, ij), (dt, it), exact


def test_device_cholesky_factor_matches_jax(chol_pair):
    a, nt, tile, (dj, ij), (dt, it), _ = chol_pair
    lj = np.tril(jc._from_tiles(np.asarray(dj["tiles"]), nt, tile))
    lt = torch.tril(tc._from_tiles(dt["tiles"], nt, tile)).numpy()
    assert _rel(lt, lj) < TOL
    assert it["executed"] == ij["executed"] == nt + (nt - 1) + nt * (nt - 1) // 2
    l64 = lt.astype(np.float64)
    assert np.max(np.abs(l64 @ l64.T - a)) / np.max(np.abs(a)) < TOL


@pytest.mark.parametrize("buf", ["linvsp", "lsp"])
def test_device_cholesky_split_caches_match_jax(chol_pair, buf):
    _, nt, _, (dj, _), (dt, _), exact = chol_pair
    bits = dt[buf].view(torch.int16).numpy().view(np.uint16)
    ref = np.asarray(dj[buf])
    got = _unsplit_np(bits[..., 0, :, :].copy(), bits[..., 1, :, :].copy())
    want = _unsplit_np(_bits(ref[..., 0, :, :]), _bits(ref[..., 1, :, :]))
    assert _rel(got, exact[buf]) <= _rel(want, exact[buf])
    assert _rel(got, want) < TOL + _rel(want, exact[buf])


def test_device_cholesky_entry_point():
    a = t_make_spd(256).astype(np.float32)
    L, info = tc.device_cholesky(a, device="cpu")
    # The table holds every Cholesky body; the fused graph runs no TRSM,
    # and the default routes UPDROW through the batch tier.
    assert info["executed"] == 4 and info["dispatch"] == {
        "potrf": 2, "updrow": 0, "trsmcol": 1, "trsm": 0, "updrow_batch": 1}
    l64 = L.numpy().astype(np.float64)
    assert np.max(np.abs(l64 @ l64.T - a)) / np.max(np.abs(a)) < TOL


def test_standalone_bodies_match_megakernel_on_cpu():
    """potrf/trsmcol/updrow on CPU tensors are the plain bodies; one
    fused step of the graph by hand equals the scheduler's run."""
    a = t_make_spd(256).astype(np.float32)
    d = tc.cholesky_buffers(a, 2, 128, device="cpu")
    tc.potrf(d["tiles"], d["linvsp"], 0, 128)
    tc.trsmcol(d["tiles"], d["linvsp"], d["lsp"], 0)
    tc.updrow(d["tiles"], d["lsp"], 1, 0)
    tc.potrf(d["tiles"], d["linvsp"], 1, 128)
    mk = tc.make_cholesky_megakernel(2, tile=128, batch_updrow=False,
                                     device="cpu")
    _, dm, _ = mk.run(tc.build_cholesky_graph(2),
                      data=tc.cholesky_buffers(a, 2, 128, device="cpu"))
    for k in d:
        assert torch.equal(d[k], dm[k])


def test_left_out_forms_raise():
    """Every form runs: batch_updrow=True (the default) and False give
    the same factor bit for bit; the unfused graph's TRSM runs."""
    a = t_make_spd(256).astype(np.float32)
    Lb, info = tc.device_cholesky(a, batch_updrow=True, device="cpu")
    assert info["tiers"]["batch_tasks"] == 1
    assert info["tiers"]["scalar_tasks"] == 3
    Ls, info = tc.device_cholesky(a, batch_updrow=False, device="cpu")
    assert "tiers" not in info and torch.equal(Lb, Ls)
    L, info = tc.device_cholesky(a, fused_trsm=False, device="cpu")
    assert info["dispatch"]["trsm"] == 1 and info["executed"] == 4
    mk = tc.make_cholesky_megakernel(2, tile=128, batch_updrow=False,
                                     device="cpu")
    _, d, info = mk.run(tc.build_cholesky_graph(2, fused_trsm=False),
                        data=tc.cholesky_buffers(a, 2, 128, device="cpu"))
    assert info["dispatch"] == {"potrf": 2, "trsm": 1, "updrow": 1,
                                "trsmcol": 0}
    assert torch.equal(torch.tril(tc._from_tiles(d["tiles"], 2, 128)), L)
    with pytest.raises(ValueError, match="factor_base"):
        tc.make_cholesky_megakernel(2, tile=128, factor_base=96, device="cpu")


def test_trsm_plain_matches_jax():
    """One tile: A inv(L)^T against JAX's mm_nt_rsplit, and the stored
    split is JAX's split_bf16 of the port's own result, bit for bit."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    inv = np.tril(rng.standard_normal((128, 128))).astype(np.float32)
    ih, il = jt.split_bf16(jnp.asarray(inv))
    want = jt.mm_nt_rsplit(jnp.asarray(a), ih, il)
    bufs = tc.cholesky_buffers(np.zeros((256, 256), np.float32), 2, 128,
                               device="cpu")
    bufs["tiles"][1, 0] = torch.from_numpy(a)
    bufs["linvsp"][0, 0], bufs["linvsp"][0, 1] = tt.split_bf16(
        torch.from_numpy(inv))
    tc.trsm(bufs["tiles"], bufs["linvsp"], bufs["lsp"], 1, 0)
    got = bufs["tiles"][1, 0].numpy()
    assert _rel(got, want) < TOL
    jh, jl = jt.split_bf16(jnp.asarray(got))
    bits = bufs["lsp"].view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits[1, 0, 0], _bits(jh))
    assert np.array_equal(bits[1, 0, 1], _bits(jl))


@pytest.mark.parametrize("chol_pair", ["n256_t128"], indirect=True)
def test_device_cholesky_unfused_matches_jax(chol_pair):
    """The unfused graph (tile TRSM tasks) against the JAX factor of the
    fused graph; the per-tile arithmetic is the same, so it also equals
    the port's fused factor."""
    a, nt, tile, (dj, _), (dt, _), _ = chol_pair
    L, info = tc.device_cholesky(a, tile=tile, fused_trsm=False, device="cpu")
    assert info["executed"] == nt + nt * (nt - 1)
    assert info["dispatch"]["trsm"] == nt * (nt - 1) // 2
    lj = np.tril(jc._from_tiles(np.asarray(dj["tiles"]), nt, tile))
    assert _rel(L.numpy(), lj) < TOL
    assert torch.equal(L, torch.tril(tc._from_tiles(dt["tiles"], nt, tile)))
