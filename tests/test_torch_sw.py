"""The port's Smith-Waterman against the JAX package's: the numpy model
(``random_seq``, ``sw_seq``), the torch ``sw_scores`` against JAX's
``sw_scores``, the three megakernel engines against the sequential DP, and
the prefetching wave engine's raw outputs against JAX's interpret run word
for word (everything is int32, so every comparison is exact)."""

import jax
import numpy as np
import pytest
import torch

from hclib_tpu.device import smithwaterman as js
from hclib_tpu.device import sw_vec as jsv
from hclib_tpu.models import smithwaterman as jm
from hclib_tpu_torch.device import smithwaterman as ts
from hclib_tpu_torch.device import state
from hclib_tpu_torch.device import sw_vec as tsv
from hclib_tpu_torch.models import smithwaterman as tm

FUEL = 1 << 22


@pytest.fixture(autouse=True)
def _reference_without_hclint(monkeypatch):
    """The JAX reference megakernels are built without their build-time
    verifier (hclint, on by default under pytest): a host analysis that
    cannot change the compiled program, and seconds of test time."""
    monkeypatch.setenv("HCLIB_TPU_VERIFY", "0")


def test_model_matches_jax():
    assert (tm.MATCH, tm.MISMATCH, tm.GAP) == (jm.MATCH, jm.MISMATCH, jm.GAP)
    for n, seed in ((1, 0), (77, 3), (384, 4)):
        assert np.array_equal(tm.random_seq(n, seed), jm.random_seq(n, seed))
    a, b = tm.random_seq(40, 11), tm.random_seq(56, 12)
    assert np.array_equal(tm.sw_seq(a, b), jm.sw_seq(a, b))


def test_sw_scores_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, (3, 48), dtype=np.int32)
    b = rng.integers(0, 4, (3, 64), dtype=np.int32)
    a[2] = b[2, :48]  # one pair that aligns end to end
    want = np.asarray(jsv.sw_scores(a, b))
    got = tsv.sw_scores(a, b, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert [int(jm.sw_seq(x, y).max()) for x, y in zip(a, b)] == list(want)
    assert tsv.sw_score_one(a[0], b[0], device="cpu") == want[0]


ENGINES = {
    "device_sw": ts.device_sw,
    "device_sw_wave": ts.device_sw_wave,
    "device_sw_batched": ts.device_sw_batched,
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engines_equal_sequential_dp(engine):
    """256 x 384 (2 x 3 tiles): H and the score equal sw_seq; 'executed'
    counts tiles (a wave descriptor counts as its tile count)."""
    a, b = tm.random_seq(256, 3), tm.random_seq(384, 4)
    ref = tm.sw_seq(a, b)[1:, 1:]
    score, h, info = ENGINES[engine](a, b, device="cpu")
    assert np.array_equal(h.numpy(), ref)
    assert score == int(ref.max())
    assert info["executed"] == 6
    assert info["cells_per_sec"] > 0
    if engine == "device_sw":
        assert "tiers" not in info and info["dispatch"] == {"sw_tile": 6}
    else:
        assert info["tiers"]["batch_tasks"] == info["tiers"]["routed"]
        assert info["tiers"]["scalar_tasks"] == 0
    score2, h2, _ = ENGINES[engine](a, b, with_h=False, device="cpu")
    assert h2 is None and score2 == score


def test_wave_prefetch_word_for_word_with_jax():
    """512 x 512, chunk=1, width=2 (tests/test_batch_tier.py's shape:
    mid-waves queue 3-4 descriptors, so the cross-round prefetch engages):
    the port's plain core and JAX's interpret-mode raw program, fed
    identical state, agree on every output - task table, ring, counts,
    values, all five data buffers and tstats - and H equals the scalar
    engine's."""
    a, b = tm.random_seq(512, 5), tm.random_seq(512, 6)
    mj = js.make_sw_wave_megakernel(4, 4, interpret=True, chunk=1, width=2)
    mt = ts.make_sw_wave_megakernel(4, 4, chunk=1, width=2, device="cpu")
    fin = js.build_sw_wave_graph(4, 4, chunk=1).finalize(
        capacity=mj.capacity, succ_capacity=mj.succ_capacity)
    fin_t = ts.build_sw_wave_graph(4, 4, chunk=1).finalize(
        capacity=mt.capacity, succ_capacity=mt.succ_capacity)
    for x, y in zip(fin, fin_t):
        assert x.tobytes() == y.tobytes()
    data = ts.sw_wave_buffers(a, b)
    data["htiles"] = np.zeros((4, 4, 128, 128), np.int32)
    iv = np.zeros(mj.num_values, np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        outs = jax.jit(mj._build_raw(FUEL))(*fin, iv, *data.values())
    outs = [np.asarray(o) for o in outs]
    st = state.from_numpy(*fin, iv, data=data, device="cpu")
    mt.launch(st, FUEL)
    tasks, _, ready, counts, ivalues, d = state.to_numpy(st)
    got = [tasks, ready, counts, ivalues, *d.values(), st["tstats"].numpy()]
    assert list(d) == list(mj.data_specs) == list(data)
    assert len(got) == len(outs)
    for g, w in zip(got, outs):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tiers = mt.decode_tier_stats(got[-1])
    assert tiers == mj.decode_tier_stats(outs[-1])
    assert tiers["prefetch_hits"] > 0 and tiers["batch_tasks"] == 16
    _, h_s, _ = ts.device_sw(a, b, device="cpu")
    h_w = torch.from_numpy(d["htiles"]).transpose(1, 2).reshape(512, 512)
    assert torch.equal(h_w, h_s)
    assert ivalues[0] == int(h_s.max())


def test_sw_rows_plain_handles_boundaries():
    """One tile with all three boundaries set, against the sequential DP
    on the tile's padded (T+1)^2 block."""
    rng = np.random.default_rng(9)
    T = ts.T
    a, b = (rng.integers(0, 4, T, dtype=np.int32) for _ in range(2))
    top = rng.integers(0, 40, T, dtype=np.int32)
    left = rng.integers(0, 40, T, dtype=np.int32)
    corner = 17
    h = np.zeros((T + 1, T + 1), np.int32)
    h[0, 1:], h[1:, 0], h[0, 0] = top, left, corner
    for i in range(1, T + 1):
        for j in range(1, T + 1):
            sub = tm.MATCH if a[i - 1] == b[j - 1] else tm.MISMATCH
            h[i, j] = max(0, h[i - 1, j - 1] + sub, h[i - 1, j] - tm.GAP,
                          h[i, j - 1] - tm.GAP)
    tt = lambda x: torch.from_numpy(x)[None]  # noqa: E731
    last, rcol, hs, m = ts.sw_rows_plain(tt(a), tt(b), tt(top), tt(left),
                                         torch.tensor([corner], dtype=torch.int32),
                                         True)
    assert np.array_equal(hs[0].numpy(), h[1:, 1:])
    assert np.array_equal(last[0].numpy(), h[T, 1:])
    assert np.array_equal(rcol[0].numpy(), h[1:, T])
    assert int(m[0]) == h[1:, 1:].max()


def test_sw_rejects_unaligned_and_oversized_rounds():
    with pytest.raises(ValueError, match="multiples"):
        ts.device_sw(tm.random_seq(100, 1), tm.random_seq(128, 2),
                     device="cpu")
    with pytest.raises(ValueError, match="tile slots"):
        ts.make_sw_wave_megakernel(4, 4, chunk=8, width=4, device="cpu")
