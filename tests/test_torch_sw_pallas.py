"""The port's batched Smith-Waterman score kernel, plain version on the
CPU, against JAX's ``sw_scores_pallas`` (interpret mode), the sequential
DP ``sw_seq`` and the port's own ``sw_vec`` scores, at the shapes of
``tests/test_sw_pallas.py`` (odd n for the multiple-of-8 padding, B=9 for
the 128-lane batch padding)."""

import numpy as np
import pytest
import torch

from hclib_tpu.device.sw_pallas import sw_scores_pallas as jax_scores
from hclib_tpu_torch.device import sw_pallas as tsp
from hclib_tpu_torch.device.sw_vec import sw_scores
from hclib_tpu_torch.models.smithwaterman import sw_seq


def _pairs(B, n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (B, n)).astype(np.int32),
            rng.integers(0, 4, (B, m)).astype(np.int32))


@pytest.mark.parametrize("B,n,m", [(6, 97, 128), (9, 64, 256)])
def test_scores_like_jax_and_references(B, n, m):
    a, b = _pairs(B, n, m, B)
    got = tsp.sw_scores_pallas(a, b, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B,)
    want = np.asarray(jax_scores(a, b, interpret=True))
    assert got.tolist() == want.tolist()
    assert got.tolist() == [int(sw_seq(a[i], b[i]).max()) for i in range(B)]
    assert torch.equal(got, sw_scores(a, b, device="cpu"))


def test_plain_needs_no_padding():
    """The unpadded plain sweep gives the padded one's scores (the card
    takes any n and m), also for an m that is no multiple of 32."""
    a, b = _pairs(5, 13, 45, 7)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    plain = tsp.sw_scores_plain(at.T.contiguous(), bt.T.contiguous())
    assert torch.equal(plain, tsp.sw_scores_batch(at, bt))
    assert plain.tolist() == [int(sw_seq(a[i], b[i]).max()) for i in range(5)]


def test_input_checks():
    a, b = _pairs(3, 8, 8, 1)
    with pytest.raises(ValueError, match="B, n"):
        tsp.sw_scores_batch(torch.from_numpy(a), torch.from_numpy(b[:2]))
    with pytest.raises(ValueError, match="int32"):
        tsp.sw_scores_batch(torch.from_numpy(a).long(), torch.from_numpy(b))
