"""Philox4x32-10 plain version (kernel 1's CPU form) and the path sampler.

Bits are not compared with JAX's: the two packages' streams differ by
design (c_raytracer_tpu/core/rng.py:18-19).  The kernel itself is held
bit-exact to this plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from c_raytracer_tpu_torch.core import rng

pytest_plugins = ("torch_harness",)


def _words(*vals):
    return [torch.tensor([v], dtype=torch.int64) for v in vals]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's philox4x32_10 known-answer vectors."""
    got = rng.philox4x32_10(*_words(*ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_uniform_layout_and_conversion():
    """Element i is word i % 4 of block i // 4, as (w >> 8) * 2^-24."""
    key = (0x12345678, 0x9abcdef0)
    u = rng.philox_uniform(key, (10,), device="cpu")
    for b in range(3):
        words = rng.philox4x32_10(*_words(b, 0, 0, 0), *key)
        for j, w in enumerate(words):
            if 4 * b + j < 10:
                assert u[4 * b + j].item() == (int(w) >> 8) * 2.0 ** -24


def test_sampler_deterministic_and_distinct_paths():
    s = rng.PhiloxSampler(5, "cpu")
    a = s.uniform((0, 1, 0, 2), (2, 8, 33))
    b = rng.PhiloxSampler(5, "cpu").uniform((0, 1, 0, 2), (2, 8, 33))
    assert a.shape == (2, 8, 33) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    others = [s.uniform(p, (2, 8, 33)) for p in
              [(0, 1, 0, 3), (1, 1, 0, 2), (0, 2, 0, 2), (0, 1, 1, 2)]]
    others.append(rng.PhiloxSampler(6, "cpu").uniform((0, 1, 0, 2),
                                                       (2, 8, 33)))
    for o in others:
        assert (o != a).float().mean() > 0.99
    keys = {rng.path_key(5, (t, r, 0, c)) for t in range(4)
            for r in range(11) for c in range(5)}
    assert len(keys) == 4 * 11 * 5


def test_sample_key_follows_paths():
    s = rng.PhiloxSampler(9, "cpu")
    k = rng.SampleKey(s, (3,)).fold_in(2).fold_in(0).fold_in(4)
    torch.testing.assert_close(k.uniform((5,)), s.uniform((3, 2, 0, 4), (5,)),
                               rtol=0, atol=0)


def test_uniform_statistics():
    u = rng.PhiloxSampler(1234, "cpu").uniform((0, 0, 0, 0),
                                               (200_000,)).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    # U[0,1): mean 1/2, variance 1/12; 5-sigma bounds at n = 2e5
    n = u.size
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert abs(u.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
    assert stats.kstest(u, "uniform").pvalue > 1e-3
