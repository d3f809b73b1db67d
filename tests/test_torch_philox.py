"""The port's Philox4x32-10 dropout masks (ops/philox.py, the plain
version of csrc/philox.cuh): the Random123 known-answer vectors, offsets,
the keep rate and seed behaviour."""
import math

import pytest
import torch

from tvqaplus_tpu_torch.ops import philox

torch.set_num_threads(1)


def words(c, k):
    t = [torch.tensor([x], dtype=torch.int64) for x in c]
    return [int(w) for w in philox.philox_rounds(*t, *k)]


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_known_answer_vectors(ctr, key, expect):
    assert tuple(words(ctr, key)) == expect


def test_counter_and_key_split_into_words():
    """philox4x32_10 feeds the 64-bit counter and seed as (lo, hi) words."""
    ctr, seed = (7 << 32) | 11, (5 << 32) | 3
    got = philox.philox4x32_10(torch.tensor([ctr]), seed)
    assert [int(w) for w in got] == words((11, 7, 0, 0), (3, 5))


@pytest.mark.parametrize("offset,n", [(0, 37), (3, 100), (4096 + 2, 9)])
def test_mask_at_an_offset_is_the_slice_of_the_full_mask(offset, n):
    full = philox.keep_mask(offset + n, 1234, 0.1)
    assert torch.equal(philox.keep_mask(n, 1234, 0.1, offset=offset),
                       full[offset:])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_binomial_bound(p):
    n = 1 << 18
    keep = philox.keep_mask(n, 99, p).double().mean().item()
    sd = math.sqrt(p * (1 - p) / n)
    assert abs(keep - (1 - p)) < 5 * sd


def test_seeds_and_multiplier():
    a = philox.keep_mask(4096, 1, 0.1)
    assert torch.equal(a, philox.keep_mask(4096, 1, 0.1))
    assert not torch.equal(a, philox.keep_mask(4096, 2, 0.1))
    m = philox.multiplier((64, 64), 1, 0.1)
    assert set(m.unique().tolist()) == {0.0, philox.scale(0.1)}
    assert torch.equal(m.reshape(-1) > 0, a)
    assert philox.threshold(0.1) == math.ceil(0.1 * 2 ** 24)
    assert philox.threshold(0.0) == 0
    gen = torch.Generator().manual_seed(0)
    seeds = {philox.draw_seed(gen) for _ in range(8)}
    assert len(seeds) == 8 and all(0 <= s < 2 ** 62 for s in seeds)
