"""The traffic generators repeat exactly for a seed and differ across
seeds: set-up data, each request's draws and the checked sample."""

import numpy as np
import pytest

from wabench.core import traffic
from wabench.tests import tiny


def _pools(name, seed):
    c = tiny.cell(name)
    got = c.config_module.inputs(c.cfg, np.random.default_rng([seed, 1]))
    return [x for x, _ in got["clips"]] + list(got.get("irs", []))


@pytest.mark.parametrize("name", tiny.CELLS)
def test_setup_data_repeats_for_a_seed(name):
    a, b, c = _pools(name, 2**31 + 5), _pools(name, 2**31 + 5), \
        _pools(name, 2**31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_every_seed_makes_the_same_sizes():
    sizes = [sorted(x.shape for x in _pools("mastering.augment", s))
             for s in (1, 2, 3)]
    assert sizes[0] == sizes[1] == sizes[2]


def _draws(name, seed, n=3):
    c = tiny.cell(name)
    drv = traffic.driver(c, None, "cpu", seed, None, traffic.Run(c))
    drv.inputs = c.config_module.inputs(c.cfg, drv.data_rng)
    return [drv.draw(4) for _ in range(n)]


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", tiny.CELLS)
def test_requests_repeat_for_a_seed(name):
    seed = 3 * 2**31 + 7
    assert _same(_draws(name, seed), _draws(name, seed))
    assert not _same(_draws(name, seed), _draws(name, seed + 1))


def test_sample_is_seeded_and_keeps_the_last():
    def kept(seed):
        s = traffic.Sample(3, np.random.default_rng(seed))
        for i in range(50):
            s.offer(i)
        return s.items()
    assert kept(1) == kept(1) and kept(1) != kept(2)
    assert kept(1)[-1] == 49 and len(kept(1)) == 4
