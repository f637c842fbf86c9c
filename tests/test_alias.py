import numpy as np
import pytest

from graphembedding.ops.alias import (
    alias_sample_host,
    build_alias_table,
    build_row_alias,
)


def empirical_dist(probs, n_draws=200_000, seed=0):
    accept, alias = build_alias_table(probs)
    rng = np.random.default_rng(seed)
    draws = alias_sample_host(accept, alias, rng, size=n_draws)
    counts = np.bincount(draws, minlength=len(probs))
    return counts / n_draws


@pytest.mark.parametrize(
    "probs",
    [
        [1, 1, 1, 1],
        [0.7, 0.2, 0.1],
        [5, 1, 1, 1, 1, 1],
        [0.01, 0.99],
        np.random.default_rng(3).random(37),
    ],
)
def test_alias_table_distribution(probs):
    probs = np.asarray(probs, dtype=np.float64)
    target = probs / probs.sum()
    emp = empirical_dist(probs)
    # chi-square-style check: all cells within 4 sigma
    sigma = np.sqrt(target * (1 - target) / 200_000)
    assert np.all(np.abs(emp - target) < 4 * sigma + 1e-4)


def test_alias_table_mass_conservation():
    probs = np.array([3.0, 1.0, 1.0, 1.0])
    accept, alias = build_alias_table(probs)
    n = len(probs)
    # implied probability of each outcome
    implied = accept / n
    for i in range(n):
        implied[alias[i]] += (1 - accept[i]) / n
    np.testing.assert_allclose(implied, probs / probs.sum(), atol=1e-7)


def test_row_alias_matches_per_row():
    row_ptr = np.array([0, 3, 3, 7])
    w = np.array([1.0, 2.0, 3.0, 1.0, 1.0, 1.0, 5.0], dtype=np.float32)
    accept, alias = build_row_alias(row_ptr, w)
    # row 0
    a0, al0 = build_alias_table(w[0:3])
    np.testing.assert_allclose(accept[0:3], a0, atol=1e-6)
    np.testing.assert_array_equal(alias[0:3], al0)
    # empty row untouched defaults
    # row 2
    a2, al2 = build_alias_table(w[3:7])
    np.testing.assert_allclose(accept[3:7], a2, atol=1e-6)
    np.testing.assert_array_equal(alias[3:7], al2)


def test_native_alias_matches_numpy():
    from graphembedding import native

    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(1)
    row_ptr = np.array([0, 5, 5, 12, 40])
    w = rng.random(40).astype(np.float32)
    acc_n, ali_n = native.native_build_row_alias(row_ptr, w)
    # distributions must match (alias layout may differ; compare implied)
    for s, e in [(0, 5), (5, 12), (12, 40)]:
        n = e - s
        imp_n = acc_n[s:e] / n
        for i in range(n):
            imp_n[ali_n[s:e][i]] += (1 - acc_n[s:e][i]) / n
        target = w[s:e] / w[s:e].sum()
        np.testing.assert_allclose(imp_n, target, atol=1e-5)
