"""SMC weight normalization, systematic resampling and ESS against the
serial reference sampler (scripts/reference_pg.py) and plain NumPy."""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pymc_bart_tpu.ops.resample import (effective_sample_size,
                                        normalize_log_weights,
                                        systematic_indices)

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "reference_pg.py")


def _reference_pg():
    spec = importlib.util.spec_from_file_location("reference_pg", _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LOG_WEIGHTS = {
    "spread": np.array([-3.0, 0.5, 1.2, -0.7, 2.0, 0.0, -1.5], np.float32),
    "peaked": np.array([-400.0, -2.0, -390.0, -1.0, -395.0], np.float32),
    "flat": np.zeros(9, np.float32),
}


@pytest.mark.parametrize("name", sorted(LOG_WEIGHTS))
def test_normalize_log_weights_matches_numpy(name):
    lw = LOG_WEIGHTS[name]
    probs, log_mean = normalize_log_weights(jnp.asarray(lw))
    lw64 = lw.astype(np.float64)
    want = np.exp(lw64 - lw64.max())
    want /= want.sum()
    np.testing.assert_allclose(np.asarray(probs), want, rtol=1e-5, atol=1e-30)
    want_log_mean = np.log(np.mean(np.exp(lw64 - lw64.max()))) + lw64.max()
    np.testing.assert_allclose(float(log_mean), want_log_mean, rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("seed, num", [(0, 9), (1, 19), (2, 39)])
def test_systematic_indices_match_reference_sampler(seed, num):
    """Same uniform, same CDF: identical ancestors to the serial
    reference sampler's ``systematic``."""
    ref = _reference_pg()
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(num, 0.5)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    got = np.asarray(systematic_indices(key, jnp.asarray(probs), num))
    u = float(jax.random.uniform(key, ()))
    want = ref.systematic(probs.astype(np.float64), num, u)
    np.testing.assert_array_equal(got, want)
    # every particle with weight above 1/num survives at least once
    assert set(np.flatnonzero(probs > 1.0 / num)) <= set(got.tolist())


def test_effective_sample_size_matches_numpy():
    for lw in LOG_WEIGHTS.values():
        probs, _ = normalize_log_weights(jnp.asarray(lw))
        p = np.asarray(probs, np.float64)
        np.testing.assert_allclose(float(effective_sample_size(probs)),
                                   1.0 / np.sum(p * p), rtol=1e-5)
    # bounds: one particle for a point mass, N for uniform weights
    assert float(effective_sample_size(jnp.eye(5)[2])) == pytest.approx(1.0)
    assert float(effective_sample_size(jnp.full(8, 1 / 8))) == \
        pytest.approx(8.0, rel=1e-6)
