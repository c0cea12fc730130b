"""Exactness guards for the selection products.

Every matrix product on the sampler and prediction paths is a one-hot
selection or sum that must reproduce its operands exactly.  At default
precision a GPU may run a float32 product in TF32 (about 10 mantissa
bits), which would route a row to the wrong side of a split value drawn
from X.  These tests pin ``Precision.HIGHEST`` on every ``dot_general``
in the lowered programs and check routing at split values exactly.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chip_smoke import predict_reference, random_forest
from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.ops.predict import forest_predict, forest_predict_excluded
from pymc_bart_tpu.sampler import pgbart


def _dot_lines(lowered) -> list[str]:
    text = lowered.as_text()
    return [ln for ln in text.splitlines() if "dot_general" in ln]


def _assert_all_highest(lines, expect_dots=True):
    assert lines or not expect_dots, "expected a dot_general in the program"
    for ln in lines:
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", ln), ln


def _loglik(f, params):
    y, w = params
    return jnp.sum(-0.5 * w * (y - f) ** 2)


@pytest.mark.parametrize("response, k, n, ancestor", [
    ("constant", 1, 64, True),
    ("constant", 2, 64, False),
    ("linear", 1, 64, False),
    ("linear", 2, 64, False),
    # node-space sufficient statistics (one-hot statistics path)
    ("constant", 1, pgbart._SEG_MATMUL_N, True),
], ids=["const-k1", "const-k2", "linear-k1", "linear-k2", "suffstats"])
def test_pgbart_step_dots_are_highest(response, k, n, ancestor):
    p = 3
    X = jnp.zeros((n, p), jnp.float32)
    Y = jnp.zeros((n, k), jnp.float32)
    cfg = BartConfig(m=4, max_depth=3, n_outputs=k, response=response)
    pg = PgbartConfig(num_particles=4, ancestor_sampling=ancestor)
    state = pgbart.init_state(X, Y, cfg)
    gauss_w = jnp.ones((n, k), jnp.float32)
    lowered = jax.jit(
        lambda key, s: pgbart.pgbart_step(
            key, s, X, Y, jnp.zeros(p, jnp.int32), cfg, pg, _loglik,
            (Y, gauss_w), False, gauss_w=gauss_w,
            w_scalar=(k == 1 and response == "constant"))
    ).lower(jax.random.PRNGKey(0), state)
    # the linear response routes and predicts by gathers: no products
    _assert_all_highest(_dot_lines(lowered), expect_dots=response != "linear")


def test_forest_predict_dots_are_highest():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(32, 4)).astype(np.float32)
    f = random_forest(rng, 3, 4, X)
    rules = jnp.zeros(4, jnp.int32)
    plain = jax.jit(lambda f_, x: forest_predict(f_, x, rules, 4)).lower(f, X)
    excl = jax.jit(lambda f_, x: forest_predict_excluded(
        f_, x, rules, jnp.zeros(4, bool), 4)).lower(f, X)
    # the plain traversal is gather-only; the excluded path's
    # mass-propagation einsum must be exact
    _assert_all_highest(_dot_lines(plain), expect_dots=False)
    _assert_all_highest(_dot_lines(excl))


def test_predict_routes_exactly_at_split_values():
    """Rows placed on, and a few ulps either side of, every split value
    route as a float64 traversal says (x <= v goes left)."""
    rng = np.random.default_rng(3)
    p, depth = 4, 5
    base = rng.uniform(size=(64, p)).astype(np.float32)
    forest = random_forest(rng, 6, depth, base)
    sv, sl = np.asarray(forest.split_var), np.asarray(forest.split_val)
    rows = []
    for t, s in zip(*np.nonzero(sv >= 0)):
        for ulps in (-2, -1, 0, 1, 2):
            x = rng.uniform(size=p).astype(np.float32)
            v = sl[t, s]
            for _ in range(abs(ulps)):
                v = np.nextafter(v, np.float32(np.sign(ulps) * np.inf))
            x[sv[t, s]] = v
            rows.append(x)
    X = np.stack(rows).astype(np.float32)
    want = predict_reference(forest, X, depth)
    rules = jnp.zeros(p, jnp.int32)
    got = forest_predict(jax.tree.map(jnp.asarray, forest), jnp.asarray(X),
                         rules, depth)
    got_x = forest_predict_excluded(jax.tree.map(jnp.asarray, forest),
                                    jnp.asarray(X), rules,
                                    jnp.zeros(p, bool), depth)
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(np.asarray(got) - want))) <= 1e-5 * scale
    assert float(np.max(np.abs(np.asarray(got_x) - want))) <= 1e-5 * scale


@pytest.mark.parametrize("width", [2, 64])
def test_onehot_stats_match_segment_sum(width):
    """At n = _SEG_MATMUL_N the child statistics take the one-hot
    contraction; they equal segment_sum's (counts exactly)."""
    n = pgbart._SEG_MATMUL_N
    rng = np.random.default_rng(width)
    lo = 7
    leaf_idx = jnp.asarray(rng.integers(0, lo + width + 5, n), jnp.int32)
    resid = jnp.asarray(rng.normal(size=(n, 2)) + 0.5, jnp.float32)
    counts, sums = pgbart._child_stats(leaf_idx, resid, lo, width)
    ids = np.asarray(leaf_idx) - lo
    valid = (ids >= 0) & (ids < width)
    want_c = np.bincount(ids[valid], minlength=width)
    want_s = np.stack([np.bincount(ids[valid], weights=np.asarray(
        resid, np.float64)[valid, j], minlength=width) for j in range(2)], 1)
    np.testing.assert_array_equal(np.asarray(counts), want_c)
    np.testing.assert_allclose(np.asarray(sums), want_s, rtol=1e-5,
                               atol=1e-5 * np.abs(want_s).max())
    # the per-leaf residual sums share the formulation
    li = jnp.asarray(rng.integers(0, 31, n), jnp.int32)
    got = pgbart._leaf_rsum(resid, li, 31)
    want = np.stack([np.bincount(np.asarray(li), weights=np.asarray(
        resid, np.float64)[:, j], minlength=31) for j in range(2)], 1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_unexact_dot_would_be_caught():
    """The guard itself: a default-precision product lowers without the
    HIGHEST attribute."""
    a = jnp.ones((4, 3))
    lowered = jax.jit(lambda x: x @ x.T).lower(a)
    lines = _dot_lines(lowered)
    assert lines and not any("HIGHEST" in ln for ln in lines)
