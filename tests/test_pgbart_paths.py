"""The plain-XLA sampler paths: closed-form particle likelihoods, chain
batching, and end-to-end ``sample()`` for the non-Gaussian and wide-p
models."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pymc_bart_tpu as pmb
from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.sampler import pgbart
from pymc_bart_tpu.sampler.compound import (CompiledModel, _fused_likelihood,
                                            _make_loglik, _make_loglik_output)

# ---------------------------------------------------------------------------
# closed-form likelihoods against the generic model log-likelihood
# ---------------------------------------------------------------------------


def _model(kind, n=40, seed=0):
    """A model whose BART entry has closed-form code ``kind``; returns
    (model, bart rv, output index, observed y, class labels)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 3)).astype(np.float32)
    labels = None
    with pmb.Model() as model:
        if kind == "gauss":
            y = rng.normal(size=n).astype(np.float32)
            rv = pmb.BART("mu", X, y, m=3)
            pmb.Normal("y", rv, pmb.HalfNormal("sigma", 1.0), observed=y)
            out = None
        elif kind == "bernoulli":
            y = rng.integers(0, 2, n).astype(np.float32)
            rv = pmb.BART("lo", X, y, m=3)
            pmb.Bernoulli("y", p=pmb.math.sigmoid(rv), observed=y)
            out = None
        elif kind in ("het_abs", "het_exp"):
            y = rng.normal(size=n).astype(np.float32)
            rv = pmb.BART("w", X, y, m=3, shape=(2, n), separate_trees=True)
            scale = (pmb.math.abs(rv[1]) + 0.05 if kind == "het_abs"
                     else pmb.math.exp(rv[1]))
            pmb.Normal("y", rv[0], scale, observed=y)
            out = 1
        else:  # cat_logit
            labels = rng.integers(0, 3, n)
            y = labels.astype(np.float32)
            rv = pmb.BART("w", X, y, m=3, shape=(3, n), separate_trees=True)
            pmb.Categorical("y", p=pmb.math.softmax(rv.T, axis=-1),
                            observed=y)
            out = 0
    return model, rv, out, y, labels


@pytest.mark.parametrize("kind", ["gauss", "bernoulli", "het_abs", "het_exp",
                                  "cat_logit"])
def test_closed_form_loglik_matches_generic(kind):
    """``_make_ll_of`` (the closed forms the SMC weights use) differs from
    the model's generic log-likelihood only by a constant: differences
    between two candidate trees agree."""
    model, rv, out, y, labels = _model(kind)
    fused = _fused_likelihood(model, rv, out=out)
    assert fused is not None and fused["kind"] == kind
    compiled = CompiledModel(model)
    n = y.shape[0]
    k_full = 1 if out is None else rv.config.n_outputs
    rng = np.random.default_rng(1)
    W = jnp.asarray(rng.normal(size=(n, k_full)), jnp.float32)
    theta = jnp.full((compiled.theta_size,), 0.3, jnp.float32)
    internal = {rv.name: W}
    col = 0 if out is None else out
    sum_noi = W[:, col:col + 1] * 0.5
    preds = [jnp.asarray(rng.normal(size=(n, 1)), jnp.float32)
             for _ in range(2)]

    gauss_w, y_target, const = None, jnp.asarray(y)[:, None], 0.0
    if kind == "gauss":
        env, _ = compiled.build_env(theta, internal)
        sigma = env["sigma"]
        gauss_w = jnp.full((n, 1), 1.0 / sigma ** 2)
        generic = _make_loglik(compiled, rv.name)
    elif kind == "bernoulli":
        generic = _make_loglik(compiled, rv.name)
    elif kind in ("het_abs", "het_exp"):
        gauss_w = ((jnp.asarray(y) - W[:, 0]) ** 2)[:, None]
        const = fused.get("const", 0.0)
        generic = _make_loglik_output(compiled, rv.name, out)
    else:
        others = jnp.concatenate([W[:, :out], W[:, out + 1:]], axis=1)
        gauss_w = jax.scipy.special.logsumexp(others, axis=1)[:, None]
        y_target = jnp.asarray(4.0 * (labels == out) - 2.0,
                               jnp.float32)[:, None]
        generic = _make_loglik_output(compiled, rv.name, out)

    ll_of = pgbart._make_ll_of(None, None, gauss_w, kind, const, y_target,
                               None)
    closed = [float(ll_of(sum_noi, p_)) for p_ in preds]
    full = [float(generic(sum_noi + p_, (theta, internal))) for p_ in preds]
    assert closed[0] - closed[1] == pytest.approx(full[0] - full[1],
                                                  rel=1e-4, abs=1e-3)


# ---------------------------------------------------------------------------
# chain batching
# ---------------------------------------------------------------------------


def _setup(seed=0, n=48, p=3, m=6, depth=3, particles=4):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.uniform(size=(n, p)).astype(np.float32))
    Y = jnp.asarray(np.sin(3 * np.asarray(X[:, 0])) + 0.1 * rng.normal(size=n),
                    jnp.float32)[:, None]
    cfg = BartConfig(m=m, max_depth=depth)
    pg = PgbartConfig(num_particles=particles, batch=(0.5, 0.5))
    rules = jnp.zeros(p, jnp.int32)
    return X, Y, cfg, pg, rules, pgbart.init_state(X, Y, cfg)


def _loglik(f, params):
    y, w = params
    return jnp.sum(-0.5 * w * (y - f) ** 2)


@pytest.mark.parametrize("tuning", [False, True])
def test_vmapped_chains_match_per_chain_calls(tuning):
    """vmap over (key, state) == independent per-chain pgbart_step calls
    (how sample() batches chains)."""
    C = 3
    X, Y, cfg, pg, rules, state = _setup()
    gauss_w = jnp.full((X.shape[0], 1), 4.0, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (C,) + a.shape), state)

    def step(k, s):
        return pgbart.pgbart_step(k, s, X, Y, rules, cfg, pg, _loglik,
                                  (Y, gauss_w), tuning, gauss_w=gauss_w)

    got_state, got_vi = jax.vmap(step)(keys, states)
    for c in range(C):
        want_state, want_vi = step(keys[c], state)
        pick = lambda a: np.asarray(a)[c]  # noqa: E731
        for name in ("split_var", "split_set", "count"):
            np.testing.assert_array_equal(
                np.asarray(getattr(want_state.forest, name)),
                pick(getattr(got_state.forest, name)), err_msg=name)
        np.testing.assert_allclose(np.asarray(want_state.forest.leaf),
                                   pick(got_state.forest.leaf),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(want_state.sum_trees),
                                   pick(got_state.sum_trees),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(want_state.leaf_sd),
                                   pick(got_state.leaf_sd), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(want_vi), pick(got_vi))


# ---------------------------------------------------------------------------
# end to end through sample()
# ---------------------------------------------------------------------------


def test_bernoulli_sample_learns():
    rng = np.random.default_rng(5)
    n = 80
    X = rng.uniform(size=(n, 3)).astype(np.float32)
    Y = (X[:, 0] > 0.5).astype(np.float32)
    with pmb.Model():
        lo = pmb.BART("lo", X, Y, m=8)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        idata = pmb.sample(tune=40, draws=20, chains=1, random_seed=0,
                           batch=(0.5, 0.5), convergence_checks=False)
    post = idata.posterior["lo"].values.mean(axis=(0, 1))
    assert np.isfinite(post).all()
    assert float(((post > 0) == (Y > 0.5)).mean()) > 0.8


def test_wide_p_sample_runs():
    """p=600 rides the inverse-CDF split-variable draw; inclusion counts
    cover every column."""
    rng = np.random.default_rng(6)
    n, p = 50, 600
    X = rng.normal(size=(n, p)).astype(np.float32)
    Y = (2 * X[:, 0] + 0.1 * rng.normal(size=n)).astype(np.float32)
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=5)
        pmb.Normal("y", mu, pmb.HalfNormal("sigma", 1.0), observed=Y)
        idata = pmb.sample(tune=10, draws=6, chains=1, random_seed=0,
                           convergence_checks=False)
    assert np.isfinite(idata.posterior["mu"].values).all()
    vi = idata["sample_stats"]["variable_inclusion"].values
    assert vi.shape[-1] == p and vi.sum() > 0


def test_het_exp_sample_runs():
    """Separate-trees mean + log-scale model (closed-form het_exp weights
    for the scale forest)."""
    rng = np.random.default_rng(7)
    n = 60
    X = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    Y = rng.normal(np.sin(2 * X[:, 0]), 0.2 + (X[:, 1] > 0)).astype(np.float32)
    with pmb.Model() as model:
        w = pmb.BART("w", X, Y, m=5, shape=(2, n), separate_trees=True)
        pmb.Normal("y", w[0], pmb.math.exp(w[1]), observed=Y)
        assert _fused_likelihood(model, w, out=1)["kind"] == "het_exp"
        idata = pmb.sample(tune=10, draws=6, chains=1, random_seed=0,
                           convergence_checks=False)
    post = idata.posterior["w"].values
    assert post.shape == (1, 6, 2, n)
    assert np.isfinite(post).all()


def test_categorical_separate_trees_e2e():
    """Separate-trees softmax classifier end-to-end: the fused cat_logit
    entries must be detected and the classes recovered."""
    rng = np.random.default_rng(7)
    n, n_class = 90, 3
    X = rng.normal(size=(n, 3)).astype(np.float32)
    logits = np.stack([2 * X[:, 0], 2 * X[:, 1], -X[:, 0] - X[:, 1]], axis=1)
    Y = np.array([rng.choice(n_class, p=np.exp(l) / np.exp(l).sum())
                  for l in logits]).astype(np.float32)

    with pmb.Model() as model:
        lo = pmb.BART("lo", X, Y, m=8, shape=(n_class, n),
                      separate_trees=True)
        pmb.Categorical("y", p=pmb.math.softmax(lo.T, axis=-1), observed=Y)
        for j in range(n_class):
            det = _fused_likelihood(model, lo, out=j)
            assert det is not None and det["kind"] == "cat_logit", det
        idata = pmb.sample(tune=120, draws=120, chains=1, random_seed=2,
                           batch=(0.5, 0.5))

    post = idata.posterior["lo"].values.mean(axis=(0, 1))  # (3, n)
    acc = float((post.argmax(axis=0) == Y).mean())
    assert acc > 0.6, acc
