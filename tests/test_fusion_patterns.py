"""Fusion pattern matcher (_fused_likelihood): one test per accepted
model form, and a near-miss form that must be rejected."""

import numpy as np
import pytest

import pymc_bart_tpu as pmb
from pymc_bart_tpu.sampler.compound import _fused_likelihood


def _data(n=40, p=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    return X, rng


def test_gauss_plain():
    X, rng = _data()
    Y = rng.normal(size=len(X)).astype(np.float32)
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=3)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
    assert _fused_likelihood(model, model.bart_rvs[0])["kind"] == "gauss"


def test_gauss_mu_through_deterministic():
    X, rng = _data()
    Y = rng.normal(size=len(X)).astype(np.float32)
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=3)
        f = pmb.Deterministic("f", mu)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", f, sigma, observed=Y)
    assert _fused_likelihood(model, model.bart_rvs[0])["kind"] == "gauss"


def test_bernoulli_sigmoid():
    X, rng = _data()
    Y = rng.integers(0, 2, len(X)).astype(np.float32)
    with pmb.Model() as model:
        lo = pmb.BART("lo", X, Y, m=3)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
    assert _fused_likelihood(model, model.bart_rvs[0])["kind"] == "bernoulli"


def test_bernoulli_sigmoid_through_deterministic():
    X, rng = _data()
    Y = rng.integers(0, 2, len(X)).astype(np.float32)
    with pmb.Model() as model:
        lo = pmb.BART("lo", X, Y, m=3)
        prob = pmb.Deterministic("prob", pmb.math.sigmoid(lo))
        pmb.Bernoulli("y", p=prob, observed=Y)
    assert _fused_likelihood(model, model.bart_rvs[0])["kind"] == "bernoulli"


def _cat_setup(p_builder):
    X, rng = _data(n=60)
    Y = rng.integers(0, 3, len(X)).astype(np.float32)
    with pmb.Model() as model:
        w = pmb.BART("w", X, Y, m=3, shape=(3, len(X)),
                     separate_trees=True)
        pmb.Categorical("y", p=p_builder(pmb, w), observed=Y)
    return model


@pytest.mark.parametrize("builder,label", [
    (lambda pmb, w: pmb.math.softmax(w.T, axis=-1), "transpose-axis-1"),
    (lambda pmb, w: pmb.math.softmax(w.T), "transpose-default-axis"),
    (lambda pmb, w: pmb.math.softmax(w, axis=0).T, "softmax0-transpose"),
    (lambda pmb, w: pmb.Deterministic(
        "pr", pmb.math.softmax(w.T, axis=-1)), "deterministic-wrapped"),
], ids=["T-axis-1", "T-default", "ax0-T", "det"])
def test_categorical_softmax_variants(builder, label):
    model = _cat_setup(builder)
    fused = _fused_likelihood(model, model.bart_rvs[0], out=1)
    assert fused is not None and fused["kind"] == "cat_logit", label


def test_nonfusable_sigma_referencing_bart_is_rejected():
    X, rng = _data()
    Y = rng.normal(size=len(X)).astype(np.float32)
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=3)
        pmb.Normal("y", mu, pmb.math.abs(mu) + 0.1, observed=Y)
    assert _fused_likelihood(model, model.bart_rvs[0]) is None
