"""Binary and 3-class classification with BART (BASELINE config 3 and the
reference's categorical-hawks pattern, docs/examples.rst).

Run: python examples/classification.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import pymc_bart_tpu as pmb


def binary():
    rng = np.random.default_rng(0)
    n = 300
    X = rng.normal(size=(n, 4))
    p_true = 1 / (1 + np.exp(-(2 * X[:, 0] - 1.5 * X[:, 1])))
    Y = rng.binomial(1, p_true).astype(float)

    with pmb.Model():
        lo = pmb.BART("lo", X, Y, m=25)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=1)

    lo_hat = idata.posterior["lo"].values.mean(axis=(0, 1))
    acc = ((lo_hat > 0) == (Y > 0.5)).mean()
    print(f"binary: train accuracy {acc:.3f} "
          f"(Bayes ~{np.maximum(p_true, 1 - p_true).mean():.3f})")


def categorical():
    rng = np.random.default_rng(1)
    n, n_class = 120, 3
    X = rng.normal(size=(n, 4))
    logits = np.stack([2 * X[:, 0], 2 * X[:, 1], -X[:, 0] - X[:, 1]], axis=1)
    Y = np.array([rng.choice(n_class, p=np.exp(l) / np.exp(l).sum())
                  for l in logits]).astype(float)

    with pmb.Model():
        # separate_trees gives each class its own forest and the
        # closed-form cat_logit particle weights
        lo = pmb.BART("logodds", X, Y, m=10, shape=(n_class, n),
                      separate_trees=True)
        pmb.Categorical("y", p=pmb.math.softmax(lo.T, axis=-1), observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=1, random_seed=2,
                           batch=(0.5, 0.5))

    post = idata.posterior["logodds"].values.mean(axis=(0, 1))  # (3, n)
    acc = (post.argmax(axis=0) == Y).mean()
    print(f"categorical: train accuracy {acc:.3f}")


if __name__ == "__main__":
    binary()
    categorical()
