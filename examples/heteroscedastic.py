"""Multi-output heteroscedastic BART: shape=(2, n) for mean and scale
(BASELINE config 4; reference bart_heteroscedasticity example pattern,
docs/examples.rst).

Run: python examples/heteroscedastic.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import pymc_bart_tpu as pmb


def main():
    rng = np.random.default_rng(0)
    n = 300
    X = rng.uniform(-1, 1, size=(n, 2))
    mu_true = 3 * np.sin(2 * X[:, 0])
    sd_true = 0.2 + 1.5 * (X[:, 1] > 0)
    Y = rng.normal(mu_true, sd_true)

    with pmb.Model():
        # separate_trees gives each output its own forest — and
        # closed-form particle weights (mean forest: Gaussian with per-row
        # precision from |w[1]|+c; scale forest: the het_abs code)
        w = pmb.BART("w", X, Y, m=30, shape=(2, n), separate_trees=True)
        pmb.Normal("y", w[0], pmb.math.abs(w[1]) + 0.05, observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=0)

    w_post = idata.posterior["w"].values.mean(axis=(0, 1))
    print("corr(mean output, true mean):",
          round(float(np.corrcoef(w_post[0], mu_true)[0, 1]), 3))
    print("mean |scale| where sd_true high:",
          round(float(np.abs(w_post[1])[X[:, 1] > 0].mean()), 3),
          "low:", round(float(np.abs(w_post[1])[X[:, 1] <= 0].mean()), 3))


if __name__ == "__main__":
    main()
