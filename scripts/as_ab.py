"""A/B measurement: ancestor_sampling (retained-path grow/prune
rejuvenation) on the friedman bench config, on the GPU.

Measures steady-state draw rate, min bulk-ESS, R-hat and fit quality
with the feature off vs on (and optionally more sweeps), printing one
JSON line per arm.  This is the evidence for the round-5 VERDICT ask:
min-ESS >= 3x at <= 2x draw cost.

Usage: python scripts/as_ab.py [sweeps ...]   (default arms: off, 1, 2)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def friedman(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])
    Y = (f + rng.normal(0, 1.0, n)).astype(np.float32)
    return X, Y, f


def run_arm(sweeps, tune=200, draws=600, chains=4, seed=0, tag=None,
            **extra_kw):
    import pymc_bart_tpu as pmb
    from pymc_bart_tpu.utils.diagnostics import ess_bulk, rhat

    X, Y, f_true = friedman(1000, 10)
    timings = {}
    kw = dict(extra_kw)
    if sweeps > 0:
        kw.update(ancestor_sampling=True, rejuvenation_sweeps=sweeps)
    t0 = time.perf_counter()
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=50)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(tune=tune, draws=draws, chains=chains,
                           random_seed=seed, chunk_size=draws // 4,
                           num_particles=20, timings=timings,
                           posterior_dtype="float16", store_trees=False,
                           **kw)
    total = time.perf_counter() - t0
    secs = timings["draw_chunk_seconds"]
    sizes = timings["draw_chunk_sizes"]
    tot = timings.get("draw_seconds_total", sum(secs))
    per_draw = ((tot - secs[0]) / sum(sizes[1:]) if len(secs) > 1
                else tot / sizes[0])
    mu_s = idata.posterior["mu"].values
    ess = {f"mu[{r}]": float(ess_bulk(mu_s[:, :, r]))
           for r in (0, 500, 999)}
    ess["sigma"] = float(ess_bulk(idata.posterior["sigma"].values))
    rh = {f"mu[{r}]": float(rhat(mu_s[:, :, r])) for r in (0, 500, 999)}
    rh["sigma"] = float(rhat(idata.posterior["sigma"].values))
    mu_hat = mu_s.mean(axis=(0, 1))
    out = {
        "arm": tag or (f"sweeps={sweeps}" if sweeps else "off"),
        "chains": chains, "tune": tune, "draws": draws,
        "chain_draws_per_s": round(chains / per_draw, 1),
        "ms_per_draw": round(per_draw * 1e3, 3),
        "min_ess": round(min(ess.values()), 1),
        "ess": {k: round(v, 1) for k, v in ess.items()},
        "max_rhat": round(max(rh.values()), 3),
        "rhat": {k: round(v, 3) for k, v in rh.items()},
        "sec_per_100_ess": round(
            draws * per_draw * 100.0 / max(min(ess.values()), 1e-9), 2),
        "rmse_vs_true_f": round(
            float(np.sqrt(np.mean((mu_hat - f_true) ** 2))), 3),
        "sigma_mean": round(
            float(idata.posterior["sigma"].values.mean()), 3),
        "total_seconds": round(total, 1),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    from pymc_bart_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    arms = [int(a) for a in sys.argv[1:]] or [0, 1, 2]
    for a in arms:
        run_arm(a)
