"""Sweep PGBART mixing levers and report wall-clock-to-ESS.

BASELINE.md's protocol metric is wall-clock to fixed ESS, not raw
draws/s; on the Gaussian configs the end-to-end bottleneck can be
AUTOCORRELATION (round-3 bench: friedman min bulk-ESS 4.8 out of 2400
chain-draws).  The levers that
trade draw cost for mixing:

* batch fraction  — trees updated per MCMC step (cost ~linear, mixing
  superlinear: a batch=1.0 draw refreshes all m trees)
* num_refinements — Metropolis leaf-value sweeps per tree update
* num_particles   — SMC particles per tree update

Usage:
    python scripts/ess_sweep.py [config] [--draws N] [--tune N]
      config in {friedman, heteroscedastic}

Writes one JSON line per grid point to stderr and a summary table at the
end; adopt winners into bench.py / PgbartConfig defaults.
"""

import argparse
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


def run_point(config, batch, refinements, particles, tune, draws, chains):
    import pymc_bart_tpu as pmb
    from pymc_bart_tpu.utils.diagnostics import ess_bulk

    timings = {}
    t0 = time.perf_counter()
    with pmb.Model():
        if config == "friedman":
            X, Y, _f_true = friedman(1000, 10)
            mu = pmb.BART("mu", X, Y, m=50)
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Y)
            watch = ("mu", ("sigma",))
        else:  # heteroscedastic
            rng = np.random.default_rng(3)
            n = 1000
            X = rng.uniform(-2, 2, size=(n, 5)).astype(np.float32)
            f = np.sin(2 * X[:, 0])
            s = 0.3 + 0.9 * (X[:, 1] > 0)
            Y = (f + s * rng.normal(size=n)).astype(np.float32)
            w = pmb.BART("w", X, Y, m=30, shape=(2, n), separate_trees=True)
            pmb.Normal("y", w[0], np.abs(w[1]) + 0.1, observed=Y)
            watch = ("w", ())
        idata = pmb.sample(
            tune=tune, draws=draws, chains=chains, random_seed=0,
            chunk_size=max(draws // 4, 1), timings=timings,
            store_trees=False, progressbar=False,
            num_particles=particles, batch=(batch, batch),
            num_refinements=refinements)
    total = time.perf_counter() - t0
    secs, sizes = timings["draw_chunk_seconds"], timings["draw_chunk_sizes"]
    per_draw = (sum(secs[1:]) / sum(sizes[1:]) if len(secs) > 1
                else secs[0] / sizes[0])
    name, extras = watch
    vals = idata.posterior[name].values
    vals = vals.reshape(vals.shape[0], vals.shape[1], -1)
    rows = vals.shape[-1]
    esses = {f"{name}[{r}]": float(ess_bulk(vals[..., r]))
             for r in (0, rows // 2, rows - 1)}
    for v in extras:
        esses[v] = float(ess_bulk(idata.posterior[v].values))
    min_ess = min(esses.values())
    return {
        "batch": batch, "refinements": refinements, "particles": particles,
        "chain_draws_per_s": round(chains / per_draw, 1),
        "min_ess": round(min_ess, 1),
        "ess_per_sec": round(min_ess / (draws * per_draw), 2),
        "sec_per_100_ess": round(draws * per_draw * 100 / max(min_ess, 1e-9), 2),
        "total_s": round(total, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="friedman",
                    choices=["friedman", "heteroscedastic"])
    ap.add_argument("--tune", type=int, default=200)
    ap.add_argument("--draws", type=int, default=400)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--batch", type=float, nargs="+",
                    default=[0.1, 0.25, 0.5, 1.0])
    ap.add_argument("--refinements", type=int, nargs="+", default=[5])
    ap.add_argument("--particles", type=int, nargs="+", default=[20])
    args = ap.parse_args()
    from pymc_bart_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    rows = []
    for b in args.batch:
        for r in args.refinements:
            for pp in args.particles:
                row = run_point(args.config, b, r, pp, args.tune,
                                args.draws, args.chains)
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
    rows.sort(key=lambda x: x["sec_per_100_ess"])
    print(f"# {args.config}: grid sorted by sec_per_100_ess")
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
