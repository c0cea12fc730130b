"""Serial reference-semantics PG-BART: measure the mixing floor instead
of asserting it (round-4 VERDICT "Next round" #2).

BASELINE.md demands posterior moments "within Monte-Carlo error" of the
reference sampler, but the reference (pymc-devs/pymc-bart + the bartrs
Rust crate) cannot run in this image.  Round 4 therefore ASSERTED that
the engine's mixing floor (min bulk-ESS ~5 per 2400 draws on
friedman, rhat 1.6-2.0) is the frozen-particle PG floor the reference
shares.  This script REPLACES that assertion with a measurement: a
plain-NumPy particle-Gibbs BART with the reference's reconstructed
semantics (SURVEY 2.3; algorithm arXiv:1502.04622; behavioral history
/root/reference/CHANGELOG.md:400-402,380,296-299):

* one-leaf-per-SMC-iteration growth: every non-frozen particle keeps a
  FIFO of expandable leaves and pops ONE per iteration (the reference's
  sequential schedule — NOT this repo's depth-synchronous rounds),
* particle 0 frozen at the current tree, weight constant,
* systematic resampling of the non-frozen particles EVERY iteration
  with post-resampling reset to the mean weight (reference
  CHANGELOG.md:400-402),
* grow: P(grow | depth) = alpha (1+d)^-beta, split variable ~ adaptive
  alpha_vec, split value uniform over the rows in the leaf, children
  leaf values ~ Normal(child residual mean / m, leaf_sd),
  empty-child proposals revert,
* no Metropolis leaf refinement (an addition of this engine),
* final tree ~ categorical over normalized particle weights,
* tuning adaptation matched to the engine (alpha_vec split counts;
  leaf_sd from the Welford running std of per-row predictions) so the
  comparison isolates the PG kernel dynamics,
* sigma updated by a small MH sweep on log sigma (stand-in for the
  compound NUTS step; mu diagnostics are the comparison target).

Usage:
    python scripts/reference_pg.py --chains 4 --tune 200 --draws 800
    python scripts/reference_pg.py --side engine   # same model, this engine

Prints one JSON line with ess/rhat/moments for mu[0], mu[500], mu[999]
and sigma.  Record both sides in PERF.md: matching floors
demonstrate the parity claim; diverging floors expose an engine bug.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root

D_MAX = 8  # twin depth cap (P(grow) at depth 8 with default prior ~1.2%)
S_MAX = 2 ** (D_MAX + 1) - 1


def friedman(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])
    Y = (f + rng.normal(0, 1.0, n)).astype(np.float32)
    return X, Y, f


class Particle:
    """One particle's tree as fixed-slot arrays + row partition."""

    __slots__ = ("sv", "sl", "lf", "ct", "li", "pred", "open_q", "log_w",
                 "ll")

    def __init__(self, n, root_value):
        self.sv = np.full(S_MAX, -1, np.int32)
        self.sl = np.zeros(S_MAX, np.float32)
        self.lf = np.zeros(S_MAX, np.float32)
        self.ct = np.zeros(S_MAX, np.float32)
        self.lf[0] = root_value
        self.ct[0] = n
        self.li = np.zeros(n, np.int32)
        self.pred = np.full(n, root_value, np.float32)
        self.open_q = [0]
        self.log_w = 0.0
        self.ll = 0.0

    def copy(self):
        q = Particle.__new__(Particle)
        q.sv = self.sv.copy(); q.sl = self.sl.copy()
        q.lf = self.lf.copy(); q.ct = self.ct.copy()
        q.li = self.li.copy(); q.pred = self.pred.copy()
        q.open_q = list(self.open_q)
        q.log_w = self.log_w; q.ll = self.ll
        return q


def systematic(weights, k, u):
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    pos = (u + np.arange(k)) / k
    return np.searchsorted(cdf, pos)


def update_tree(rng, X, resid, w_prec, tree_arrays, m, alpha, beta,
                alpha_vec, leaf_sd, num_particles):
    """Conditional SMC for ONE tree, reference schedule.  Returns the
    selected (sv, sl, lf, ct, pred)."""
    n, p = X.shape
    sv0, sl0, lf0, ct0 = tree_arrays

    def ll_of(pred):
        d = resid - pred
        return float(-0.5 * w_prec * np.dot(d, d))

    # frozen particle: the stored tree, fully predicted
    frozen = Particle(n, 0.0)
    frozen.sv = sv0.copy(); frozen.sl = sl0.copy()
    frozen.lf = lf0.copy(); frozen.ct = ct0.copy()
    li = np.zeros(n, np.int32)
    for _ in range(D_MAX):
        node_sv = frozen.sv[li]
        grown = node_sv >= 0
        if not grown.any():
            break
        xv = X[np.arange(n), np.clip(node_sv, 0, p - 1)]
        left = xv <= frozen.sl[li]
        li = np.where(grown, 2 * li + 1 + (~left).astype(np.int32), li)
    frozen.li = li
    frozen.pred = frozen.lf[li]
    frozen.open_q = []
    frozen.ll = ll_of(frozen.pred)
    frozen.log_w = frozen.ll

    root_mu = float(resid.mean()) / m
    particles = [frozen]
    for _ in range(num_particles - 1):
        q = Particle(n, root_mu)
        q.ll = ll_of(q.pred)
        q.log_w = q.ll
        particles.append(q)

    cdf_var = np.cumsum(np.maximum(alpha_vec, 1e-12))

    while any(p_.open_q for p_ in particles[1:]):
        for q in particles[1:]:
            if not q.open_q:
                continue
            node = q.open_q.pop(0)      # FIFO: one leaf per iteration
            d = int(np.floor(np.log2(node + 1)))
            if rng.uniform() >= alpha * (1.0 + d) ** (-beta):
                continue                # stays a leaf forever
            mask = q.li == node
            cnt = int(mask.sum())
            if cnt < 2:
                continue
            var = int(np.searchsorted(cdf_var, rng.uniform() * cdf_var[-1]))
            var = min(var, p - 1)
            rows = np.nonzero(mask)[0]
            val = float(X[rows[rng.integers(cnt)], var])
            left = mask & (X[:, var] <= val)
            cl = int(left.sum())
            cr = cnt - cl
            if cl == 0 or cr == 0:
                continue                # empty child: revert
            l_i, r_i = 2 * node + 1, 2 * node + 2
            right = mask & ~left
            mu_l = resid[left].mean() / m + rng.normal() * leaf_sd
            mu_r = resid[right].mean() / m + rng.normal() * leaf_sd
            q.sv[node] = var
            q.sl[node] = val
            q.lf[l_i], q.lf[r_i] = mu_l, mu_r
            q.ct[l_i], q.ct[r_i] = cl, cr
            q.li[left], q.li[right] = l_i, r_i
            q.pred[left], q.pred[right] = mu_l, mu_r
            if d + 1 < D_MAX:
                q.open_q += [l_i, r_i]
            ll_new = ll_of(q.pred)
            q.log_w += ll_new - q.ll
            q.ll = ll_new
        # systematic resampling of the non-frozen particles, every
        # iteration, reset to the mean weight (CHANGELOG.md:400-402)
        lw = np.array([q.log_w for q in particles[1:]])
        mx = lw.max()
        wts = np.exp(lw - mx)
        idx = systematic(wts, len(lw), rng.uniform())
        log_mean = mx + np.log(wts.mean())
        new = [particles[0]]
        for i in idx:
            q = particles[1 + i].copy()
            q.log_w = log_mean
            new.append(q)
        particles = new

    lw = np.array([q.log_w for q in particles])
    wts = np.exp(lw - lw.max())
    widx = int(np.searchsorted(np.cumsum(wts / wts.sum()), rng.uniform()))
    q = particles[min(widx, len(particles) - 1)]
    return q.sv, q.sl, q.lf, q.ct, q.pred


def run_chain(seed, X, Y, m, alpha, beta, num_particles, batch, tune,
              draws, progress=False):
    rng = np.random.default_rng(seed)
    n, p = X.shape
    y_mean = float(Y.mean())
    trees = [(np.full(S_MAX, -1, np.int32), np.zeros(S_MAX, np.float32),
              np.zeros(S_MAX, np.float32).copy(), np.zeros(S_MAX, np.float32))
             for _ in range(m)]
    for sv, sl, lf, ct in trees:
        lf[0] = y_mean / m
        ct[0] = n
    tree_pred = np.full((m, n), y_mean / m, np.float32)
    sum_trees = tree_pred.sum(axis=0)
    alpha_vec = np.ones(p, np.float64)
    leaf_sd = float(Y.std()) / np.sqrt(m)
    sigma = 1.0
    wf_count, wf_mean, wf_m2 = 0.0, np.zeros(n), np.zeros(n)
    batch_offset = 0
    mus, sigmas = [], []

    for it in range(tune + draws):
        tuning = it < tune
        B = max(1, int(round(m * batch)))
        w_prec = 1.0 / sigma**2
        for b in range(B):
            j = (batch_offset + b) % m
            sum_noi = sum_trees - tree_pred[j]
            resid = Y - sum_noi
            sv, sl, lf, ct, pred = update_tree(
                rng, X, resid, w_prec, trees[j], m, alpha, beta,
                alpha_vec, leaf_sd, num_particles)
            trees[j] = (sv, sl, lf, ct)
            tree_pred[j] = pred
            sum_trees = sum_noi + pred
            if tuning:
                for s in np.nonzero(sv >= 0)[0]:
                    alpha_vec[sv[s]] += 1
                wf_count += 1.0
                delta = pred - wf_mean
                wf_mean += delta / wf_count
                wf_m2 += delta * (pred - wf_mean)
                if it * B + b > m:
                    leaf_sd = max(
                        float(np.sqrt(np.maximum(
                            wf_m2 / max(wf_count, 1.0), 1e-12)).mean()),
                        1e-6)
        batch_offset = (batch_offset + B) % m
        # sigma | rest: MH sweep on log sigma, HalfNormal(1) prior
        r = Y - sum_trees
        ss = float(np.dot(r, r))
        for _ in range(3):
            prop = sigma * np.exp(0.2 * rng.normal())
            def lp(s):
                return (-n * np.log(s) - 0.5 * ss / s**2 - 0.5 * s**2
                        + np.log(s))  # + log|J| of the log transform
            if np.log(rng.uniform()) < lp(prop) - lp(sigma):
                sigma = prop
        if not tuning:
            mus.append(sum_trees.copy())
            sigmas.append(sigma)
        if progress and (it + 1) % 100 == 0:
            print(f"# seed {seed}: {it + 1}/{tune + draws}",
                  file=sys.stderr, flush=True)
    return np.array(mus), np.array(sigmas)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--tune", type=int, default=200)
    ap.add_argument("--draws", type=int, default=800)
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--particles", type=int, default=20)
    ap.add_argument("--batch", type=float, default=0.1)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=int, default=10)
    ap.add_argument("--side", choices=["twin", "engine"], default="twin")
    ap.add_argument("--refinements", type=int, default=0,
                    help="engine-side num_refinements (twin has none)")
    ap.add_argument("--harmonize", action="store_true")
    ap.add_argument("--ancestor", action="store_true")
    args = ap.parse_args()

    X, Y, f_true = friedman(args.n, args.p)
    t0 = time.time()

    if args.side == "engine":
        import pymc_bart_tpu as pmb
        from pymc_bart_tpu.utils.compile_cache import setup_compile_cache

        setup_compile_cache()

        with pmb.Model():
            mu = pmb.BART("mu", X, Y, m=args.m)
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Y)
            idata = pmb.sample(tune=args.tune, draws=args.draws,
                               chains=args.chains, random_seed=0,
                               num_particles=args.particles,
                               batch=(args.batch, args.batch),
                               num_refinements=args.refinements,
                               harmonize_adaptation=args.harmonize,
                               ancestor_sampling=args.ancestor,
                               store_trees=False)
        mu_s = idata.posterior["mu"].values        # (chains, draws, n)
        sg_s = idata.posterior["sigma"].values
    else:
        mu_list, sg_list = [], []
        for c in range(args.chains):
            mus, sgs = run_chain(
                1000 + c, X, Y, args.m, 0.95, 2.0, args.particles,
                args.batch, args.tune, args.draws, progress=True)
            mu_list.append(mus)
            sg_list.append(sgs)
        mu_s = np.stack(mu_list)
        sg_s = np.stack(sg_list)

    from pymc_bart_tpu.utils.diagnostics import ess_bulk, rhat

    out = {"side": args.side, "chains": args.chains, "tune": args.tune,
           "draws": args.draws, "particles": args.particles,
           "batch": args.batch, "seconds": round(time.time() - t0, 1),
           "ess": {}, "rhat": {}, "mean": {}, "sd": {}}
    mu_hat = mu_s.mean(axis=(0, 1))
    out["rmse_vs_true_f"] = round(
        float(np.sqrt(np.mean((mu_hat - f_true) ** 2))), 3)
    for r in (0, args.n // 2, args.n - 1):
        v = mu_s[:, :, r]
        out["ess"][f"mu[{r}]"] = round(float(ess_bulk(v)), 1)
        out["rhat"][f"mu[{r}]"] = round(float(rhat(v)), 3)
        out["mean"][f"mu[{r}]"] = round(float(v.mean()), 3)
        out["sd"][f"mu[{r}]"] = round(float(v.std()), 3)
    out["ess"]["sigma"] = round(float(ess_bulk(sg_s)), 1)
    out["rhat"]["sigma"] = round(float(rhat(sg_s)), 3)
    out["mean"]["sigma"] = round(float(sg_s.mean()), 3)
    min_keyed = min(out["ess"], key=out["ess"].get)
    out["min_ess"] = out["ess"][min_keyed]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
