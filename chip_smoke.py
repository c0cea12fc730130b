#!/usr/bin/env python3
"""Smoke test of the PGBART sampler on one NVIDIA GPU.

Runs in one process on one card, through the same entry points a user
calls:

  predict   ``forest_predict`` and ``forest_predict_excluded`` (empty
            mask) for random forests of m=50 trees of depth 6, at
            n=1000 and n=50000, constant and linear response, with NaN
            rows, against a float64 NumPy traversal.
  grow      ``_grow_round_const`` (row space at n=1000; node-space
            sufficient statistics at n=50000) and ``_grow_round``
            (linear response, n=1000) on the card against the same call
            on the in-process CPU device.
  friedman  ``sample()`` through ``pmb.Model``/``pmb.BART``: n=1000,
            p=10, m=50, 4 chains, 20 particles, compound NUTS step for
            sigma; rmse against the true f and sigma's posterior mean.
  large_n   ``sample()`` at n=50000, p=10, m=20, 10 particles, no leaf
            refinement, 4 chains (node-space sufficient statistics).

``--four-cards`` runs only the mesh phases, on four cards: the chains
mesh at the friedman width and the (chains x data) mesh at n=50000,
each against the same seed on one card.

Every phase prints one line with its compile seconds, steady seconds per
draw (or per call) and the card's peak bytes in use.  The last line of
standard output is ``{"ok": true, "device": {...}}``; a failed check
raises, so the script exits non-zero and prints no such line.  Without a
GPU it exits with code 2.

    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from bench import friedman
from pymc_bart_tpu.config import BartConfig
from pymc_bart_tpu.ops.predict import forest_predict, forest_predict_excluded
from pymc_bart_tpu.ops.trees import Forest
from pymc_bart_tpu.parallel.mesh import make_mesh
from pymc_bart_tpu.sampler.pgbart import (_child_stats, _grow_round,
                                          _grow_round_const)
from pymc_bart_tpu.utils.compile_cache import setup_compile_cache

# every check's tolerance, stated once
PRED_REL_TOL = 1e-5        # max |pred - ref| <= PRED_REL_TOL * max |ref|
GROW_REL_TOL = 1e-5        # sums / leaf values, relative to max |ref|
PRECISION_NOTE = "HIGHEST_on_every_sampler_and_predict_dot(no_TF32)"

# Quality bounds, fixed from a CPU run of the same phases and seeds.
# The card sums floats in another order, so its chains leave their CPU
# twins after a few steps: its run is another draw of the same short
# run's distribution, hence the margins.  The trivial predictor (the
# mean of y) has rmse 4.9 against the true f.
# friedman (tune 100, draws 200): CPU rmse 0.696, sigma mean 1.400
# (sigma is still high this early); margins 0.3 and 0.25.
FRIEDMAN_RMSE_MAX = 1.0
FRIEDMAN_SIGMA_TOL = 0.65   # |E[sigma] - 1.0| <= this
# n=50000 (tune 20, draws 40): CPU rmse 1.705, sigma mean 2.37;
# margin 0.8.
LARGE_N_RMSE_MAX = 2.5
# Mesh vs one card.  On the CPU the chains mesh is bit-identical to one
# device.  On the card it is not, and neither are two one-card runs of
# the same seed: segment_sum's atomic adds round in a different order on
# every run, and a chain that takes another accept/reject branch never
# returns.  So the runs must agree as draws of the same posterior:
MESH_RMSE_TOL = 0.5     # |rmse_mesh - rmse_one_card|
MESH_SIGMA_TOL = 0.5    # |E[sigma]_mesh - E[sigma]_one_card|
# and, for the chains mesh, per chain: on four H100s the per-chain
# posterior means differed from one card's by 0.52-0.82 rms over two
# runs (friedman, tune 100, draws 200); the (chains x data) mesh diverges further this
# early in its run (up to 2.0 rms on the CPU) and is held to quality.
MESH_CHAIN_RMS_TOL = 1.0

_COMPILE_S = [0.0]  # accumulated by the listener main() registers


def _on_duration(event: str, secs: float, **_kw):
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += secs


def compile_seconds() -> float:
    """Seconds JAX spent tracing, lowering and compiling so far (0 unless
    main() registered the listener)."""
    return _COMPILE_S[0]


def check(ok, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def card_lines() -> list[str]:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def report(phase: str, **fields):
    parts = [f"phase={phase}"] + [f"{k}={v}" for k, v in fields.items()]
    print(" ".join(parts), flush=True)


# ---------------------------------------------------------------------------
# Random inputs
# ---------------------------------------------------------------------------


def make_X(rng, n: int, p: int, nan_rows: bool) -> np.ndarray:
    """Uniform covariates; with ``nan_rows`` 2% of rows are all-NaN and
    another 3% miss one column."""
    X = rng.uniform(size=(n, p)).astype(np.float32)
    if nan_rows:
        rows = rng.permutation(n)
        n_all, n_one = max(1, n // 50), max(1, 3 * n // 100)
        X[rows[:n_all]] = np.nan
        one = rows[n_all:n_all + n_one]
        X[one, rng.integers(0, p, one.size)] = np.nan
    return X


def _split_value(rng, X, var: int) -> float:
    """A split value drawn exactly from the column, as the sampler does."""
    col = X[:, var]
    ok = np.flatnonzero(~np.isnan(col))
    return float(col[rng.choice(ok)])


def random_forest(rng, m: int, depth: int, X: np.ndarray, k: int = 1,
                  linear: bool = False) -> Forest:
    """m random trees of depth at most ``depth`` over X (host arrays)."""
    n, p = X.shape
    S = 2 ** (depth + 1) - 1
    sv = np.full((m, S), -1, np.int32)
    sl = np.zeros((m, S), np.float32)
    for t in range(m):
        for node in range(2 ** depth - 1):
            if node > 0 and sv[t, (node - 1) // 2] < 0:
                continue
            d = int(np.floor(np.log2(node + 1)))
            if rng.random() < 0.95 / (1.0 + d) ** 0.5:
                var = int(rng.integers(0, p))
                sv[t, node] = var
                sl[t, node] = _split_value(rng, X, var)
    leaf = rng.normal(0.0, 0.5, size=(m, S, k)).astype(np.float32)
    slope = (rng.normal(0.0, 0.3, size=(m, S, k)).astype(np.float32)
             if linear else np.zeros((m, S, k), np.float32))
    return Forest(split_var=sv, split_val=sl,
                  split_set=np.zeros((m, S), np.uint32), leaf=leaf,
                  count=np.ones((m, S), np.float32), slope=slope)


def predict_reference(forest: Forest, X: np.ndarray, depth: int):
    """Float64 NumPy traversal with the engine's semantics (NaN routes
    right; a leaf predicts leaf + slope * x[parent split var])."""
    sv = np.asarray(forest.split_var)
    sl = np.asarray(forest.split_val)
    lf = np.asarray(forest.leaf, np.float64)
    sp = np.asarray(forest.slope, np.float64)
    n, p = X.shape
    rows = np.arange(n)
    Xd = X.astype(np.float64)
    out = np.zeros((n, lf.shape[-1]), np.float64)
    for t in range(sv.shape[0]):
        idx = np.zeros(n, np.int64)
        for _ in range(depth):
            var = sv[t, idx]
            xv = Xd[rows, np.clip(var, 0, p - 1)]
            with np.errstate(invalid="ignore"):
                left = xv <= sl[t, idx].astype(np.float64)
            idx = np.where(var >= 0, 2 * idx + 1 + (~left), idx)
        parent = np.maximum((idx - 1) // 2, 0)
        pvar = sv[t, parent]
        xp = Xd[rows, np.clip(pvar, 0, p - 1)]
        xp = np.where((idx > 0) & (pvar >= 0), np.nan_to_num(xp), 0.0)
        out += lf[t, idx] + sp[t, idx] * xp[:, None]
    return out


def random_particles(rng, P: int, X: np.ndarray, k: int, d: int, S: int,
                     slopes: bool):
    """P particle trees grown at random down to level ``d`` (split values
    drawn from X, internal leaf values retained), and each row's node."""
    n, p = X.shape
    sv = np.full((P, S), -1, np.int32)
    sl = np.zeros((P, S), np.float32)
    st = rng.integers(0, 2 ** 32, size=(P, S), dtype=np.uint32)
    lf = rng.normal(size=(P, S, k)).astype(np.float32)
    ct = np.zeros((P, S), np.float32)
    sp = (0.1 * rng.normal(size=(P, S, k)).astype(np.float32) if slopes
          else np.zeros((P, S, k), np.float32))
    li = np.zeros((P, n), np.int32)
    for pi in range(P):
        ct[pi, 0] = n
        for lev in range(d):
            for node in range(2 ** lev - 1, 2 ** (lev + 1) - 1):
                rows = np.flatnonzero(li[pi] == node)
                if rows.size < 4 or rng.random() < 0.3:
                    continue
                var = int(rng.integers(0, p))
                val = _split_value(rng, X[rows], var)
                with np.errstate(invalid="ignore"):
                    goleft = X[rows, var] <= val
                if goleft.all() or (~goleft).all():
                    continue
                sv[pi, node], sl[pi, node] = var, val
                li[pi, rows[goleft]] = 2 * node + 1
                li[pi, rows[~goleft]] = 2 * node + 2
                ct[pi, 2 * node + 1] = goleft.sum()
                ct[pi, 2 * node + 2] = (~goleft).sum()
    return sv, sl, st, lf, ct, sp, li


def grow_inputs(seed: int, P: int, n: int, p: int, k: int, d: int,
                depth: int, nan_rows: bool, slopes: bool = False,
                x_offset: float = 0.0) -> dict:
    """Host inputs of one growth round at level ``d`` for P particles
    (covariates uniform on [x_offset, x_offset + 1))."""
    rng = np.random.default_rng(seed)
    S = 2 ** (depth + 1) - 1
    G = 2 ** d
    X = make_X(rng, n, p, nan_rows) + np.float32(x_offset)
    sv, sl, st, lf, ct, sp, li = random_particles(rng, P, X, k, d, S, slopes)
    return dict(
        X=X,
        resid=(rng.normal(size=(n, k)) + 0.3).astype(np.float32),
        sv=sv, sl=sl, st=st, lf=lf, ct=ct, sp=sp, li=li,
        frozen=np.arange(P) == 0,
        rules=np.zeros(p, np.int32),
        alpha_cdf=np.cumsum(np.ones(p, np.float32)),
        leaf_sd=np.full((k,), 0.3, np.float32),
        rands=dict(
            # below every level's grow probability: growth is then
            # decided by the nodes' state and the child counts
            u_grow=(0.05 * rng.random((P, G))).astype(np.float32),
            u_var=rng.random((P, G)).astype(np.float32),
            row_gum=rng.gumbel(size=(P, n)).astype(np.float32),
            eps=rng.normal(size=(P, 2 * G, k)).astype(np.float32),
            set_bits=rng.integers(0, 2 ** 32, size=(P, G), dtype=np.uint32),
            u_mix=rng.random((P, 2 * G)).astype(np.float32),
        ),
    )


# ---------------------------------------------------------------------------
# Growth rounds as one jitted call each
# ---------------------------------------------------------------------------


def grow_round_const_fn(cfg: BartConfig, d: int, suff: bool,
                        x_nan: bool = True):
    """Jitted ``_grow_round_const`` over particles: inputs dict -> outputs
    dict (node-space sufficient statistics when ``suff``)."""
    def run(inp):
        X = inp["X"]
        X_z = jnp.where(jnp.isnan(X), 0.0, X)
        x_nanm = jnp.isnan(X)
        lf, li = inp["lf"], inp["li"]
        pred = jnp.take_along_axis(lf, li[:, :, None], axis=1)

        def one(r_, fz, sv, sl, st, lf_, ct, li_, pr, *sf):
            return _grow_round_const(
                r_, fz, sv, sl, st, lf_, ct, li_, pr, d, X_z, x_nanm,
                inp["rules"], inp["alpha_cdf"], inp["leaf_sd"], inp["resid"],
                cfg, all_cont=False, x_nan=x_nan,
                suff=tuple(sf) if suff else None)

        args = [inp["rands"], inp["frozen"], inp["sv"], inp["sl"], inp["st"],
                lf, inp["ct"], li, pred]
        names = ["split_var", "split_val", "split_set", "leaf", "count",
                 "leaf_idx", "pred"]
        if suff:
            S = lf.shape[1]
            nN = jax.vmap(lambda l: jnp.bincount(l, length=S))(li)
            occ = nN > 0
            nR = jax.vmap(lambda l: jax.ops.segment_sum(
                inp["resid"][:, 0], l, num_segments=S))(li)
            nQ = jax.vmap(lambda l: jax.ops.segment_sum(
                inp["resid"][:, 0] ** 2, l, num_segments=S))(li)
            args += [nN.astype(jnp.float32), nR, nQ, occ]
            names += ["nN", "nR", "nQ", "occ"]
        return dict(zip(names, jax.vmap(one)(*args)))

    return jax.jit(run)


def grow_round_fn(cfg: BartConfig, d: int):
    """Jitted ``_grow_round`` over particles: inputs dict -> outputs."""
    def run(inp):
        def one(r_, fz, sv, sl, st, lf, ct, sp, li):
            return _grow_round(r_, fz, sv, sl, st, lf, ct, sp, li, d,
                               inp["X"], inp["rules"], inp["alpha_cdf"],
                               inp["leaf_sd"], inp["resid"], cfg)

        out = jax.vmap(one)(inp["rands"], inp["frozen"], inp["sv"],
                            inp["sl"], inp["st"], inp["lf"], inp["ct"],
                            inp["sp"], inp["li"])
        names = ["split_var", "split_val", "split_set", "leaf", "count",
                 "slope", "leaf_idx"]
        res = dict(zip(names, out))
        # the child sufficient statistics of the routed rows: count,
        # sum r, and the linear fit's sum x, x^2, x r over the parent's
        # split covariate
        G = 2 ** d
        hi = 2 * G - 1

        def child_sums(sv, li):
            pvar = jnp.clip(sv[jnp.maximum((li - 1) // 2, 0)], 0,
                            inp["X"].shape[1] - 1)
            xs = jnp.nan_to_num(jnp.take_along_axis(
                inp["X"], pvar[:, None], axis=1)[:, 0])
            r = inp["resid"]
            z = jnp.concatenate([r, xs[:, None], (xs * xs)[:, None],
                                 xs[:, None] * r], axis=1)
            return _child_stats(li, z, hi, 2 * G)

        res["child_count"], res["child_sums"] = jax.vmap(child_sums)(
            res["split_var"], res["leaf_idx"])
        return res

    return jax.jit(run)


EXACT_KEYS = ("split_var", "split_val", "split_set", "count", "leaf_idx",
              "nN", "occ", "child_count")


def compare_outputs(got: dict, want: dict, tol: float = GROW_REL_TOL,
                    unbounded: tuple = ()) -> tuple[float, float]:
    """Structure (routing, split variables and values, counts) must be
    identical; float sums and values within ``tol`` of max |want| (per
    column for 2-D statistics), except the ``unbounded`` outputs, whose
    error is only measured.  Returns the largest relative error of the
    bounded and of the unbounded float outputs."""
    for name in want:
        if name in EXACT_KEYS:
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]),
                                          err_msg=name)
    worst, worst_unbounded = 0.0, 0.0
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        if name in EXACT_KEYS:
            continue
        axes = tuple(range(w.ndim - 1)) if name == "child_sums" else None
        scale = np.maximum(np.max(np.abs(w), axis=axes), 1e-30)
        err = float(np.max(np.max(np.abs(g - w), axis=axes) / scale))
        if name in unbounded:
            worst_unbounded = max(worst_unbounded, err)
            continue
        check(err <= tol, f"{name}: rel err {err:.3g} > {tol}")
        worst = max(worst, err)
    return worst, worst_unbounded


def timed_call(fn, *args, reps: int = 5):
    """(compile seconds, median steady seconds, output) of a jitted fn."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, float(np.median(times)), out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def check_predict(device, n: int, m: int = 50, depth: int = 6, p: int = 10,
                  linear: bool = False, seed: int = 0) -> dict:
    """forest_predict and forest_predict_excluded on ``device`` against
    the float64 NumPy traversal."""
    rng = np.random.default_rng(seed)
    X = make_X(rng, n, p, nan_rows=True)
    forest = random_forest(rng, m, depth, X, linear=linear)
    ref = predict_reference(forest, X, depth)
    scale = float(np.max(np.abs(ref)))
    f_dev = jax.device_put(forest, device)
    X_dev = jax.device_put(X, device)
    rules = jax.device_put(np.zeros(p, np.int32), device)
    mask = jax.device_put(np.zeros(p, bool), device)
    fp = jax.jit(lambda f, x, r: forest_predict(f, x, r, depth))
    fx = jax.jit(lambda f, x, r, e: forest_predict_excluded(f, x, r, e, depth))
    c1, s1, got = timed_call(fp, f_dev, X_dev, rules)
    c2, s2, got_x = timed_call(fx, f_dev, X_dev, rules, mask)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - ref)))
    err_x = float(np.max(np.abs(np.asarray(got_x, np.float64) - ref)))
    bound = PRED_REL_TOL * scale
    check(err <= bound, f"forest_predict err {err:.3g} > {bound:.3g}")
    check(err_x <= bound,
          f"forest_predict_excluded err {err_x:.3g} > {bound:.3g}")
    return dict(compile_s=round(c1 + c2, 3), steady_s_per_call=round(s1, 6),
                steady_s_per_call_excluded=round(s2, 6),
                max_abs_err=err, max_abs_err_excluded=err_x,
                max_abs_pred=scale)


def check_grow(device, cpu, kind: str, n: int, P: int, p: int = 10,
               d: int = 3, depth: int = 6, seed: int = 1) -> dict:
    """One growth round on ``device`` against the same call on ``cpu``.
    kind: "const" (row space), "suff" (node-space statistics) or
    "linear" (``_grow_round``, linear response)."""
    linear = kind == "linear"
    cfg = BartConfig(m=50, max_depth=depth,
                     response="linear" if linear else "constant")
    # linear: centred covariates, since the least-squares intercept's
    # float32 error grows with mean(x)^2 / var(x) and would measure the
    # fit's conditioning rather than the card
    inp = grow_inputs(seed, P, n, p, 1, d, depth, nan_rows=True,
                      slopes=linear, x_offset=-0.5 if linear else 0.0)
    fn = (grow_round_fn(cfg, d) if linear
          else grow_round_const_fn(cfg, d, suff=kind == "suff"))
    c, s, got = timed_call(fn, jax.device_put(inp, device))
    want = fn(jax.device_put(inp, cpu))
    # linear response: leaf intercepts and slopes are float32 least-squares
    # fits of four child sums; their error is the sums' rounding times the
    # fit's condition number, and the card's atomic sums round in another
    # order on every run.  So the child sums are held to GROW_REL_TOL and
    # the fitted values' error is only reported.
    unbounded = ("leaf", "slope") if linear else ()
    worst, worst_fit = compare_outputs(got, want, GROW_REL_TOL, unbounded)
    grown = int(np.sum(np.asarray(got["split_var"]) != inp["sv"]))
    res = dict(compile_s=round(c, 3), steady_s_per_call=round(s, 6),
               max_rel_err=worst, nodes_grown=grown,
               tol=f"structure_identical,rel<={GROW_REL_TOL}")
    if linear:
        res["fit_rel_err_unbounded"] = worst_fit
    return res


def sample_phase(X, Y, f_true, m: int, chains: int, tune: int, draws: int,
                 seed: int, mesh=None, **sample_kw) -> dict:
    """``sample()`` on a Gaussian BART model; timings and quality."""
    import pymc_bart_tpu as pmb

    timings: dict = {}
    c0 = compile_seconds()
    t0 = time.perf_counter()
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=m)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(tune=tune, draws=draws, chains=chains,
                           random_seed=seed, chunk_size=max(draws // 4, 1),
                           timings=timings, mesh=mesh,
                           convergence_checks=False, **sample_kw)
    wall = time.perf_counter() - t0
    secs, sizes = timings["draw_chunk_seconds"], timings["draw_chunk_sizes"]
    per_draw = ((timings["draw_seconds_total"] - secs[0]) / sum(sizes[1:])
                if len(secs) > 1 else timings["draw_seconds_total"] / sizes[0])
    mu_post = np.asarray(idata.posterior["mu"].values, np.float64)
    sig = np.asarray(idata.posterior["sigma"].values, np.float64)
    check(mu_post.shape == (chains, draws, X.shape[0]), mu_post.shape)
    check(np.isfinite(mu_post).all() and np.isfinite(sig).all(),
          "non-finite draws")
    out = dict(
        compile_s=round(compile_seconds() - c0, 2),
        wall_s=round(wall, 2),
        steady_s_per_draw=round(per_draw, 6),
        rmse=float(np.sqrt(np.mean((mu_post.mean(axis=(0, 1)) - f_true) ** 2))),
        sigma_mean=float(sig.mean()),
        chain_means=mu_post.mean(axis=1),
    )
    if sample_kw.get("store_trees", True):
        # collected-stat invariant: per-draw inclusion counts equal an
        # exact recount over the stored forests
        vi = np.asarray(idata["sample_stats"]["variable_inclusion"].values)
        sv = np.asarray(mu.all_trees.split_var)
        recount = np.stack([(sv == j).sum(axis=(2, 3))
                            for j in range(X.shape[1])], axis=-1)
        np.testing.assert_array_equal(vi[:, :, 0, :], recount)
        out["vi_invariant"] = "exact"
    return out


def friedman_phase(chains: int = 4, n: int = 1000, p: int = 10, m: int = 50,
                   tune: int = 100, draws: int = 200, seed: int = 0,
                   mesh=None) -> dict:
    X, Y, f = friedman(n, p)
    return sample_phase(X, Y, f, m, chains, tune, draws, seed, mesh=mesh,
                        num_particles=20)


def large_n_phase(chains: int = 4, n: int = 50_000, p: int = 10,
                  m: int = 20, tune: int = 20, draws: int = 40,
                  seed: int = 0, mesh=None) -> dict:
    X, Y, f = friedman(n, p, seed=5)
    return sample_phase(X, Y, f, m, chains, tune, draws, seed, mesh=mesh,
                        num_particles=10, num_refinements=0,
                        store_trees=False, ancestor_sampling=True)


def _public(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "chain_means"}


def one_card(device) -> None:
    cpu = jax.devices("cpu")[0]
    for n in (1000, 50_000):
        for linear in (False, True):
            res = check_predict(device, n, linear=linear)
            report(f"predict_n{n}_{'linear' if linear else 'constant'}",
                   **res, tol=f"max_abs_err<={PRED_REL_TOL}*max_abs_pred",
                   precision=PRECISION_NOTE,
                   peak_bytes=peak_bytes(device))
    for kind, n, P in (("const", 1000, 20), ("suff", 50_000, 10),
                       ("linear", 1000, 20)):
        res = check_grow(device, cpu, kind, n, P)
        report(f"grow_{kind}_n{n}_P{P}", **res,
               precision=PRECISION_NOTE,
               peak_bytes=peak_bytes(device))
    res = friedman_phase()
    report("friedman_n1000_m50_c4", **_public(res),
           rmse_max=FRIEDMAN_RMSE_MAX, sigma_tol=FRIEDMAN_SIGMA_TOL,
           peak_bytes=peak_bytes(device))
    check(res["rmse"] <= FRIEDMAN_RMSE_MAX, res["rmse"])
    check(abs(res["sigma_mean"] - 1.0) <= FRIEDMAN_SIGMA_TOL,
          res["sigma_mean"])
    res = large_n_phase()
    report("large_n_n50000_m20_c4", **_public(res),
           rmse_max=LARGE_N_RMSE_MAX, peak_bytes=peak_bytes(device))
    check(res["rmse"] <= LARGE_N_RMSE_MAX, res["rmse"])


def mesh_vs_one_card(devices, phase, mesh_kw: dict, name: str,
                     **phase_kw) -> None:
    """``phase`` on a mesh over ``devices`` against the same seed on one
    card; per-card peak bytes show every card held its shard."""
    mesh = make_mesh(devices=devices, **mesh_kw)
    res_m = phase(mesh=mesh, **phase_kw)
    peaks = [peak_bytes(d) for d in devices]
    if devices[0].platform == "gpu":
        check(all(pk is not None and pk > 0 for pk in peaks), peaks)
    res_1 = phase(**phase_kw)
    diff = res_m["chain_means"] - res_1["chain_means"]
    rms = np.sqrt(np.mean(diff ** 2, axis=-1))
    data = mesh.shape["data"] > 1
    tol = f"|drmse|<={MESH_RMSE_TOL},|dsigma|<={MESH_SIGMA_TOL}" + (
        "" if data else f",per_chain_rms<={MESH_CHAIN_RMS_TOL}")
    report(name, mesh=dict(mesh.shape), **_public(res_m),
           one_card_rmse=res_1["rmse"],
           one_card_sigma_mean=res_1["sigma_mean"],
           one_card_steady_s_per_draw=res_1["steady_s_per_draw"],
           per_chain_mean_rms_diff=[round(float(r), 6) for r in rms],
           bit_identical=bool(np.all(diff == 0)), tol=tol,
           peak_bytes_per_card=peaks)
    check(abs(res_m["rmse"] - res_1["rmse"]) <= MESH_RMSE_TOL,
          "rmse differs from one card")
    check(abs(res_m["sigma_mean"] - res_1["sigma_mean"]) <= MESH_SIGMA_TOL,
          "sigma differs from one card")
    if not data:
        check(bool(np.all(rms <= MESH_CHAIN_RMS_TOL)), rms)


def four_cards(devices, friedman_kw=None, large_kw=None) -> None:
    check(len(devices) == 4, f"--four-cards needs 4 devices, got {devices}")
    mesh_vs_one_card(devices, large_n_phase,
                     dict(n_chain_shards=2, n_data_shards=2),
                     "mesh_chains2_data2_large_n", **(large_kw or {}))
    mesh_vs_one_card(devices, friedman_phase, {}, "mesh_chains4_friedman",
                     **(friedman_kw or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phases")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    setup_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    devices = jax.devices()
    dev = devices[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    for line in card_lines():
        print(line, flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(devices[:4])
    else:
        one_card(dev)
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
