"""One depth-synchronous growth round against a serial NumPy oracle.

``_grow_round`` is checked against a row-by-row, node-by-node NumPy
implementation of the same round (same pre-drawn randoms): tree
structure and routing exactly, values to float32 round-off.  The
gather-free ``_grow_round_const`` is checked against ``_grow_round``.
"""

import numpy as np
import jax
import pytest

from chip_smoke import grow_inputs, grow_round_const_fn, grow_round_fn
from pymc_bart_tpu.config import BartConfig
from pymc_bart_tpu.ops.predict import leaf_values_at

P, N, NP = 4, 64, 3
DEPTH = 4


def grow_round_oracle(inp, d: int, cfg: BartConfig):
    """Serial reference of one growth round for every particle, in
    float32 with row-order accumulation (a serial scatter-add)."""
    f32 = np.float32
    X, resid = inp["X"], inp["resid"]
    n, p = X.shape
    k = resid.shape[1]
    lo, hi = 2 ** d - 1, 2 ** (d + 1) - 1
    G = hi - lo
    p_grow = np.float32(cfg.alpha * (1.0 + d) ** (-cfg.beta))
    cdf = inp["alpha_cdf"]
    leaf_sd = inp["leaf_sd"]
    outs = {key: [] for key in ("split_var", "split_val", "split_set",
                                "leaf", "count", "slope", "leaf_idx")}
    for pi in range(inp["sv"].shape[0]):
        frozen = bool(inp["frozen"][pi])
        sv, sl, st = (inp[key][pi].copy() for key in ("sv", "sl", "st"))
        lf, ct, sp = (inp[key][pi].copy() for key in ("lf", "ct", "sp"))
        li = inp["li"][pi].copy()
        rd = {key: v[pi] for key, v in inp["rands"].items()}
        node_sv = sv[lo:hi].copy()
        want = ((rd["u_grow"] < p_grow) & (node_sv < 0)
                & (ct[lo:hi] >= 2.0) & (not frozen))
        var_s = np.clip(np.searchsorted(cdf, rd["u_var"] * cdf[-1]), 0, p - 1)
        val_s = np.full(G, np.nan, np.float32)
        for g in range(G):
            rows = np.flatnonzero(li == lo + g)
            if rows.size:  # first row attaining the node's max Gumbel
                val_s[g] = X[rows[np.argmax(rd["row_gum"][rows])], var_s[g]]
        varx = np.clip(np.where(frozen, node_sv, var_s), 0, p - 1)
        valx = np.where(frozen, sl[lo:hi], val_s)
        active = np.where(frozen, node_sv >= 0, want)

        in_level = (li >= lo) & (li < hi)
        child = li.copy()
        xs = np.zeros(n, f32)
        counts = np.zeros(2 * G, f32)
        sums = np.zeros((2 * G, k), f32)
        sx, sx2 = np.zeros(2 * G, f32), np.zeros(2 * G, f32)
        sxr = np.zeros((2 * G, k), f32)
        for r in np.flatnonzero(in_level):
            g = li[r] - lo
            xv = X[r, varx[g]]
            left = bool(xv <= valx[g])  # NaN compares False: goes right
            child[r] = 2 * li[r] + 1 + (0 if left else 1)
            if active[g]:
                s = child[r] - hi
                xs[r] = 0.0 if np.isnan(xv) else xv
                counts[s] += 1
                sums[s] += resid[r]
                sx[s] += xs[r]
                sx2[s] += xs[r] ** 2
                sxr[s] += xs[r] * resid[r]
        grow_ok = want & (counts[0::2] > 0) & (counts[1::2] > 0)
        act_final = np.where(frozen, node_sv >= 0, grow_ok)
        moved = in_level & act_final[np.clip(li - lo, 0, G - 1)]
        li = np.where(moved, child, li)

        sv[lo:hi] = np.where(grow_ok, var_s, node_sv)
        sl[lo:hi] = np.where(grow_ok, val_s, sl[lo:hi])
        st[lo:hi] = np.where(grow_ok, rd["set_bits"], st[lo:hi])
        c_safe = np.maximum(counts, f32(1.0))
        eps = rd["eps"]
        mu = sums / c_safe[:, None] / f32(cfg.m) + eps * leaf_sd[None, :]
        slope = np.zeros((2 * G, k), f32)
        if cfg.response != "constant":
            var_x = sx2 - sx * sx / c_safe
            slope_hat = ((sxr - (sx / c_safe)[:, None] * sums)
                         / np.maximum(var_x, f32(1e-6))[:, None])
            usable = (counts >= 3) & (var_x > f32(1e-6))
            if cfg.response == "mix":
                usable &= rd["u_mix"] < 0.5
            slope_hat = np.where(usable[:, None], slope_hat, f32(0.0))
            intercept = (sums - slope_hat * sx[:, None]) / c_safe[:, None]
            mu = np.where(usable[:, None],
                          intercept / f32(cfg.m) + eps * leaf_sd[None, :], mu)
            slope = slope_hat / f32(cfg.m)
        parent_ok = np.repeat(grow_ok, 2)
        ct[hi:hi + 2 * G] = np.where(parent_ok, counts, ct[hi:hi + 2 * G])
        lf[hi:hi + 2 * G] = np.where(parent_ok[:, None], mu, lf[hi:hi + 2 * G])
        sp[hi:hi + 2 * G] = np.where(parent_ok[:, None], slope,
                                     sp[hi:hi + 2 * G])
        for key, v in zip(outs, (sv, sl, st, lf, ct, sp, li)):
            outs[key].append(v)
    return {key: np.stack(v) for key, v in outs.items()}


def _inputs(seed, k, d, nan_rows, slopes):
    # centred covariates keep the linear fit's intercepts well conditioned
    inp = grow_inputs(seed, P, N, NP, k, d, DEPTH, nan_rows=nan_rows,
                      slopes=slopes, x_offset=-0.5)
    # a mix of nodes that do and do not want to grow at deeper levels
    rng = np.random.default_rng(seed + 1)
    inp["rands"]["u_grow"] = (0.2 * rng.random(inp["rands"]["u_grow"].shape)
                              ).astype(np.float32)
    return inp


@pytest.mark.parametrize("d, k, response", [
    # d x k x response core grid, plus k=8 (joint multi-output)
    (0, 1, "constant"), (1, 1, "constant"), (3, 1, "constant"),
    (0, 2, "constant"), (1, 2, "constant"), (3, 2, "constant"),
    (0, 1, "linear"), (1, 1, "linear"), (3, 1, "linear"),
    (0, 2, "linear"), (1, 2, "linear"), (3, 2, "linear"),
    (0, 1, "mix"), (1, 1, "mix"), (3, 1, "mix"),
    (0, 2, "mix"), (1, 2, "mix"), (3, 2, "mix"),
    (1, 8, "constant"), (3, 8, "constant"), (3, 8, "linear"),
])
def test_grow_round_matches_numpy_oracle(d, k, response):
    cfg = BartConfig(m=5, max_depth=DEPTH, n_outputs=k, response=response)
    inp = _inputs(d * 10 + k, k, d, nan_rows=d == 3,
                  slopes=response != "constant")
    got = jax.device_get(grow_round_fn(cfg, d)(inp))
    want = grow_round_oracle(inp, d, cfg)
    for name in ("split_var", "split_val", "split_set", "count", "leaf_idx"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("leaf", "slope"):
        # within 1e-5 of the array's largest magnitude
        scale = max(float(np.max(np.abs(want[name]))), 1.0)
        err = float(np.max(np.abs(got[name] - want[name])))
        assert err <= 1e-5 * scale, (name, err, scale)
    # the case grew something (structure changed) unless nothing could
    if d < 3:
        assert (got["split_var"] != inp["sv"]).any()


@pytest.mark.parametrize("nan_rows", [False, True], ids=["clean", "nan"])
@pytest.mark.parametrize("d", [0, 1, 3])
def test_grow_round_const_matches_grow_round(d, nan_rows):
    cfg = BartConfig(m=5, max_depth=DEPTH)
    inp = _inputs(100 + d, 1, d, nan_rows=nan_rows, slopes=False)
    const = jax.device_get(
        grow_round_const_fn(cfg, d, suff=False, x_nan=nan_rows)(inp))
    gen = jax.device_get(grow_round_fn(cfg, d)(inp))
    for name in ("split_var", "split_val", "split_set", "count", "leaf_idx"):
        np.testing.assert_array_equal(const[name], gen[name], err_msg=name)
    np.testing.assert_allclose(const["leaf"], gen["leaf"], rtol=1e-6,
                               atol=1e-7)
    # the incrementally carried prediction equals a gather at the new
    # row positions
    want_pred = jax.vmap(lambda sv, lf, sp, li: leaf_values_at(
        sv, lf, sp, inp["X"], li))(gen["split_var"], gen["leaf"],
                                   gen["slope"], gen["leaf_idx"])
    np.testing.assert_allclose(const["pred"], np.asarray(want_pred),
                               rtol=1e-6, atol=1e-7)
