"""PGBART: particle-Gibbs BART sampler as fixed-shape JAX kernels.

Fixed-shape array redesign of the reference's native PGBART step method
(reference SURVEY 2.3; algorithm per Lakshminarayanan et al.,
arXiv:1502.04622, and the reference's behavioral history in CHANGELOG.md):

* The per-tree conditional SMC runs **depth-synchronously**: at round d,
  every expandable depth-d leaf of every non-frozen particle draws a grow
  decision with probability alpha*(1+d)^-beta (reference bart.py:104-106),
  a split variable from the adaptive categorical over columns, a split
  value from the observed values of rows in the leaf, and children leaf
  values from Normal(node residual mean / m, leaf_sd) — all as vmapped
  fixed-shape array ops.  The reference grows one popped leaf per SMC
  iteration; depth-synchronous growth is an equivalent-proposal schedule
  that maps 1:1 onto fixed-depth tree tensors and removes all
  data-dependent control flow.
* The frozen reference particle (particle 0) replays its stored tree one
  level per round: because leaf values of internal nodes are retained
  (see ops/trees.py), its depth-truncated predictions — and hence its
  incremental SMC weights — are exact.
* Systematic resampling of the non-frozen particles with post-resampling
  reset to the log-mean weight (reference CHANGELOG.md:400-402), gated on
  effective sample size; final tree selected from all particles by
  normalized weights.
* Per-step Gibbs over a rotating batch of trees (reference PGBART
  ``batch`` fractions), with split-prior adaptation and running
  leaf-variance tracking during tuning (reference CHANGELOG.md:380).

Everything here is per chain; chains are vmapped/sharded by the caller.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..config import BartConfig, PgbartConfig
from ..ops.trees import Forest, decide_left, init_forest
from ..ops.predict import leaf_values_at, tree_predict
from ..ops.resample import (
    effective_sample_size,
    normalize_log_weights,
    systematic_indices,
)


def _exact_dot(a, b):
    """``a @ b`` in full float32.  Every product on the sampler path is a
    one-hot selection or sum that must reproduce its operands exactly;
    at default precision a GPU may run float32 products in TF32."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PgbartState:
    """Carried sampler state for one BART variable (one chain)."""

    forest: Forest          # (m, S) arrays; leaf (m, S, k)
    tree_pred: jax.Array    # float32[m, n, k] cached per-tree predictions
    sum_trees: jax.Array    # float32[n, k]
    alpha_vec: jax.Array    # float32[p] adaptive split-variable weights
    leaf_sd: jax.Array      # float32[k] leaf-value proposal scale
    # Welford accumulator over per-tree predictions, for leaf_sd adaptation
    wf_count: jax.Array     # float32[]
    wf_mean: jax.Array      # float32[n, k]
    wf_m2: jax.Array        # float32[n, k]
    batch_offset: jax.Array  # int32[] rotating tree pointer
    iteration: jax.Array    # int32[] Gibbs iterations done (for adaptation gate)


def init_state(X, Y_target, cfg: BartConfig, split_prior=None,
               data_axis=None) -> PgbartState:
    """Initial all-root-leaf state.

    Each tree starts as a single leaf predicting mean(Y)/m so the initial
    sum of trees equals Y.mean() (reference bart.py:146 initval and
    SURVEY 2.3 step 1).  leaf_sd starts at std(Y)/sqrt(m).

    ``data_axis``: with rows sharded over a mesh axis, the mean/std ride
    psums so every shard initializes the SAME (replicated) tree state.
    """
    n, _p = X.shape
    k = cfg.n_outputs
    Y_target = jnp.asarray(Y_target, jnp.float32).reshape(n, k)
    if data_axis is None:
        y_mean = Y_target.mean(axis=0)  # (k,)
        n_root = n
    else:
        n_glob = jax.lax.psum(jnp.float32(n), data_axis)
        y_mean = jax.lax.psum(Y_target.sum(axis=0), data_axis) / n_glob
        n_root = n_glob  # node counts are replicated state: global rows
    forest = init_forest(cfg.m, cfg.n_nodes, k, y_mean / cfg.m, n_root)
    tree_pred = jnp.broadcast_to((y_mean / cfg.m)[None, None, :], (cfg.m, n, k)).astype(
        jnp.float32
    )
    if split_prior is None or split_prior.size == 0:
        alpha_vec = jnp.ones((X.shape[1],), jnp.float32)
    else:
        alpha_vec = jnp.asarray(split_prior, jnp.float32)
    if data_axis is None:
        leaf_sd = Y_target.std(axis=0) / jnp.sqrt(float(cfg.m))
    else:
        n_glob = jax.lax.psum(jnp.float32(n), data_axis)
        var = jax.lax.psum(((Y_target - y_mean[None, :]) ** 2).sum(axis=0),
                           data_axis) / n_glob
        leaf_sd = jnp.sqrt(var) / jnp.sqrt(float(cfg.m))
    leaf_sd = jnp.maximum(leaf_sd, 1e-6)
    return PgbartState(
        forest=forest,
        tree_pred=tree_pred,
        sum_trees=jnp.broadcast_to(y_mean[None, :], (n, k)).astype(jnp.float32),
        alpha_vec=alpha_vec,
        leaf_sd=leaf_sd,
        wf_count=jnp.zeros((), jnp.float32),
        wf_mean=jnp.zeros((n, k), jnp.float32),
        wf_m2=jnp.zeros((n, k), jnp.float32),
        batch_offset=jnp.zeros((), jnp.int32),
        iteration=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Particle growth round
# ---------------------------------------------------------------------------


# n threshold above which per-level sufficient statistics ride an exact
# one-hot product instead of segment_sum (see _child_stats), and at which
# the unsharded Gaussian sampler switches to node-space sufficient
# statistics; small n keeps segment_sum
_SEG_MATMUL_N = 16384


def _child_stats(leaf_idx, resid, lo: int, width: int, data_axis=None):
    """Counts and residual sums for node slots [lo, lo+width).

    O(n) via ``segment_sum`` below ``_SEG_MATMUL_N`` rows, via one
    (n, width) one-hot contraction above it.  Rows outside the slot range
    land in a dump segment.

    With ``data_axis`` set (rows sharded over a mesh axis inside
    shard_map), the sufficient statistics are psum-reduced over the row
    shards (SURVEY 2.4 "data parallelism over rows").
    """
    valid = (leaf_idx >= lo) & (leaf_idx < lo + width)
    ids = jnp.where(valid, leaf_idx - lo, width)
    n = leaf_idx.shape[0]
    if n >= _SEG_MATMUL_N:
        # large n: the (n, width) one-hot contraction computes the same
        # statistics as a single dense pass, where segment_sum's atomic
        # adds contend on few segments.  On an H100 at n=50000 it is
        # faster at widths 2 and 16, slower at 64, and faster in total
        # over a tree's levels (scripts/onehot_vs_gather.py; numbers in
        # PERF.md).  precision=HIGHEST keeps full
        # float32 accuracy; counts are rounded back to the exact
        # integers they mathematically are.
        oh = (ids[:, None] == jnp.arange(width, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)            # (n, width); dump row = 0
        z = jnp.concatenate(
            [jnp.ones((n, 1), jnp.float32), resid], axis=1)
        stats = jax.lax.dot_general(
            oh, z, (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)  # (width, 1 + k)
        counts = jnp.round(stats[:, 0])
        sums = stats[:, 1:]
    else:
        counts = jax.ops.segment_sum(
            valid.astype(jnp.float32), ids, num_segments=width + 1)[:width]
        sums = jax.ops.segment_sum(
            jnp.where(valid[:, None], resid, 0.0), ids,
            num_segments=width + 1)[:width]
    if data_axis is not None:
        counts = jax.lax.psum(counts, data_axis)
        sums = jax.lax.psum(sums, data_axis)
    return counts, sums


def _leaf_rsum(resid, li, S: int, data_axis=None):
    """Per-leaf residual sums for refinement prior centers: (S, k)."""
    out = jax.ops.segment_sum(resid, li, num_segments=S)
    if data_axis is not None:
        out = jax.lax.psum(out, data_axis)
    return out


def _grow_round_const(rands, frozen, sv, sl, st, lf, ct, leaf_idx, pred,
                      d: int, X_z, x_nanm, rules, alpha_cdf, leaf_sd, resid,
                      cfg: BartConfig, data_axis=None, all_cont: bool = False,
                      x_nan: bool = True, suff=None):
    """One depth-synchronous growth round, constant leaf response,
    GATHER-FREE in row space.

    ``suff``: optional per-particle node sufficient-statistics carry
    ``(nN, nR, nQ, occ)`` — per-node row count, residual sum, residual
    sum-of-squares and a row-occupancy mask (True for the nodes whose
    rows currently sit there).  When given (the sufficient-statistics
    Gaussian mode of ``_update_one_tree``, used by the row-sharded
    large-n path), the round also writes the psum-reduced child stats
    for every ACTIVATED node (grown OR frozen-replayed, so the frozen
    particle's likelihood is exact too), maintains ``occ``, SKIPS the
    per-row prediction carry (the caller computes the winner's
    prediction once at the end), and returns
    ``(sv, sl, st, lf, ct, leaf_idx, pred, nN, nR, nQ, occ)``.

    This formulation expresses all row-space work as masked blends over
    the level's G nodes, one (n, p)x(p, G) one-hot product for per-node
    x columns, and ``_child_stats`` sufficient statistics, with no
    per-row dynamic gather or ``segment_max``.  It also carries per-row
    predictions incrementally (rows that route take their child's leaf
    value), so the caller never re-derives predictions via gathers.
    The one-hot products run at ``Precision.HIGHEST``: a reduced-precision
    float32 product (TF32 on GPU tensor cores) would round ``x`` and
    route a row to the wrong side of a split value drawn exactly from X.

    Semantically identical to ``_grow_round`` (same RNG consumption,
    same winner row, same committed state) — equivalence is covered by
    tests/test_grow_round.py.  Returns updated
    ``(sv, sl, st, lf, ct, leaf_idx, pred)``.
    """
    n, p = X_z.shape
    lo, hi = 2**d - 1, 2 ** (d + 1) - 1
    G = hi - lo

    node_sv = sv[lo:hi]
    is_leaf = node_sv < 0
    alive = ct[lo:hi] >= 2.0
    p_grow = cfg.alpha * (1.0 + d) ** (-cfg.beta)
    want_grow = (rands["u_grow"] < p_grow) & is_leaf & alive & (~frozen)

    u_var = rands["u_var"] * alpha_cdf[-1]
    var_s = jnp.clip(jnp.searchsorted(alpha_cdf, u_var), 0, p - 1).astype(jnp.int32)

    # per-node Gumbel winner via fused masked reductions (no segment_max)
    row_gum = rands["row_gum"]
    in_lvl = (leaf_idx >= lo) & (leaf_idx < hi)
    iota_n = jnp.arange(n, dtype=jnp.int32)
    node_masks = [in_lvl & (leaf_idx == lo + g) for g in range(G)]
    neg = jnp.float32(-jnp.inf)
    mx = jnp.stack([jnp.max(jnp.where(m, row_gum, neg)) for m in node_masks])
    # first row attaining its node's max (ties null for continuous Gumbels)
    row_sel = jnp.stack([
        jnp.min(jnp.where(m & (row_gum >= mx[g]), iota_n, n))
        for g, m in enumerate(node_masks)])
    rs_c = jnp.clip(row_sel, 0, n - 1)
    val_s = X_z[rs_c, var_s]                       # (G,) tiny gather
    if x_nan:
        val_s = jnp.where(x_nanm[rs_c, var_s], jnp.nan, val_s)
    val_s = jnp.where(jnp.isfinite(mx), val_s, jnp.nan)
    if data_axis is not None:
        # global winner: the shard holding the max Gumbel contributes
        # the value (cross-shard ties are null; a NaN winner value
        # rides the psum as NaN + 0 = NaN on every shard)
        g_mx = jax.lax.pmax(mx, data_axis)
        owner = (mx >= g_mx) & jnp.isfinite(g_mx)
        val_s = jax.lax.psum(jnp.where(owner, val_s, 0.0), data_axis)
        val_s = jnp.where(jnp.isfinite(g_mx), val_s, jnp.nan)

    if all_cont:
        st_s = st[lo:hi]
    else:
        # hash-salted subset rule: the stored word is a raw SALT; the own
        # category is a member via split-value equality (ops/trees.py)
        st_s = rands["set_bits"]

    varx = jnp.where(frozen, node_sv, var_s)
    varx_c = jnp.clip(varx, 0, p - 1)
    valx = jnp.where(frozen, sl[lo:hi], val_s)
    active = jnp.where(frozen, node_sv >= 0, want_grow)

    # candidate x value per (row, node) in ONE exact one-hot product,
    # then G-term masked blends collapse per-node params onto rows
    M = (jnp.arange(p, dtype=jnp.int32)[None, :]
         == varx_c[:, None]).astype(jnp.float32)   # (G, p)
    xv_nodes = _exact_dot(X_z, M.T)                # (n, G)
    if x_nan:
        xnan_nodes = _exact_dot(x_nanm.astype(jnp.float32), M.T)

    valx_clean = jnp.nan_to_num(valx, nan=0.0)
    valx_isnan = jnp.isnan(valx)
    xv_clean = jnp.zeros((n,), jnp.float32)
    val_row = jnp.zeros((n,), jnp.float32)
    act_row = jnp.zeros((n,), bool)
    xnan_row = jnp.zeros((n,), jnp.float32) if x_nan else None
    vnan_row = jnp.zeros((n,), bool) if x_nan else None
    if not all_cont:
        set_row = jnp.zeros((n,), jnp.uint32)
        rule_row = jnp.zeros((n,), jnp.int32)
        rule_g = rules[varx_c]                     # (G,) tiny gather
        setx = jnp.where(frozen, st[lo:hi], st_s)
    for g, m in enumerate(node_masks):
        mf = m.astype(jnp.float32)
        xv_clean = xv_clean + mf * xv_nodes[:, g]
        val_row = val_row + mf * valx_clean[g]
        act_row = act_row | (m & active[g])
        if x_nan:
            xnan_row = xnan_row + mf * xnan_nodes[:, g]
            vnan_row = vnan_row | (m & valx_isnan[g])
        if not all_cont:
            set_row = set_row | jnp.where(m, setx[g], jnp.uint32(0))
            rule_row = rule_row + jnp.where(m, rule_g[g], 0)
    if x_nan:
        xv = jnp.where(xnan_row > 0.5, jnp.nan, xv_clean)
        val_row = jnp.where(vnan_row, jnp.nan, val_row)
    else:
        xv = xv_clean
    if all_cont:
        left = xv <= val_row                       # NaN -> False -> right
    else:
        left = decide_left(xv, val_row, set_row, rule_row)
    child = 2 * leaf_idx + 1 + (1 - left.astype(jnp.int32))
    tentative = jnp.where(act_row, child, leaf_idx)

    if suff is None:
        ccounts, csums = _child_stats(tentative, resid, hi, 2 * G,
                                      data_axis)
    else:
        # one extra segment-summed column carries sum r^2 (k == 1 here;
        # the caller gates) — the node-space Gaussian likelihood needs
        # per-node (N, R, Q) and nothing row-shaped
        z = jnp.concatenate([resid, resid * resid], axis=1)
        ccounts, zsums = _child_stats(tentative, z, hi, 2 * G, data_axis)
        csums = zsums[:, :1]
        csumsq = zsums[:, 1]
    cl, cr = ccounts[0::2], ccounts[1::2]
    valid = (cl > 0) & (cr > 0)
    grow_ok = want_grow & valid
    active_final = jnp.where(frozen, node_sv >= 0, grow_ok)
    actf_row = jnp.zeros((n,), bool)
    for g, m in enumerate(node_masks):
        actf_row = actf_row | (m & active_final[g])
    leaf_idx_new = jnp.where(actf_row, child, leaf_idx)

    sv = sv.at[lo:hi].set(jnp.where(grow_ok, var_s, node_sv))
    sl = sl.at[lo:hi].set(jnp.where(grow_ok, val_s, sl[lo:hi]))
    if not all_cont:
        st = st.at[lo:hi].set(jnp.where(grow_ok, st_s, st[lo:hi]))

    eps = rands["eps"]
    c_safe = jnp.maximum(ccounts, 1.0)[:, None]
    mu = csums / c_safe / cfg.m + eps * leaf_sd[None, :]
    parent_ok = jnp.repeat(grow_ok, 2)
    ct = ct.at[hi:hi + 2 * G].set(
        jnp.where(parent_ok, ccounts, ct[hi:hi + 2 * G]))
    lf = lf.at[hi:hi + 2 * G].set(
        jnp.where(parent_ok[:, None], mu, lf[hi:hi + 2 * G]))

    if suff is not None:
        # node sufficient statistics for every node activated this round
        # (grown AND frozen-replayed: the frozen particle's likelihood
        # must be exact under the CURRENT residuals, not its stored
        # counts); occupancy moves from the parent to its children
        nN, nR, nQ, occ = suff
        rep_act = jnp.repeat(active_final, 2)
        nN = nN.at[hi:hi + 2 * G].set(
            jnp.where(rep_act, ccounts, nN[hi:hi + 2 * G]))
        nR = nR.at[hi:hi + 2 * G].set(
            jnp.where(rep_act, csums[:, 0], nR[hi:hi + 2 * G]))
        nQ = nQ.at[hi:hi + 2 * G].set(
            jnp.where(rep_act, csumsq, nQ[hi:hi + 2 * G]))
        occ = occ.at[lo:hi].set(
            jnp.where(active_final, False, occ[lo:hi]))
        occ = occ.at[hi:hi + 2 * G].set(
            jnp.where(rep_act & (ccounts > 0), True, occ[hi:hi + 2 * G]))
        # no per-row prediction carry in this mode (the likelihood is
        # node-space algebra; the winner's prediction is one gather at
        # the very end of the tree update)
        return sv, sl, st, lf, ct, leaf_idx_new, pred, nN, nR, nQ, occ

    # incremental prediction: routed rows take their child's leaf value
    # (for the frozen particle the stored children values; lf for grown
    # nodes now holds mu).  Internal-node leaf values being retained
    # makes this the depth-truncated prediction round by round.
    lf_ch = lf[hi:hi + 2 * G]                      # (2G, k)
    k = lf.shape[-1]
    lval = jnp.zeros((n, k), jnp.float32)
    rval = jnp.zeros((n, k), jnp.float32)
    for g, m in enumerate(node_masks):
        mf = m.astype(jnp.float32)[:, None]
        lval = lval + mf * lf_ch[2 * g][None, :]
        rval = rval + mf * lf_ch[2 * g + 1][None, :]
    cv = jnp.where(left[:, None], lval, rval)
    pred_new = jnp.where(actf_row[:, None], cv, pred)
    return sv, sl, st, lf, ct, leaf_idx_new, pred_new


def _grow_round(rands, frozen, sv, sl, st, lf, ct, sp, leaf_idx, d: int, X,
                rules, alpha_cdf, leaf_sd, resid, cfg: BartConfig,
                data_axis=None):
    """One depth-synchronous growth round for a single particle.

    frozen: bool[] — if True, replay the stored tree one level instead of
    growing (the conditional-SMC reference particle).
    ``rands`` is a dict of pre-drawn random numbers for this particle and
    round (drawn batched in _update_one_tree; the same block feeds
    ``_grow_round_const``, so the two formulations are comparable).

    ``data_axis``: mesh axis name when ROWS are sharded (X, resid,
    leaf_idx and ``rands["row_gum"]`` hold this shard's rows; node-level
    state and node-level randoms are replicated).  Child sufficient
    statistics ride a psum and the split-value row is the global
    Gumbel-max winner — given the same global randoms the sharded round
    equals the unsharded one exactly (tests/test_data_sharding.py).
    Returns updated (sv, sl, st, lf, ct, sp, leaf_idx).
    """
    n, p = X.shape
    lo, hi = 2**d - 1, 2 ** (d + 1) - 1
    G = hi - lo
    node_sv = sv[lo:hi]
    is_leaf = node_sv < 0
    alive = ct[lo:hi] >= 2.0
    p_grow = cfg.alpha * (1.0 + d) ** (-cfg.beta)
    want_grow = (rands["u_grow"] < p_grow) & is_leaf & alive & (~frozen)

    # split variable ~ categorical(alpha_vec) via inverse-CDF (O(G log p),
    # not O(G p) — matters for the p=1000 variable-selection configs)
    u_var = rands["u_var"] * alpha_cdf[-1]
    var_s = jnp.clip(jnp.searchsorted(alpha_cdf, u_var), 0, p - 1).astype(jnp.int32)

    # split value: a uniformly random row among rows in the node.  Rows
    # partition across nodes, so one Gumbel per row serves every node;
    # the winner is found with O(n) segment reductions (the round-3
    # (n, G) score matrix was the other large-n HBM hog).
    row_gum = rands["row_gum"]
    in_lvl = (leaf_idx >= lo) & (leaf_idx < hi)
    g_ids = jnp.where(in_lvl, leaf_idx - lo, G)
    seg_max = jax.ops.segment_max(
        jnp.where(in_lvl, row_gum, -jnp.inf), g_ids,
        num_segments=G + 1)[:G]
    if data_axis is not None:
        # continuous Gumbels make cross-shard ties null: exactly one
        # shard's row attains the global per-node max
        seg_max = jax.lax.pmax(seg_max, data_axis)
    g_clip = jnp.clip(g_ids, 0, G - 1)
    is_win = in_lvl & (row_gum >= seg_max[g_clip])
    # deterministic tie-break: the MIN row index attaining the node max
    # (float32 Gumbel ties occur at ~0.3% per node at n=50k; averaging
    # the tying rows' values yielded an unobserved split value and broke
    # comparability with _grow_round_const, which takes the first tying
    # row)
    win_row = jax.ops.segment_min(
        jnp.where(is_win, jnp.arange(n, dtype=jnp.int32), n), g_ids,
        num_segments=G + 1)[:G]
    has_win = win_row < n
    wr_c = jnp.clip(win_row, 0, n - 1)
    val_s = X[wr_c, var_s]                       # (G,) tiny gather
    if data_axis is not None:
        # owner shard = the one holding the global per-node max (ties
        # null across shards for continuous Gumbels); a NaN winner value
        # rides the psum as NaN + 0 = NaN on every shard
        val_s = jax.lax.psum(jnp.where(has_win, val_s, 0.0), data_axis)
        has_win = jax.lax.psum(
            has_win.astype(jnp.float32), data_axis) > 0.5
    val_s = jnp.where(jnp.isfinite(seg_max) & has_win, val_s, jnp.nan)
    # hash-salted subset rule: the stored word is a raw SALT; the own
    # category is a member via split-value equality (ops/trees.py)
    st_s = rands["set_bits"]

    # effective split parameters for routing
    varx = jnp.where(frozen, node_sv, var_s)
    varx_c = jnp.clip(varx, 0, p - 1)
    valx = jnp.where(frozen, sl[lo:hi], val_s)
    setx = jnp.where(frozen, st[lo:hi], st_s)
    active = jnp.where(frozen, node_sv >= 0, want_grow)

    # tentative routing of rows through this level
    in_level = (leaf_idx >= lo) & (leaf_idx < hi)
    g = jnp.clip(leaf_idx - lo, 0, G - 1)
    row_active = in_level & active[g]
    col = varx_c[g]
    xv = jnp.take_along_axis(X, col[:, None], axis=1)[:, 0]
    left = decide_left(xv, valx[g], setx[g], rules[col])
    child = 2 * leaf_idx + 1 + (1 - left.astype(jnp.int32))
    tentative = jnp.where(row_active, child, leaf_idx)

    # child sufficient statistics; growth is reverted if a child is empty
    # (reference semantics: a proposed split with an empty child fails)
    kk = cfg.n_outputs
    if cfg.response == "constant":
        ccounts, csums = _child_stats(tentative, resid, hi, 2 * G, data_axis)
    else:
        # linear leaf response (reference bart.py:85-87): per-child least-
        # squares fit of the residual against the parent's split covariate.
        xs = jnp.nan_to_num(xv, nan=0.0)
        z = jnp.concatenate(
            [resid, xs[:, None], (xs * xs)[:, None], xs[:, None] * resid],
            axis=1,
        )  # (n, 2k + 2)
        ccounts, zsums = _child_stats(tentative, z, hi, 2 * G)
        csums = zsums[:, :kk]
    cl, cr = ccounts[0::2], ccounts[1::2]
    valid = (cl > 0) & (cr > 0)
    grow_ok = want_grow & valid
    active_final = jnp.where(frozen, node_sv >= 0, grow_ok)
    leaf_idx_new = jnp.where(in_level & active_final[g], child, leaf_idx)

    # commit structure for grown nodes (frozen commits nothing)
    sv = sv.at[lo:hi].set(jnp.where(grow_ok, var_s, node_sv))
    sl = sl.at[lo:hi].set(jnp.where(grow_ok, val_s, sl[lo:hi]))
    st = st.at[lo:hi].set(jnp.where(grow_ok, st_s, st[lo:hi]))

    # children: counts and leaf values ~ N(child residual mean / m, leaf_sd)
    eps = rands["eps"]
    c_safe = jnp.maximum(ccounts, 1.0)[:, None]
    mu = csums / c_safe / cfg.m + eps * leaf_sd[None, :]
    child_slope = jnp.zeros((2 * G, cfg.n_outputs), jnp.float32)
    if cfg.response != "constant":
        s_x = zsums[:, kk]
        s_x2 = zsums[:, kk + 1]
        s_xr = zsums[:, kk + 2 :]
        var_x = s_x2 - s_x * s_x / c_safe[:, 0]
        slope_hat = (s_xr - (s_x / c_safe[:, 0])[:, None] * csums) / jnp.maximum(
            var_x, 1e-6
        )[:, None]
        usable = (ccounts >= 3.0) & (var_x > 1e-6)
        if cfg.response == "mix":
            usable = usable & (rands["u_mix"] < 0.5)
        slope_hat = jnp.where(usable[:, None], slope_hat, 0.0)
        intercept = (csums - slope_hat * s_x[:, None]) / c_safe
        mu = jnp.where(
            usable[:, None],
            intercept / cfg.m + eps * leaf_sd[None, :],
            mu,
        )
        child_slope = slope_hat / cfg.m
    parent_ok = jnp.repeat(grow_ok, 2)
    ct = ct.at[hi : hi + 2 * G].set(jnp.where(parent_ok, ccounts, ct[hi : hi + 2 * G]))
    lf = lf.at[hi : hi + 2 * G].set(
        jnp.where(parent_ok[:, None], mu, lf[hi : hi + 2 * G])
    )
    sp = sp.at[hi : hi + 2 * G].set(
        jnp.where(parent_ok[:, None], child_slope, sp[hi : hi + 2 * G])
    )
    return sv, sl, st, lf, ct, sp, leaf_idx_new


# ---------------------------------------------------------------------------
# Conditional SMC for one tree
# ---------------------------------------------------------------------------


import os as _os


def _update_one_tree(key, tree: Forest, sum_noi, resid, alpha_vec, leaf_sd,
                     X, rules, cfg: BartConfig, pg: PgbartConfig,
                     loglik_fn: Callable, lik_params, gauss_w=None,
                     data_axis=None, lik: str = "gauss",
                     lik_const: float = 0.0, all_cont: bool = False,
                     x_nan: bool = True, w_scalar: bool = False):
    """Run the conditional SMC for a single tree; return (new tree, pred).

    ``data_axis``: mesh axis name when rows are sharded (X/resid/gauss_w
    hold this shard's rows).  Sufficient statistics, likelihood sums and
    the split-value winner ride psum/pmax over the axis; with a custom
    ``loglik_fn`` the function itself must psum its row sum.

    ``lik``: closed-form likelihood code detected from the model
    (``compound._fused_likelihood``): "gauss", "bernoulli", "het_abs",
    "het_exp" or "cat_logit"; the non-Gaussian codes evaluate their
    closed form per row instead of calling ``loglik_fn``.
    """
    P = pg.num_particles
    S = cfg.n_nodes
    n, _ = X.shape
    k = cfg.n_outputs
    D = cfg.max_depth
    k_init, key = jax.random.split(key)
    if data_axis is None:
        n_glob = jnp.float32(n)
    else:
        n_glob = jax.lax.psum(jnp.float32(n), data_axis)

    # particle 0 = frozen copy of the current tree; others = root leaves
    def broadcast0(old, fresh):
        return jnp.concatenate([old[None], jnp.broadcast_to(fresh, (P - 1,) + fresh.shape)], 0)

    root_sum = resid.sum(axis=0)
    if data_axis is not None:
        root_sum = jax.lax.psum(root_sum, data_axis)
    root_mu = root_sum / n_glob / cfg.m  # (k,)
    sv = broadcast0(tree.split_var, jnp.full((S,), -1, jnp.int32))
    sl = broadcast0(tree.split_val, jnp.zeros((S,), jnp.float32))
    st = broadcast0(tree.split_set, jnp.zeros((S,), jnp.uint32))
    fresh_lf = jnp.zeros((S, k), jnp.float32).at[0, :].set(root_mu)
    lf = broadcast0(tree.leaf, fresh_lf)
    fresh_ct = jnp.zeros((S,), jnp.float32).at[0].set(1.0) * n_glob
    ct = broadcast0(tree.count, fresh_ct)
    sp = broadcast0(tree.slope, jnp.zeros((S, k), jnp.float32))
    leaf_idx = jnp.zeros((P, n), jnp.int32)
    frozen = jnp.arange(P) == 0

    alpha_cdf = jnp.cumsum(jnp.maximum(alpha_vec, 1e-12))

    def particle_pred(sv_p, lf_p, sp_p, li_p):
        return leaf_values_at(sv_p, lf_p, sp_p, X, li_p)  # (n, k)

    sharded_gauss = data_axis is not None and gauss_w is not None
    # non-Gaussian closed-form likelihood codes
    fused_other = lik in ("bernoulli", "het_abs", "het_exp", "cat_logit")
    # sufficient-statistics Gaussian mode: with a scalar precision and
    # constant response the particle log-likelihood is an exact function
    # of per-node (count, sum r, sum r^2), so SMC weights, resampling,
    # selection AND refinement need no O(P*n) row passes — only the
    # already-psum'd child statistics.  This is how (chains x data) row
    # sharding composes with large n: each shard contributes local stats
    # via psum and all node-space algebra stays replicated.
    # PYMC_BART_TPU_SUFFSTATS=1 also enables it unsharded at any n;
    # =0 forces it off.  Unsharded it engages by itself at
    # n >= _SEG_MATMUL_N, where node-space algebra is strictly cheaper;
    # below the gate the row-space path keeps its exact bit semantics.
    _suff_env = _os.environ.get("PYMC_BART_TPU_SUFFSTATS")
    suff_gauss = (gauss_w is not None and w_scalar and lik == "gauss"
                  and cfg.response == "constant" and k == 1
                  and _suff_env not in ("0", "false", "False")
                  and (data_axis is not None or _suff_env == "1"
                       or n >= _SEG_MATMUL_N))

    def eval_ll(pred_all):
        if fused_other:
            F = sum_noi[None] + pred_all
            if lik == "bernoulli":
                y_full = resid + sum_noi  # the 0/1 labels
                sp = jnp.maximum(F, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(F)))
                ll_rows = y_full[None] * F - sp
            elif lik == "het_abs":
                sg = jnp.abs(F) + lik_const
                ll_rows = -0.5 * gauss_w[None] / (sg * sg) - jnp.log(sg)
            elif lik == "cat_logit":
                # separate-trees softmax class update: growth target > 0
                # flags this class's rows; gauss_w = logsumexp of the
                # other outputs' current values
                y_here = ((resid + sum_noi) > 0).astype(jnp.float32)
                lse = jnp.maximum(F, gauss_w[None]) + jnp.log1p(
                    jnp.exp(-jnp.abs(F - gauss_w[None])))
                ll_rows = y_here[None] * F - lse
            else:  # het_exp
                ll_rows = -0.5 * gauss_w[None] * jnp.exp(-2.0 * F) - F
            ll_p = jnp.sum(ll_rows, axis=(1, 2))
            if data_axis is not None:
                ll_p = jax.lax.psum(ll_p, data_axis)
            return ll_p
        if sharded_gauss:  # row-sharded Gaussian ll: psum the row sums
            diff = resid[None] - pred_all
            local = -0.5 * jnp.sum(gauss_w[None] * diff * diff, axis=(1, 2))
            return jax.lax.psum(local, data_axis)
        return jax.vmap(lambda f: loglik_fn(sum_noi + f, lik_params))(pred_all)

    const_resp = cfg.response == "constant"
    if const_resp:
        # all rows sit at the root: prediction = root leaf value (the
        # gather-free growth rounds then carry pred incrementally)
        pred = jnp.broadcast_to(lf[:, 0:1, :], (P, n, k))
        X_z = jnp.where(jnp.isnan(X), 0.0, X) if x_nan else X
        x_nanm = jnp.isnan(X)
    else:
        pred = jax.vmap(particle_pred)(sv, lf, sp, leaf_idx)

    if suff_gauss:
        w_val = gauss_w.reshape(-1)[0]
        root_sq = jnp.sum(resid * resid)
        if data_axis is not None:
            root_sq = jax.lax.psum(root_sq, data_axis)
        nN = jnp.zeros((P, S), jnp.float32).at[:, 0].set(n_glob)
        nR = jnp.zeros((P, S), jnp.float32).at[:, 0].set(root_sum[0])
        nQ = jnp.zeros((P, S), jnp.float32).at[:, 0].set(root_sq)
        occ = jnp.zeros((P, S), bool).at[:, 0].set(True)

        def node_ll(lf_p, nN_p, nR_p, nQ_p, occ_p):
            # exact Gaussian ll of one particle's depth-truncated
            # prediction: every row predicts its occupied node's leaf
            # value, so  ll = -w/2 * sum_s occ_s (Q - 2 lf R + lf^2 N)
            # (no row pass)
            lv = lf_p[:, 0]
            t = nQ_p - 2.0 * lv * nR_p + lv * lv * nN_p
            return -0.5 * w_val * jnp.sum(jnp.where(occ_p, t, 0.0))

        ll = jax.vmap(node_ll)(lf, nN, nR, nQ, occ)
    else:
        ll = eval_ll(pred)
    log_w = ll
    ll_prev = ll

    # one batched RNG block per tree update (instead of per round): slices
    # index by the level offset 2^d - 1
    Gtot = 2**D - 1
    key, k1, k2, k3, k4, k5, k6, k_res_all = jax.random.split(key, 8)
    if data_axis is not None:
        # row-shaped randoms must differ per shard; node-shaped randoms
        # and the SMC/selection uniforms stay replicated
        k3 = jax.random.fold_in(k3, jax.lax.axis_index(data_axis))
    u_grow_all = jax.random.uniform(k1, (P, Gtot))
    u_var_all = jax.random.uniform(k2, (P, Gtot))
    row_gum_all = jax.random.gumbel(k3, (D, P, n))
    eps_all = jax.random.normal(k4, (P, 2 * Gtot, k))
    set_bits_all = jax.random.bits(k5, (P, Gtot), dtype=jnp.uint32)
    u_mix_all = jax.random.uniform(k6, (P, 2 * Gtot))
    res_keys = jax.random.split(k_res_all, D)

    for d in range(D):
        lo, hi = 2**d - 1, 2 ** (d + 1) - 1
        G = hi - lo
        off = lo
        k_res = res_keys[d]
        rands = {
            "u_grow": u_grow_all[:, off : off + G],
            "u_var": u_var_all[:, off : off + G],
            "row_gum": row_gum_all[d],
            "eps": eps_all[:, 2 * off : 2 * off + 2 * G, :],
            "set_bits": set_bits_all[:, off : off + G],
            "u_mix": u_mix_all[:, 2 * off : 2 * off + 2 * G],
        }
        if suff_gauss:
            (sv, sl, st, lf, ct, leaf_idx, pred,
             nN, nR, nQ, occ) = jax.vmap(
                lambda r_, fz, a, b, c, e, f_, g_, pr, sN, sR, sQ, so:
                _grow_round_const(
                    r_, fz, a, b, c, e, f_, g_, pr, d, X_z, x_nanm, rules,
                    alpha_cdf, leaf_sd, resid, cfg, data_axis=data_axis,
                    all_cont=all_cont, x_nan=x_nan, suff=(sN, sR, sQ, so)
                )
            )(rands, frozen, sv, sl, st, lf, ct, leaf_idx, pred,
              nN, nR, nQ, occ)
        elif const_resp:
            sv, sl, st, lf, ct, leaf_idx, pred = jax.vmap(
                lambda r_, fz, a, b, c, e, f_, g_, pr: _grow_round_const(
                    r_, fz, a, b, c, e, f_, g_, pr, d, X_z, x_nanm, rules,
                    alpha_cdf, leaf_sd, resid, cfg, data_axis=data_axis,
                    all_cont=all_cont, x_nan=x_nan
                )
            )(rands, frozen, sv, sl, st, lf, ct, leaf_idx, pred)
        else:
            sv, sl, st, lf, ct, sp, leaf_idx = jax.vmap(
                lambda r_, fz, a, b, c, e, f_, g_, h_: _grow_round(
                    r_, fz, a, b, c, e, f_, g_, h_, d, X, rules, alpha_cdf,
                    leaf_sd, resid, cfg, data_axis=data_axis
                )
            )(rands, frozen, sv, sl, st, lf, ct, sp, leaf_idx)
            pred = jax.vmap(particle_pred)(sv, lf, sp, leaf_idx)
        if suff_gauss:
            ll = jax.vmap(node_ll)(lf, nN, nR, nQ, occ)
        else:
            ll = eval_ll(pred)

        log_w = log_w + ll - ll_prev
        ll_prev = ll

        if d < D - 1:  # no resampling after the final round (selection follows)
            probs, log_mean = normalize_log_weights(log_w[1:])
            do_resample = effective_sample_size(probs) < 0.5 * (P - 1)
            idx = systematic_indices(k_res, probs, P - 1) + 1
            idx = jnp.where(do_resample, idx, jnp.arange(1, P, dtype=jnp.int32))
            anc = jnp.concatenate([jnp.zeros((1,), jnp.int32), idx])
            sv, sl, st, lf, ct, sp, leaf_idx, pred = (
                a[anc] for a in (sv, sl, st, lf, ct, sp, leaf_idx, pred)
            )
            if suff_gauss:
                nN, nR, nQ, occ = (a[anc] for a in (nN, nR, nQ, occ))
            ll_prev = ll_prev[anc]
            reset = jnp.concatenate([log_w[:1], jnp.full((P - 1,), log_mean)])
            log_w = jnp.where(do_resample, reset, log_w)

    key, k_sel = jax.random.split(key)

    if fused_other and k == 1:
        # winner selection + Metropolis refinement for the non-Gaussian
        # closed-form codes: inverse-CDF winner and refinement normals /
        # uniforms pre-drawn as one block per tree update
        key, k_eps, k_acc = jax.random.split(key, 3)
        R = max(pg.num_refinements, 1)
        if pg.num_refinements > 0:
            eps_r = jax.random.normal(k_eps, (R, k, S))
            u_acc = jax.random.uniform(k_acc, (R,))
        else:
            eps_r = jnp.zeros((R, k, S), jnp.float32)
            u_acc = jnp.ones((R,), jnp.float32)
        u_sel = jax.random.uniform(k_sel, ())
        mxw = jnp.max(log_w)
        e = jnp.exp(log_w - mxw)
        cdf = jnp.cumsum(e)
        u = u_sel * cdf[-1]
        widx = jnp.clip(jnp.sum((cdf < u).astype(jnp.int32)), 0, P - 1)
        sv_w, sl_w, st_w, lf_w, ct_w, sp_w = (
            a[widx] for a in (sv, sl, st, lf, ct, sp)
        )
        li_w = leaf_idx[widx]
        pred_w = pred[widx]
        leaf_mask = ((sv_w < 0) & (ct_w > 0))[:, None].astype(jnp.float32)
        leaf_rsum = _leaf_rsum(resid, li_w, S, data_axis)
        prior_center = leaf_rsum / jnp.maximum(ct_w, 1.0)[:, None] / cfg.m
        hiv = 0.5 / (leaf_sd * leaf_sd)

        def ll_one(pred_x):
            return eval_ll(pred_x[None])[0]

        def lp_of(lf_x):
            dev = lf_x - prior_center
            return -jnp.sum(hiv[None, :] * leaf_mask * dev * dev)

        ll_c0 = ll_one(pred_w) + lp_of(lf_w)
        eps_scale = 0.3 * leaf_sd

        if const_resp:
            pred_from_leaves = lambda lf_x: lf_x[li_w]
        else:
            # linear/mix: the refinement proposal moves intercepts only,
            # but the prediction must keep the slope term
            pred_from_leaves = lambda lf_x: leaf_values_at(
                sv_w, lf_x, sp_w, X, li_w)

        def refine_body(r_i, carry):
            lf_c, pred_c, ll_c = carry
            lf_p = lf_c + eps_r[r_i].T * eps_scale[None, :] * leaf_mask
            pred_p = pred_from_leaves(lf_p)
            ll_p = ll_one(pred_p) + lp_of(lf_p)
            accept = jnp.log(u_acc[r_i]) < (ll_p - ll_c)
            lf_c = jnp.where(accept, lf_p, lf_c)
            pred_c = jnp.where(accept, pred_p, pred_c)
            ll_c = jnp.where(accept, ll_p, ll_c)
            return (lf_c, pred_c, ll_c)

        lf_w, pred_w, _ = jax.lax.fori_loop(
            0, R, refine_body, (lf_w, pred_w, ll_c0))
        new_tree = Forest(sv_w, sl_w, st_w, lf_w, ct_w, sp_w)
        return new_tree, pred_w

    if suff_gauss:
        # winner selection + Metropolis leaf refinement entirely in node
        # space: the ONLY row work for the whole tree update is the final
        # winner prediction below.  All quantities here are replicated
        # across row shards (stats were psum'd at accumulation).
        widx = jax.random.categorical(k_sel, log_w)
        sv_w, sl_w, st_w, lf_w, ct_w = (
            a[widx] for a in (sv, sl, st, lf, ct))
        li_w = leaf_idx[widx]
        nN_w, nR_w, nQ_w, occ_w = (a[widx] for a in (nN, nR, nQ, occ))

        def ll_node_w(lf_x):
            lv = lf_x[:, 0]
            t = nQ_w - 2.0 * lv * nR_w + lv * lv * nN_w
            return -0.5 * w_val * jnp.sum(jnp.where(occ_w, t, 0.0))

        if pg.num_refinements > 0:
            leaf_mask = occ_w[:, None].astype(jnp.float32)
            half_inv_var = 0.5 / (leaf_sd * leaf_sd)  # (k,)
            prior_center = (nR_w / jnp.maximum(nN_w, 1.0) / cfg.m)[:, None]

            def log_prior(lf_x):
                dev = lf_x - prior_center
                return -jnp.sum(half_inv_var[None, :] * leaf_mask
                                * dev * dev)

            ll_c0 = ll_node_w(lf_w) + log_prior(lf_w)

            def refine_body(_r, carry):
                lf_c, ll_c, key_c = carry
                key_c, k_eps, k_acc = jax.random.split(key_c, 3)
                eps = (jax.random.normal(k_eps, lf_c.shape)
                       * (0.3 * leaf_sd)[None, :])
                lf_p = lf_c + eps * leaf_mask
                ll_p = ll_node_w(lf_p) + log_prior(lf_p)
                accept = jnp.log(jax.random.uniform(k_acc, ())) \
                    < (ll_p - ll_c)
                lf_c = jnp.where(accept, lf_p, lf_c)
                ll_c = jnp.where(accept, ll_p, ll_c)
                return (lf_c, ll_c, key_c)

            lf_w, _, _ = jax.lax.fori_loop(
                0, pg.num_refinements, refine_body, (lf_w, ll_c0, key))

        # the one row pass: the winner's prediction
        pred_w = lf_w[li_w]                        # (n, k)
        new_tree = Forest(sv_w, sl_w, st_w, lf_w, ct_w,
                          jnp.zeros((S, k), jnp.float32))
        return new_tree, pred_w

    widx = jax.random.categorical(k_sel, log_w)
    sv_w, sl_w, st_w, lf_w, ct_w, sp_w = (
        a[widx] for a in (sv, sl, st, lf, ct, sp)
    )
    li_w = leaf_idx[widx]
    pred_w = pred[widx]

    # Metropolis refinement of the winner's leaf values (structure fixed):
    # random-walk proposals on the active leaves, accepted by the
    # likelihood ratio TIMES the leaf-value prior ratio.  The growth
    # proposal draws leaf values from N(leaf residual mean / m, leaf_sd)
    # and weights particles by likelihood only, so the sampler's implied
    # per-leaf prior — matching the reference sampler's (SURVEY 2.3
    # step 2) — is exactly that proposal density.  Using the same density
    # here keeps the SMC update and the refinement targeting ONE
    # posterior (tested against the analytic conjugate posterior in
    # tests/test_statistical.py); a likelihood-only ratio would drift
    # leaves toward the MLE with systematically less shrinkage.
    if pg.num_refinements > 0:
        leaf_mask = ((sv_w < 0) & (ct_w > 0))[:, None].astype(jnp.float32)
        half_inv_var = 0.5 / (leaf_sd * leaf_sd)  # (k,)
        # per-leaf residual means (structure is fixed during refinement)
        leaf_rsum = _leaf_rsum(resid, li_w, S, data_axis)
        prior_center = leaf_rsum / jnp.maximum(ct_w, 1.0)[:, None] / cfg.m

        def one_ll(pred_x):
            return eval_ll(pred_x[None])[0]

        def log_prior(lf_x):
            dev = lf_x - prior_center
            return -jnp.sum(half_inv_var[None, :] * leaf_mask * dev * dev)

        ll_w = one_ll(pred_w) + log_prior(lf_w)

        if const_resp:
            pred_from_leaves = lambda lf_x: lf_x[li_w]
        else:
            pred_from_leaves = lambda lf_x: leaf_values_at(
                sv_w, lf_x, sp_w, X, li_w)

        def refine_body(_r, carry):
            lf_c, pred_c, ll_c, key_c = carry
            key_c, k_eps, k_acc = jax.random.split(key_c, 3)
            eps = jax.random.normal(k_eps, lf_c.shape) * (0.3 * leaf_sd)[None, :]
            lf_p = lf_c + eps * leaf_mask
            pred_p = pred_from_leaves(lf_p)
            ll_p = one_ll(pred_p) + log_prior(lf_p)
            accept = jnp.log(jax.random.uniform(k_acc, ())) < (ll_p - ll_c)
            lf_c = jnp.where(accept, lf_p, lf_c)
            pred_c = jnp.where(accept, pred_p, pred_c)
            ll_c = jnp.where(accept, ll_p, ll_c)
            return (lf_c, pred_c, ll_c, key_c)

        lf_w, pred_w, _, _ = jax.lax.fori_loop(
            0, pg.num_refinements, refine_body, (lf_w, pred_w, ll_w, key)
        )

    new_tree = Forest(sv_w, sl_w, st_w, lf_w, ct_w, sp_w)
    return new_tree, pred_w


# ---------------------------------------------------------------------------
# Full PGBART Gibbs step over a batch of trees
# ---------------------------------------------------------------------------


def split_var_counts(forest: Forest, p: int):
    """Histogram of splitting variables over all internal nodes: float32[p].

    This is the per-draw ``variable_inclusion`` statistic (reference
    utils.py:750-762; emitted per draw by the native sampler)."""
    sv = forest.split_var.reshape(-1)
    onehot = (sv[:, None] == jnp.arange(p, dtype=jnp.int32)[None, :])
    return onehot.astype(jnp.float32).sum(axis=0)


@partial(jax.jit, static_argnames=("cfg", "pg", "loglik_fn", "tuning",
                                   "data_axis", "lik", "lik_const",
                                   "all_cont", "x_nan", "w_scalar"))
def pgbart_step(key, state: PgbartState, X, Y_target, rules,
                cfg: BartConfig, pg: PgbartConfig, loglik_fn: Callable,
                lik_params, tuning: bool, gauss_w=None, data_axis=None,
                lik: str = "gauss", lik_const: float = 0.0,
                all_cont: bool = False, x_nan: bool = True,
                w_scalar: bool = False):
    """One PGBART MCMC step (one chain): update a rotating batch of trees.

    ``loglik_fn(f, lik_params) -> scalar`` is the model log-likelihood of a
    candidate sum-of-trees value ``f`` (n, k); it must be a stable (cached)
    function so the jit cache is reused — per-step traced quantities (e.g.
    the current sigma draw) ride in ``lik_params``.

    ``data_axis``: mesh axis name for ROW-sharded sampling inside
    shard_map (large-n configs, SURVEY 2.4): the per-chain state keeps
    only this shard's rows of X / Y_target / tree_pred / sum_trees while
    tree structures stay replicated; cross-shard reductions ride
    psum/pmax over the mesh.  See tests/test_data_sharding.py.

    Returns (new_state, variable_inclusion_counts float32[p]).
    """
    out = _pgbart_step_dispatch(
        key, state, X, Y_target, rules, cfg, pg, loglik_fn, lik_params,
        tuning, gauss_w, data_axis, lik, lik_const, all_cont, x_nan,
        w_scalar)
    if not pg.ancestor_sampling or cfg.response != "constant":
        return out
    # Retained-path rejuvenation (PgbartConfig.ancestor_sampling): valid
    # grow/prune MH moves on the committed trees, composing with every
    # sampler path as plain XLA on the returned state (see
    # sampler/rejuvenate.py for the derivation and why literal PGAS is
    # degenerate for trees).  fold_in (not split) keeps the main paths'
    # RNG streams untouched, so ancestor_sampling=False is bit-identical
    # to not having the feature at all.
    from .rejuvenate import rejuvenate_forest

    new_state, _vi = out
    ll_of = _make_ll_of(loglik_fn, lik_params, gauss_w, lik, lik_const,
                        Y_target.reshape(X.shape[0], cfg.n_outputs),
                        data_axis)
    k_rej = jax.random.fold_in(key, 0xA5CE57)
    new_state = rejuvenate_forest(k_rej, new_state, X, Y_target, rules,
                                  cfg, pg, ll_of, data_axis=data_axis)
    vi = split_var_counts(new_state.forest, X.shape[1])
    return new_state, vi


def _make_ll_of(loglik_fn, lik_params, gauss_w, lik: str, lik_const: float,
                Y_target, data_axis):
    """Scalar model log-likelihood of one tree's candidate prediction
    given the other trees' sum (``sum_noi``), matching the SMC weight
    closed forms of ``_update_one_tree`` exactly."""
    import jax.numpy as _jnp

    def ll_of(sum_noi, pred):
        if lik == "gauss" and gauss_w is not None:
            resid = Y_target - sum_noi
            diff = resid - pred
            return _psum_scalar(-0.5 * _jnp.sum(gauss_w * diff * diff),
                                data_axis)
        if lik == "bernoulli":
            F = sum_noi + pred
            sp = _jnp.maximum(F, 0.0) + _jnp.log1p(_jnp.exp(-_jnp.abs(F)))
            return _psum_scalar(_jnp.sum(Y_target * F - sp), data_axis)
        if lik == "het_abs":
            F = sum_noi + pred
            sg = _jnp.abs(F) + lik_const
            return _psum_scalar(
                _jnp.sum(-0.5 * gauss_w / (sg * sg) - _jnp.log(sg)),
                data_axis)
        if lik == "het_exp":
            F = sum_noi + pred
            return _psum_scalar(
                _jnp.sum(-0.5 * gauss_w * _jnp.exp(-2.0 * F) - F),
                data_axis)
        if lik == "cat_logit":
            F = sum_noi + pred
            lse = _jnp.maximum(F, gauss_w) + _jnp.log1p(
                _jnp.exp(-_jnp.abs(F - gauss_w)))
            y_here = (Y_target > 0).astype(_jnp.float32)
            return _psum_scalar(_jnp.sum(y_here * F - lse), data_axis)
        # generic model likelihood (row sharding is gated off upstream)
        return loglik_fn(sum_noi + pred, lik_params)

    return ll_of


def _psum_scalar(v, data_axis):
    return v if data_axis is None else jax.lax.psum(v, data_axis)


def _pgbart_step_dispatch(key, state, X, Y_target, rules, cfg, pg,
                          loglik_fn, lik_params, tuning, gauss_w,
                          data_axis, lik, lik_const, all_cont, x_nan,
                          w_scalar):
    m = cfg.m
    B = pg.batch_size(m, tuning)
    n, p = X.shape
    Y_target = Y_target.reshape(n, cfg.n_outputs)

    def body(i, carry):
        (forest, tree_pred, sum_trees, alpha_vec, leaf_sd,
         wf_count, wf_mean, wf_m2, iteration, key) = carry
        key, k_tree = jax.random.split(key)
        jt = (state.batch_offset + i) % m
        tree = jax.tree.map(lambda a: a[jt], forest)
        sum_noi = sum_trees - tree_pred[jt]
        resid = Y_target - sum_noi
        new_tree, pred = _update_one_tree(
            k_tree, tree, sum_noi, resid, alpha_vec, leaf_sd,
            X, rules, cfg, pg, loglik_fn, lik_params, gauss_w=gauss_w,
            data_axis=data_axis, lik=lik, lik_const=lik_const,
            all_cont=all_cont, x_nan=x_nan, w_scalar=w_scalar,
        )
        forest = Forest(
            forest.split_var.at[jt].set(new_tree.split_var),
            forest.split_val.at[jt].set(new_tree.split_val),
            forest.split_set.at[jt].set(new_tree.split_set),
            forest.leaf.at[jt].set(new_tree.leaf),
            forest.count.at[jt].set(new_tree.count),
            forest.slope.at[jt].set(new_tree.slope),
        )
        tree_pred = tree_pred.at[jt].set(pred)
        sum_trees = sum_noi + pred
        iteration = iteration + 1

        if tuning:
            # Dirichlet-style split-prior adaptation: +1 per SPLIT NODE
            # using the variable (reference:
            # ``for index in tree.get_split_variables():
            #       alpha_vec[index] += 1`` — one entry per internal
            # node, a multiset).  Full counts concentrate the proposal
            # on signal covariates much faster than a per-tree cap at
            # high p (BASELINE config 5).
            tsv = new_tree.split_var
            tcounts = (
                (tsv[:, None] == jnp.arange(p, dtype=jnp.int32)[None, :])
                .astype(jnp.float32).sum(axis=0)
            )
            alpha_vec = alpha_vec * pg.split_prior_decay + tcounts
            # running leaf variance -> leaf_sd (reference CHANGELOG.md:380)
            wf_count = wf_count + 1.0
            delta = pred - wf_mean
            wf_mean = wf_mean + delta / wf_count
            wf_m2 = wf_m2 + delta * (pred - wf_mean)
            sd_sum = jnp.sqrt(
                jnp.maximum(wf_m2 / jnp.maximum(wf_count, 1.0), 1e-12)
            ).sum(axis=0)
            if data_axis is None:
                sd = sd_sum / X.shape[0]
            else:
                sd = (jax.lax.psum(sd_sum, data_axis)
                      / jax.lax.psum(jnp.float32(X.shape[0]), data_axis))
            leaf_sd = jnp.where(iteration > m, jnp.maximum(sd, 1e-6), leaf_sd)

        return (forest, tree_pred, sum_trees, alpha_vec, leaf_sd,
                wf_count, wf_mean, wf_m2, iteration, key)

    carry = (state.forest, state.tree_pred, state.sum_trees, state.alpha_vec,
             state.leaf_sd, state.wf_count, state.wf_mean, state.wf_m2,
             state.iteration, key)
    (forest, tree_pred, sum_trees, alpha_vec, leaf_sd,
     wf_count, wf_mean, wf_m2, iteration, _key) = jax.lax.fori_loop(
        0, B, body, carry
    )

    new_state = PgbartState(
        forest=forest, tree_pred=tree_pred, sum_trees=sum_trees,
        alpha_vec=alpha_vec, leaf_sd=leaf_sd,
        wf_count=wf_count, wf_mean=wf_mean, wf_m2=wf_m2,
        batch_offset=(state.batch_offset + B) % m,
        iteration=iteration,
    )
    vi = split_var_counts(forest, p)
    return new_state, vi


def refresh_tree_pred(state: PgbartState, X, rules, cfg: BartConfig) -> PgbartState:
    """Recompute the per-tree prediction cache from the forest (e.g. after
    restoring a checkpoint)."""
    per_tree = jax.vmap(
        lambda sv, sl, ss, lfv, spv: tree_predict(
            sv, sl, ss, lfv, spv, X, rules, cfg.max_depth)
    )(state.forest.split_var, state.forest.split_val, state.forest.split_set,
      state.forest.leaf, state.forest.slope)
    return dataclasses.replace(
        state, tree_pred=per_tree, sum_trees=per_tree.sum(axis=0)
    )
