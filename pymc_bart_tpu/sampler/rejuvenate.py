"""Retained-path rejuvenation: grow/prune Metropolis moves on the
committed trees (``PgbartConfig(ancestor_sampling=True)``).

WHY.  The plain particle-Gibbs tree update suffers the classic PG path
degeneracy: the frozen reference particle usually out-weighs the fresh
root-grown particles, so trees turn over slowly and the min bulk-ESS
floor (~5 per 2400 draws on friedman, round 4) is FLAT in
particles / batch / refinements.  The literature's cure is Particle
Gibbs with Ancestor Sampling (Lindsten, Jordan & Schon, 2014): refresh
the RETAINED path by resampling its history at every SMC step.  Literal
ancestor sampling is degenerate for trees — grafting the retained
tree's deeper levels onto another particle's prefix has almost-surely
zero proposal probability, because the graft slots must be available
leaves of the other particle (the transition density collapses onto the
frozen prefix itself after one or two levels).  The tree-structured
counterpart of "refresh the retained path" is therefore applied HERE,
after the CSMC: reversible-jump GROW / PRUNE Metropolis moves on each
committed tree — the classic Chipman-George-McCulloch BART kernel —
which perturb the retained structure locally with likelihood-ratio
acceptance.  Each move is a valid MCMC kernel for the same per-tree
conditional target as the CSMC and the leaf-refinement step, so
composing them preserves the posterior while directly attacking tree
turnover.

TARGET.  The per-tree conditional is pi(T, leaves) ∝ L(y | F) x
q_prior(T, leaves), where q_prior is the sampler's implied prior — the
depth-synchronous growth process density (every leaf at depth d < D
contributes (1 - p_grow(d)), every internal node p_grow(d) x P(var) x
P(value | rows) [x P(salt)], and each ACTIVE leaf value is
N(node residual mean / m, leaf_sd), the same convention the
Metropolis leaf refinement already uses — sampler/pgbart.py
"the sampler's implied per-leaf prior ... is exactly that proposal
density").  Proposing from exactly these distributions collapses the
acceptance ratio to

    grow at leaf l, depth d:
      log a = dLL + log p_grow(d) - log(1 - p_grow(d))
              + [d+1 < D] * 2 log(1 - p_grow(d+1))
              + log n_grow_candidates(T) - log n_prune_candidates(T')
    prune at node s, depth d:  the negation with T <-> T'.

(P(var), P(value|rows), P(salt) and every leaf-value normal cancel
between the prior ratio and the proposal ratio; a proposed split with
an empty child is rejected, mirroring the growth process's revert.
Known approximation, shared with classic CGM implementations: the
leaf-stay factor ignores the tiny probability mass the revert adds to
"stay a leaf", and leaves with < 2 rows carry no stay factor.)

COST.  Each move touches one node's rows: one dynamic column slice of X
per ancestor level plus O(n) masked reductions — no per-row gathers, so
it stays cheap at large n and composes with every sampler mode
(row-space, node-space sufficient statistics, row-sharded) since it
runs as plain XLA on the committed state.  Row-sharded (``data_axis``) execution psums the
counts / sums / likelihood terms exactly like the main sampler.

Reference: arXiv:1502.04622 (PG-BART) is plain conditional SMC; the
grow/prune kernel is Chipman, George & McCulloch (1998).  This module
is the round-5 VERDICT "Next round" #3 item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BartConfig, PgbartConfig
from ..ops.trees import decide_left


def _depth_array(S: int) -> np.ndarray:
    return np.floor(np.log2(np.arange(S) + 1)).astype(np.int32)


def _col(X, j):
    """Column j (traced scalar) of X as (n,) — a contiguous dynamic
    slice, not a per-row gather."""
    n = X.shape[0]
    return jax.lax.dynamic_slice_in_dim(X, j, 1, axis=1).reshape(n)


def _rows_at_node(sv, sl, st, rules, X, node, D: int):
    """bool[n] mask of training rows routed to ``node`` (traced slot).

    Walks the ancestor chain root-ward: D fixed iterations, each testing
    the parent's split on the full row set and requiring the step's
    child direction.  Rows of X are this shard's local rows when the
    caller row-shards; the mask is local by construction.
    """
    n, p = X.shape
    mask = jnp.ones((n,), bool)
    s = node
    for _ in range(D):
        valid = s > 0
        par = jnp.maximum((s - 1) // 2, 0)
        j = jnp.clip(sv[par], 0, p - 1)
        xcol = _col(X, j)
        left = decide_left(xcol, sl[par], st[par], rules[j])
        want_left = s == 2 * par + 1
        ok = jnp.where(want_left, left, ~left)
        mask = mask & jnp.where(valid, ok, True)
        s = par
    return mask


def _psum(v, data_axis):
    return v if data_axis is None else jax.lax.psum(v, data_axis)


def _pick(mask_f, gumbels):
    """Uniform pick among mask>0 slots via Gumbel-max; returns (idx, n)."""
    count = jnp.sum(mask_f)
    score = jnp.where(mask_f > 0.5, gumbels, -jnp.inf)
    return jnp.argmax(score).astype(jnp.int32), count


def _one_move(key, sv, sl, st, lf, ct, pred, X, resid, sum_noi,
              alpha_cdf, leaf_sd, rules, cfg: BartConfig, ll_of: Callable,
              depth_arr, data_axis):
    """One grow-or-prune MH attempt on a single tree.  Returns the
    (possibly unchanged) ``(sv, sl, st, lf, ct, pred)``."""
    n, p = X.shape
    S = cfg.n_nodes
    D = cfg.max_depth
    k = lf.shape[-1]
    m = cfg.m

    (k_move, k_node, k_var, k_row, k_salt, k_eps, k_acc
     ) = jax.random.split(key, 7)
    if data_axis is not None:
        # row-shaped randoms must differ per shard; everything else is
        # replicated so every shard takes the same branch/decisions
        k_row = jax.random.fold_in(k_row, jax.lax.axis_index(data_axis))
    gS = jax.random.gumbel(k_node, (S,))
    u_var = jax.random.uniform(k_var, ())
    row_gum = jax.random.gumbel(k_row, (n,))
    salt = jax.random.bits(k_salt, (), dtype=jnp.uint32)
    eps = jax.random.normal(k_eps, (2, k))
    u_acc = jax.random.uniform(k_acc, ())
    iota_n = jnp.arange(n, dtype=jnp.int32)
    iota_S = jnp.arange(S, dtype=jnp.int32)

    # static child-slot index maps (clipped for the last level, whose
    # slots are never internal so the clipped reads are masked out)
    child_l = np.minimum(2 * np.arange(S) + 1, S - 1)
    child_r = np.minimum(2 * np.arange(S) + 2, S - 1)
    is_last = depth_arr >= D

    is_leaf = sv < 0
    grow_cand = ((is_leaf & (ct >= 2.0) & (depth_arr < D))
                 ).astype(jnp.float32)
    prune_cand = ((~is_leaf) & is_leaf[child_l] & is_leaf[child_r]
                  & ~is_last).astype(jnp.float32)
    n_grow = jnp.sum(grow_cand)
    n_prune = jnp.sum(prune_cand)

    def p_grow_at(d):
        return cfg.alpha * (1.0 + d.astype(jnp.float32)) ** (-cfg.beta)

    def child_stay(d):  # 2 log(1 - p_grow(d+1)) unless children are at D
        return jnp.where(d + 1 < D,
                         2.0 * jnp.log1p(-p_grow_at(d + 1.0)), 0.0)

    def grow_branch(_):
        node, _cnt = _pick(grow_cand, gS)
        d = depth_arr[node].astype(jnp.float32)
        mask = _rows_at_node(sv, sl, st, rules, X, node, D)
        cnt = ct[node]  # replicated global row count

        var = jnp.clip(
            jnp.searchsorted(alpha_cdf, u_var * alpha_cdf[-1]),
            0, p - 1).astype(jnp.int32)
        xcol = _col(X, var)
        # split value = x at the MIN-index row attaining the node's
        # Gumbel max (the tie rule every sampler path uses)
        sc = jnp.where(mask, row_gum, -jnp.inf)
        mx = jnp.max(sc)
        if data_axis is not None:
            # cross-shard ties are null for continuous Gumbels: exactly
            # one shard's rows attain the global per-node max
            mx = jax.lax.pmax(mx, data_axis)
        win = (sc >= mx) & mask
        ridx = jnp.min(jnp.where(win, iota_n, n))
        has_win = ridx < n
        val_loc = jnp.where(has_win, xcol[jnp.clip(ridx, 0, n - 1)], 0.0)
        val = _psum(jnp.where(has_win, val_loc, 0.0), data_axis)
        val = jnp.where(
            _psum(has_win.astype(jnp.float32), data_axis) > 0.5,
            val, jnp.nan)

        left = mask & decide_left(xcol, val, salt, rules[var])
        cl = _psum(jnp.sum(left.astype(jnp.float32)), data_axis)
        cr = cnt - cl
        rs_l = _psum(jnp.sum(jnp.where(left[:, None], resid, 0.0),
                             axis=0), data_axis)                  # (k,)
        rs_t = _psum(jnp.sum(jnp.where(mask[:, None], resid, 0.0),
                             axis=0), data_axis)
        rs_r = rs_t - rs_l
        mu_l = rs_l / jnp.maximum(cl, 1.0) / m + eps[0] * leaf_sd
        mu_r = rs_r / jnp.maximum(cr, 1.0) / m + eps[1] * leaf_sd

        pred_new = jnp.where(
            mask[:, None],
            jnp.where(left[:, None], mu_l[None, :], mu_r[None, :]),
            pred)
        dll = ll_of(sum_noi, pred_new) - ll_of(sum_noi, pred)

        sv_p = sv.at[node].set(var)
        l_i, r_i = 2 * node + 1, 2 * node + 2
        # pruneable count of the PROPOSED tree (reverse-move candidates)
        is_leaf_p = sv_p < 0
        prune_p = ((~is_leaf_p) & is_leaf_p[child_l] & is_leaf_p[child_r]
                   & ~is_last).astype(jnp.float32)
        n_prune_p = jnp.sum(prune_p)

        pg_d = p_grow_at(d)
        log_a = (dll + jnp.log(pg_d) - jnp.log1p(-pg_d) + child_stay(d)
                 + jnp.log(jnp.maximum(n_grow, 1.0))
                 - jnp.log(jnp.maximum(n_prune_p, 1.0)))
        ok = (n_grow > 0.5) & (cl > 0.5) & (cr > 0.5)
        acc = ok & (jnp.log(u_acc) < log_a)
        accf = acc.astype(jnp.float32)

        one_n = (iota_S == node).astype(jnp.float32) * accf
        one_l = (iota_S == l_i).astype(jnp.float32) * accf
        one_r = (iota_S == r_i).astype(jnp.float32) * accf
        sv2 = jnp.where(one_n > 0.5, var, sv)
        sl2 = jnp.where(one_n > 0.5, val, sl)
        st2 = jnp.where(one_n > 0.5, salt, st)
        ct2 = jnp.where(one_l > 0.5, cl, jnp.where(one_r > 0.5, cr, ct))
        lf2 = jnp.where(one_l[:, None] > 0.5, mu_l[None, :],
                        jnp.where(one_r[:, None] > 0.5, mu_r[None, :], lf))
        pred2 = jnp.where(acc, pred_new, pred)
        return sv2, sl2, st2, lf2, ct2, pred2

    def change_branch(_):
        """CGM "change" move: re-draw (var, value, children values) of a
        node whose children are leaves, structure fixed.  Proposal ≡ the
        prior factors for the re-drawn components in BOTH directions, so
        the acceptance is the bare likelihood ratio.  This is the move
        that re-carves the partition locally — the per-row mixing
        lever the grow/prune pair alone lacks."""
        node, _cnt = _pick(prune_cand, gS)
        mask = _rows_at_node(sv, sl, st, rules, X, node, D)
        cnt = ct[node]

        var = jnp.clip(
            jnp.searchsorted(alpha_cdf, u_var * alpha_cdf[-1]),
            0, p - 1).astype(jnp.int32)
        xcol = _col(X, var)
        sc = jnp.where(mask, row_gum, -jnp.inf)
        mx = jnp.max(sc)
        if data_axis is not None:
            mx = jax.lax.pmax(mx, data_axis)
        win = (sc >= mx) & mask
        ridx = jnp.min(jnp.where(win, iota_n, n))
        has_win = ridx < n
        val_loc = jnp.where(has_win, xcol[jnp.clip(ridx, 0, n - 1)], 0.0)
        val = _psum(jnp.where(has_win, val_loc, 0.0), data_axis)
        val = jnp.where(
            _psum(has_win.astype(jnp.float32), data_axis) > 0.5,
            val, jnp.nan)

        left = mask & decide_left(xcol, val, salt, rules[var])
        cl = _psum(jnp.sum(left.astype(jnp.float32)), data_axis)
        cr = cnt - cl
        rs_l = _psum(jnp.sum(jnp.where(left[:, None], resid, 0.0),
                             axis=0), data_axis)
        rs_t = _psum(jnp.sum(jnp.where(mask[:, None], resid, 0.0),
                             axis=0), data_axis)
        rs_r = rs_t - rs_l
        mu_l = rs_l / jnp.maximum(cl, 1.0) / m + eps[0] * leaf_sd
        mu_r = rs_r / jnp.maximum(cr, 1.0) / m + eps[1] * leaf_sd

        pred_new = jnp.where(
            mask[:, None],
            jnp.where(left[:, None], mu_l[None, :], mu_r[None, :]),
            pred)
        dll = ll_of(sum_noi, pred_new) - ll_of(sum_noi, pred)
        ok = (n_prune > 0.5) & (cl > 0.5) & (cr > 0.5)
        acc = ok & (jnp.log(u_acc) < dll)
        accf = acc.astype(jnp.float32)

        l_i, r_i = 2 * node + 1, 2 * node + 2
        one_n = (iota_S == node).astype(jnp.float32) * accf
        one_l = (iota_S == l_i).astype(jnp.float32) * accf
        one_r = (iota_S == r_i).astype(jnp.float32) * accf
        sv2 = jnp.where(one_n > 0.5, var, sv)
        sl2 = jnp.where(one_n > 0.5, val, sl)
        st2 = jnp.where(one_n > 0.5, salt, st)
        ct2 = jnp.where(one_l > 0.5, cl, jnp.where(one_r > 0.5, cr, ct))
        lf2 = jnp.where(one_l[:, None] > 0.5, mu_l[None, :],
                        jnp.where(one_r[:, None] > 0.5, mu_r[None, :], lf))
        pred2 = jnp.where(acc, pred_new, pred)
        return sv2, sl2, st2, lf2, ct2, pred2

    def prune_branch(_):
        node, _cnt = _pick(prune_cand, gS)
        d = depth_arr[node].astype(jnp.float32)
        mask = _rows_at_node(sv, sl, st, rules, X, node, D)
        cnt = ct[node]

        rs_t = _psum(jnp.sum(jnp.where(mask[:, None], resid, 0.0),
                             axis=0), data_axis)                  # (k,)
        mu_s = rs_t / jnp.maximum(cnt, 1.0) / m + eps[0] * leaf_sd
        pred_new = jnp.where(mask[:, None], mu_s[None, :], pred)
        dll = ll_of(sum_noi, pred_new) - ll_of(sum_noi, pred)

        l_i, r_i = 2 * node + 1, 2 * node + 2
        sv_p = sv.at[node].set(-1)
        ct_p = ct.at[l_i].set(0.0).at[r_i].set(0.0)
        is_leaf_p = sv_p < 0
        grow_p = (is_leaf_p & (ct_p >= 2.0)
                  & (depth_arr < D)).astype(jnp.float32)
        n_grow_p = jnp.sum(grow_p)

        pg_d = p_grow_at(d)
        log_a = (dll - jnp.log(pg_d) + jnp.log1p(-pg_d) - child_stay(d)
                 + jnp.log(jnp.maximum(n_prune, 1.0))
                 - jnp.log(jnp.maximum(n_grow_p, 1.0)))
        ok = n_prune > 0.5
        acc = ok & (jnp.log(u_acc) < log_a)
        accf = acc.astype(jnp.float32)

        one_n = (iota_S == node).astype(jnp.float32) * accf
        one_lr = (((iota_S == l_i) | (iota_S == r_i))
                  ).astype(jnp.float32) * accf
        sv2 = jnp.where(one_n > 0.5, -1, sv)
        # children leave the active set entirely (ct = 0) so leaf masks
        # like (sv < 0) & (ct > 0) never see the stale slots
        ct2 = jnp.where(one_lr > 0.5, 0.0, ct)
        lf2 = jnp.where(one_n[:, None] > 0.5, mu_s[None, :],
                        jnp.where(one_lr[:, None] > 0.5, 0.0, lf))
        pred2 = jnp.where(acc, pred_new, pred)
        return sv2, sl, st, lf2, ct2, pred2

    # Move mixture: grow 0.25, prune 0.25 (equal, so the move-choice
    # probabilities cancel in the grow<->prune reversal pair), change
    # 0.5 (self-inverse).  The change move dominates because it is the
    # per-row mixing lever; grow/prune set the dimension.
    u_move = jax.random.uniform(k_move, ())
    midx = jnp.where(u_move < 0.25, 0, jnp.where(u_move < 0.5, 1, 2))
    return jax.lax.switch(midx, [grow_branch, prune_branch,
                                 change_branch], 0)


def rejuvenate_forest(key, state, X, Y_target, rules, cfg: BartConfig,
                      pg: PgbartConfig, ll_of: Callable, data_axis=None):
    """``pg.rejuvenation_sweeps`` grow/prune MH sweeps over all m trees
    of one chain's committed forest (Gibbs-sequential in the tree sum,
    like the main sampler).  Returns the updated ``PgbartState``."""
    m = cfg.m
    n, _p = X.shape
    k = cfg.n_outputs
    S = cfg.n_nodes
    depth_arr = jnp.asarray(_depth_array(S))
    Y_target = Y_target.reshape(n, k)
    alpha_cdf = jnp.cumsum(jnp.maximum(state.alpha_vec, 1e-12))
    leaf_sd = state.leaf_sd

    def body(i, carry):
        forest, tree_pred, sum_trees, key_c = carry
        key_c, k_t = jax.random.split(key_c)
        jt = i % m
        tree = jax.tree.map(lambda a: a[jt], forest)
        pred = tree_pred[jt]
        sum_noi = sum_trees - pred
        resid = Y_target - sum_noi
        sv2, sl2, st2, lf2, ct2, pred2 = _one_move(
            k_t, tree.split_var, tree.split_val, tree.split_set,
            tree.leaf, tree.count, pred, X, resid, sum_noi, alpha_cdf,
            leaf_sd, rules, cfg, ll_of, depth_arr, data_axis)
        from ..ops.trees import Forest

        forest = Forest(
            forest.split_var.at[jt].set(sv2),
            forest.split_val.at[jt].set(sl2),
            forest.split_set.at[jt].set(st2),
            forest.leaf.at[jt].set(lf2),
            forest.count.at[jt].set(ct2),
            forest.slope,
        )
        tree_pred = tree_pred.at[jt].set(pred2)
        sum_trees = sum_noi + pred2
        return forest, tree_pred, sum_trees, key_c

    n_moves = m * max(int(pg.rejuvenation_sweeps), 1)
    forest, tree_pred, sum_trees, _ = jax.lax.fori_loop(
        0, n_moves, body,
        (state.forest, state.tree_pred, state.sum_trees, key))
    return dataclasses.replace(
        state, forest=forest, tree_pred=tree_pred, sum_trees=sum_trees)
