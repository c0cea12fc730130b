"""Branchless sum-of-trees prediction kernels.

Replaces the reference's native per-tree ``TreeArrays.predict(x, excluded)``
(reference ``pymc_bart/utils.py:81-94``) and the Python loop around it with
fixed-shape, fully vectorized traversals:

* fast path (no exclusion): D rounds of
  ``node = 2*node + 1 + (go_right)`` index arithmetic with gathers —
  vmappable over trees, particles, and posterior draws.
* excluded path: level-synchronous probability-mass propagation.  When a
  node splits on an excluded covariate its mass flows to both children
  proportionally to training row counts, reproducing the reference's
  "fast PDP" exclusion semantics (children averaged weighted by row
  counts; reference CHANGELOG.md:377-378 and SURVEY 2.3 TreeArrays).

Leaf response: a leaf predicts ``leaf + slope * x[:, parent_split_var]``
(reference linear response, bart.py:85-87); slope is identically zero for
the default constant response, so both responses share these kernels.
Under exclusion, the linear term still reads the actual covariate value —
exclusion integrates out *routing*, not leaf functions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .trees import Forest, decide_left, level_slots


def tree_leaf_index(split_var, split_val, split_set, X, rules, depth: int):
    """Node slot reached by each row of X after ``depth`` descent rounds.

    Because leaf values of internal nodes are retained (see trees.py), the
    result for ``depth < max_depth`` is the row's node in the
    depth-truncated tree — used to weight the frozen particle in the
    conditional SMC.

    Args:
      split_var: int32[S]; split_val: float32[S]; split_set: uint32[S]
      X: float32[n, p]; rules: int32[p]
      depth: static number of rounds (max tree depth to traverse)

    Returns: int32[n] node slots.
    """
    n = X.shape[0]
    idx = jnp.zeros((n,), jnp.int32)
    for _ in range(depth):
        var = split_var[idx]
        var_c = jnp.clip(var, 0, X.shape[1] - 1)
        xv = jnp.take_along_axis(X, var_c[:, None], axis=1)[:, 0]
        left = decide_left(xv, split_val[idx], split_set[idx], rules[var_c])
        child = 2 * idx + 1 + (1 - left.astype(jnp.int32))
        idx = jnp.where(var >= 0, child, idx)
    return idx


def leaf_values_at(split_var, leaf, slope, X, idx):
    """Leaf response at node slots ``idx`` per row: float32[n, k]."""
    parent = jnp.maximum((idx - 1) // 2, 0)
    pvar = split_var[parent]
    pvar_c = jnp.clip(pvar, 0, X.shape[1] - 1)
    xp = jnp.take_along_axis(X, pvar_c[:, None], axis=1)[:, 0]
    xp = jnp.where((idx > 0) & (pvar >= 0), jnp.nan_to_num(xp, nan=0.0), 0.0)
    return leaf[idx] + slope[idx] * xp[:, None]


def tree_predict(split_var, split_val, split_set, leaf, slope, X, rules,
                 depth: int):
    """Single-tree prediction: float32[n, k]."""
    idx = tree_leaf_index(split_var, split_val, split_set, X, rules, depth)
    return leaf_values_at(split_var, leaf, slope, X, idx)


def forest_predict(forest: Forest, X, rules, depth: int | None = None):
    """Sum-of-trees prediction over the m-tree axis: float32[n, k].

    Equivalent to the reference accumulation
    ``pred += tree.predict(x=X)`` over the m trees of a draw
    (reference ``pymc_bart/utils.py:92-94``), fused into one vmapped kernel.
    """
    if depth is None:
        depth = _max_depth_of(forest.split_var.shape[-1])
    per_tree = jax.vmap(
        lambda sv, sl, ss, lf, sp: tree_predict(sv, sl, ss, lf, sp, X, rules, depth)
    )(forest.split_var, forest.split_val, forest.split_set, forest.leaf,
      forest.slope)
    return per_tree.sum(axis=0)


def tree_predict_excluded(split_var, split_val, split_set, leaf, count, slope,
                          X, rules, excluded_mask, depth: int):
    """Single-tree prediction with covariates marked in ``excluded_mask``
    integrated out by row-count-weighted mass propagation: float32[n, k].

    ``excluded_mask``: bool[p].
    """
    n = X.shape[0]
    k = leaf.shape[-1]
    out = jnp.zeros((n, k), jnp.float32)
    mass = jnp.ones((n, 1), jnp.float32)
    for d in range(depth + 1):
        lo, hi = level_slots(d)
        var = split_var[lo:hi]
        var_c = jnp.clip(var, 0, X.shape[1] - 1)
        internal = (var >= 0) & (d < depth)
        # leaf response values for this level's slots, per row
        slots = jnp.arange(lo, hi)
        parent = jnp.maximum((slots - 1) // 2, 0)
        pvar = split_var[parent]
        pvar_c = jnp.clip(pvar, 0, X.shape[1] - 1)
        xp = X[:, pvar_c]  # (n, S_d)
        xp = jnp.where((slots > 0) & (pvar >= 0)[None, :],
                       jnp.nan_to_num(xp, nan=0.0), 0.0)
        level_vals = leaf[lo:hi][None, :, :] + slope[lo:hi][None, :, :] * xp[:, :, None]
        # accumulate output where mass sits on a leaf
        leaf_here = jnp.where(internal, 0.0, 1.0)
        out = out + jnp.einsum(
            "ns,nsk->nk", mass * leaf_here[None, :], level_vals,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        if d == depth:
            break
        xv = X[:, var_c]  # (n, S_d)
        left = decide_left(xv, split_val[lo:hi][None, :], split_set[lo:hi][None, :],
                           rules[var_c][None, :])
        cl = count[2 * jnp.arange(lo, hi) + 1]
        cr = count[2 * jnp.arange(lo, hi) + 2]
        frac_l = cl / jnp.maximum(cl + cr, 1e-12)
        excl = excluded_mask[var_c] & (var >= 0)
        p_left = jnp.where(excl[None, :], frac_l[None, :], left.astype(jnp.float32))
        m_int = mass * internal[None, :].astype(jnp.float32)
        mass = jnp.stack([m_int * p_left, m_int * (1.0 - p_left)], axis=-1).reshape(n, -1)
    return out


def forest_predict_excluded(forest: Forest, X, rules, excluded_mask, depth: int | None = None):
    """Sum-of-trees prediction with exclusion: float32[n, k]."""
    if depth is None:
        depth = _max_depth_of(forest.split_var.shape[-1])
    per_tree = jax.vmap(
        lambda sv, sl, ss, lf, ct, sp: tree_predict_excluded(
            sv, sl, ss, lf, ct, sp, X, rules, excluded_mask, depth)
    )(forest.split_var, forest.split_val, forest.split_set, forest.leaf,
      forest.count, forest.slope)
    return per_tree.sum(axis=0)


def _max_depth_of(n_nodes: int) -> int:
    d = 0
    while 2 ** (d + 2) - 1 <= n_nodes:
        d += 1
    return d
