"""Fixed-depth structure-of-arrays tree tensors.

The reference stores each sampled decision tree as a native ``TreeArrays``
object — flattened per-node arrays with a native ``.predict()`` (reference
SURVEY 2.3; used at ``pymc_bart/utils.py:81-94``).  This design
goes further: a whole *forest* (m trees x node slots) is one pytree of
dense arrays with a complete-binary-tree slot layout, so every sampler and
prediction operation is a fixed-shape vectorized kernel.

Node slot layout (complete binary tree of depth D, S = 2^(D+1)-1 slots):

* root = slot 0; children of slot i are ``2i+1`` (left) and ``2i+2`` (right)
* depth(i) = floor(log2(i+1)); level d occupies slots [2^d - 1, 2^(d+1) - 1)

Arrays (all with a leading ``m`` tree axis; a single particle tree drops it):

* ``split_var  : int32[m, S]``  — splitting covariate; ``-1`` marks a leaf
* ``split_val  : float32[m, S]`` — threshold (continuous) / category (one-hot)
* ``split_set  : uint32[m, S]``  — category bitmask for the subset rule
* ``leaf       : float32[m, S, k]`` — leaf value(s); k = n_outputs.  Leaf
  values of *internal* nodes are retained (the value the node had when it
  was still a leaf): this gives every tree a well-defined depth-truncated
  prediction, which the conditional-SMC kernel uses to weight the frozen
  reference particle round by round.
* ``slope      : float32[m, S, k]`` — per-leaf linear-response slope for
  ``response="linear"|"mix"`` (reference bart.py:85-87, experimental):
  a leaf predicts ``leaf + slope * x[:, parent_split_var]``.  All-zero
  under the default constant response, so prediction kernels share one
  code path.
* ``count      : float32[m, S]`` — number of training rows that reached the
  node; used for the row-count-weighted children average that implements
  ``predict(x, excluded)`` (reference ``pymc_bart/utils.py:93-94``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Forest:
    """A batch of m fixed-depth trees as dense arrays (see module docstring)."""

    split_var: jax.Array  # int32[..., m, S]
    split_val: jax.Array  # float32[..., m, S]
    split_set: jax.Array  # uint32[..., m, S]
    leaf: jax.Array  # float32[..., m, S, k]
    count: jax.Array  # float32[..., m, S]
    slope: jax.Array  # float32[..., m, S, k]

    @property
    def n_trees(self) -> int:
        return self.split_var.shape[-2]

    @property
    def n_nodes(self) -> int:
        return self.split_var.shape[-1]

    @property
    def n_outputs(self) -> int:
        return self.leaf.shape[-1]

    def tree(self, j) -> "Forest":
        """Slice out tree j (keeps a length-1 tree axis dropped)."""
        return Forest(
            self.split_var[..., j, :],
            self.split_val[..., j, :],
            self.split_set[..., j, :],
            self.leaf[..., j, :, :],
            self.count[..., j, :],
            self.slope[..., j, :, :],
        )


def init_forest(m: int, n_nodes: int, n_outputs: int, init_leaf_value, n_rows: int) -> Forest:
    """All-root-leaf forest predicting ``init_leaf_value`` per tree.

    Mirrors the reference initialization where each of the m trees is a
    single leaf predicting ``Y.mean()/m`` (reference ``bart.py:146``
    ``initval=Y.mean()`` and SURVEY 2.3 step 1).
    """
    init_leaf_value = jnp.asarray(init_leaf_value, jnp.float32)  # (k,)
    leaf = jnp.zeros((m, n_nodes, n_outputs), jnp.float32)
    leaf = leaf.at[:, 0, :].set(jnp.broadcast_to(init_leaf_value, (m, n_outputs)))
    count = jnp.zeros((m, n_nodes), jnp.float32).at[:, 0].set(
        jnp.asarray(n_rows, jnp.float32))  # may be traced (sharded psum)
    return Forest(
        split_var=jnp.full((m, n_nodes), -1, jnp.int32),
        split_val=jnp.zeros((m, n_nodes), jnp.float32),
        split_set=jnp.zeros((m, n_nodes), jnp.uint32),
        leaf=leaf,
        count=count,
        slope=jnp.zeros((m, n_nodes, n_outputs), jnp.float32),
    )


def depth_of_slot(slot: int) -> int:
    d = 0
    while 2 ** (d + 1) - 1 <= slot:
        d += 1
    return d


def level_slots(d: int) -> Tuple[int, int]:
    """[start, end) slot range of level d."""
    return 2**d - 1, 2 ** (d + 1) - 1


def subset_member(cat_i32: jax.Array, split_val, salt_i32: jax.Array):
    """Hash-salted random-subset membership for the Subset split rule.

    ``split_set`` stores a 32-bit SALT, not a bitmask: category c is in
    the node's subset iff a salt-keyed hash bit of c is set, and the
    stored split value's own category is always a member (so the left
    child contains at least the sampled row).  A salt indexes one of
    2^32 pseudo-uniform subsets of the category space, so — unlike the
    round-3 bitmask, which silently clamped categories at 31 — the rule
    supports ANY number of categories in one word (reference
    docs/api_reference.rst:16 SubsetSplitRule has no category bound).
    The integer mixing uses int32-range constants and logical shifts so
    XLA and the C++ core (native/bartcore.cpp) compute identical
    bits.
    """
    h = salt_i32 ^ (cat_i32 * jnp.int32(1103515245))
    h = (h ^ jax.lax.shift_right_logical(h, 15)) * jnp.int32(73244475)
    h = h ^ jax.lax.shift_right_logical(h, 13)
    own = cat_i32 == jnp.nan_to_num(split_val,
                                    nan=-(2.0 ** 30)).astype(jnp.int32)
    return own | ((h & jnp.int32(1)) > 0)


def decide_left(xv: jax.Array, split_val, split_set, rule: jax.Array) -> jax.Array:
    """Vectorized split decision: does row value ``xv`` go to the LEFT child?

    Rules (reference docs/api_reference.rst:16 rule set):

    * continuous: left iff ``x <= v``.  NaN compares False, so missing
      values deterministically route RIGHT — matching the natural
      comparison semantics the reference relies on for NaN rows sampling
      without error (reference tests/test_bart.py:67-81).
    * one-hot:    left iff ``x == v``.
    * subset:     left iff ``int(x)`` is in the node's hash-salted random
      subset (see ``subset_member``; any category count).
    """
    cont = xv <= split_val
    onehot = xv == split_val
    cat = jnp.nan_to_num(xv, nan=0.0).astype(jnp.int32)
    salt = jax.lax.bitcast_convert_type(split_set, jnp.int32)
    subset = subset_member(cat, split_val, salt)
    subset = jnp.where(jnp.isnan(xv), False, subset)
    return jnp.where(rule == 0, cont, jnp.where(rule == 1, onehot, subset))
