"""Time the exact one-hot products of the sampler against the gather /
segment_sum they stand in for, at the n=50000 width, on the GPU.

The sampler has two such spots:

* winner prediction ``lf[li]`` of a constant-response tree (S=127 node
  slots, k=1), per chain: an (n, S) one-hot times (S, k) at
  ``Precision.HIGHEST`` against a gather;
* per-level sufficient statistics (count, sum r, sum r^2) over the 2G
  child slots of a growth round, per particle and chain: an (n, 2G)
  one-hot contracted with (n, 3) at ``Precision.HIGHEST`` against
  ``segment_sum`` (and the per-leaf residual sums over S slots).

Each form runs ``ITERS`` times inside one jitted ``fori_loop`` (the index
array shifts by the loop counter so no iteration can be hoisted), vmapped
over the shapes the sampler uses; the reported time is per application.
Prints one JSON line per measurement, each naming the card and its power
limit.  Needs a GPU.

    python scripts/onehot_vs_gather.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pymc_bart_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

N, S, CHAINS, PARTICLES = 50_000, 127, 4, 10
ITERS = 200
HI = jax.lax.Precision.HIGHEST


def onehot_pred(li, lf):
    soh = (li[:, None] == jnp.arange(lf.shape[0])[None, :]).astype(jnp.float32)
    return jnp.matmul(soh, lf, precision=HI)


def gather_pred(li, lf):
    return lf[li]


def onehot_stats(ids, z, width):
    oh = (ids[:, None] == jnp.arange(width)[None, :]).astype(jnp.float32)
    zz = jnp.concatenate([jnp.ones((z.shape[0], 1), jnp.float32), z], axis=1)
    return jax.lax.dot_general(oh, zz, (((0,), (0,)), ((), ())), precision=HI)


def segsum_stats(ids, z, width):
    valid = ids < width
    counts = jax.ops.segment_sum(valid.astype(jnp.float32), ids,
                                 num_segments=width + 1)[:width]
    sums = jax.ops.segment_sum(jnp.where(valid[:, None], z, 0.0), ids,
                               num_segments=width + 1)[:width]
    return jnp.concatenate([counts[:, None], sums], axis=1)


def looped(fn, n_idx):
    """ITERS applications of fn(idx, data) with idx shifted by the loop
    counter each time; returns the accumulated output."""
    def run(idx, data):
        def body(i, acc):
            return acc + fn((idx + i) % n_idx, data)
        out0 = jax.eval_shape(fn, idx, data)
        return jax.lax.fori_loop(0, ITERS, body,
                                 jnp.zeros(out0.shape, out0.dtype))
    return jax.jit(run)


def same(f, g, *args):
    """The two forms agree on one application: exact products, so only
    the summation order differs."""
    a, b = np.asarray(jax.jit(f)(*args)), np.asarray(jax.jit(g)(*args))
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert float(np.max(np.abs(a - b))) <= 1e-5 * scale, "forms disagree"


def time_per_application(f, *args, reps: int = 5) -> float:
    jax.block_until_ready(f(*args))
    best = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best.append(time.perf_counter() - t0)
    return float(np.median(best)) / ITERS


def main() -> int:
    if jax.default_backend() != "gpu":
        print("onehot_vs_gather: needs a GPU", file=sys.stderr)
        return 2
    setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    li = jnp.asarray(rng.integers(63, S, size=(CHAINS, N)), jnp.int32)
    lf = jnp.asarray(rng.normal(size=(CHAINS, S, 1)), jnp.float32)
    r = rng.normal(size=(N, 1)).astype(np.float32)
    z = jnp.asarray(np.concatenate([r, r * r], axis=1))

    def emit(what, shape, t_onehot, t_other, other):
        print(json.dumps({
            "what": what, "shape": shape, "onehot_us": round(t_onehot * 1e6, 3),
            f"{other}_us": round(t_other * 1e6, 3),
            "faster": "onehot" if t_onehot < t_other else other,
            "device_kind": dev.device_kind, "card": card}), flush=True)

    # winner prediction, vmapped over chains
    same(jax.vmap(onehot_pred), jax.vmap(gather_pred), li, lf)
    fo = looped(jax.vmap(onehot_pred), S)
    fg = looped(jax.vmap(gather_pred), S)
    emit("winner_prediction", f"chains={CHAINS} n={N} S={S} k=1",
         time_per_application(fo, li, lf), time_per_application(fg, li, lf),
         "gather")

    # per-leaf residual sums (refinement prior centres), vmapped over chains
    zr = jnp.asarray(r)
    one = jax.vmap(lambda i, d: onehot_stats(i, d, S), (0, None))
    seg = jax.vmap(lambda i, d: segsum_stats(i, d, S), (0, None))
    same(one, seg, li, zr)
    fo, fs = looped(one, S), looped(seg, S)
    emit("leaf_residual_sums", f"chains={CHAINS} n={N} S={S} cols=1",
         time_per_application(fo, li, zr), time_per_application(fs, li, zr),
         "segment_sum")

    # child statistics of one growth round, vmapped over particles x chains
    for width in (2, 16, 64):
        ids = jnp.asarray(rng.integers(0, width + 1,
                                       size=(CHAINS, PARTICLES, N)), jnp.int32)
        one = jax.vmap(jax.vmap(lambda i, d, w=width: onehot_stats(i, d, w),
                                (0, None)), (0, None))
        seg = jax.vmap(jax.vmap(lambda i, d, w=width: segsum_stats(i, d, w),
                                (0, None)), (0, None))
        same(one, seg, ids, z)
        fo, fs = looped(one, width + 1), looped(seg, width + 1)
        emit("child_stats",
             f"chains={CHAINS} particles={PARTICLES} n={N} width={width} cols=3",
             time_per_application(fo, ids, z),
             time_per_application(fs, ids, z), "segment_sum")
    return 0


if __name__ == "__main__":
    sys.exit(main())
