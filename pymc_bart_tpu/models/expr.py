"""Minimal lazy expression graph for model definitions.

The reference rides on PyTensor for its symbolic graph (reference
bart.py:24-28).  The JAX framework needs only enough symbolic
structure to let users write the reference's model idioms —
``pm.Normal("y", mu, sigma, observed=Y)``, ``w[0]``, ``pm.math.abs(w[1])``,
``pm.math.softmax(lo.T, axis=-1)`` (reference tests/test_bart.py:117-156)
— and evaluate them with jax.numpy inside the jitted sampler graph.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np


class Expr:
    """Base of all lazy nodes; overloads arithmetic to build the graph."""

    def __add__(self, other):
        return Op(jnp.add, self, other)

    def __radd__(self, other):
        return Op(jnp.add, other, self)

    def __sub__(self, other):
        return Op(jnp.subtract, self, other)

    def __rsub__(self, other):
        return Op(jnp.subtract, other, self)

    def __mul__(self, other):
        return Op(jnp.multiply, self, other)

    def __rmul__(self, other):
        return Op(jnp.multiply, other, self)

    def __truediv__(self, other):
        return Op(jnp.divide, self, other)

    def __rtruediv__(self, other):
        return Op(jnp.divide, other, self)

    def __pow__(self, other):
        return Op(jnp.power, self, other)

    def __neg__(self):
        return Op(jnp.negative, self)

    def __abs__(self):
        return Op(jnp.abs, self)

    def __getitem__(self, key):
        op = Op(lambda x: x[key], self)
        op.tag = ("getitem", key)  # structured form for pattern matching
        return op

    @property
    def T(self):
        op = Op(lambda x: jnp.swapaxes(x, -1, -2) if x.ndim > 1 else x, self)
        op.tag = ("transpose",)
        return op

    def exp(self):
        return Op(jnp.exp, self)

    def log(self):
        return Op(jnp.log, self)


class Const(Expr):
    def __init__(self, value):
        self.value = value


class Op(Expr):
    def __init__(self, fn: Callable, *args, **kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.tag = None  # optional structured description (e.g. getitem)


def evaluate(x: Any, env: Dict[str, Any]):
    """Evaluate an expression (or plain value) against ``env``.

    ``env`` maps RV/Data names to concrete (jnp) arrays.  Named leaves
    (anything with a ``.name`` attribute that is an Expr subclass with
    ``_is_named = True``) are looked up by name.
    """
    if isinstance(x, Op):
        args = [evaluate(a, env) for a in x.args]
        return x.fn(*args, **x.kwargs)
    if isinstance(x, Const):
        return x.value
    if isinstance(x, Expr):  # named leaf (FreeRV / BARTRV / Data / Deterministic)
        name = getattr(x, "name", None)
        if name is None or name not in env:
            raise KeyError(f"expression leaf {name!r} not found in environment")
        return env[name]
    if isinstance(x, (np.ndarray, np.generic, int, float, list, tuple)):
        return jnp.asarray(x)
    return x


# ---------------------------------------------------------------------------
# math namespace (mirrors the pm.math idioms used by the reference tests)
# ---------------------------------------------------------------------------


def _lift(fn):
    def wrapper(*args, **kwargs):
        if any(isinstance(a, Expr) for a in args):
            return Op(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    return wrapper


class math:  # noqa: N801 — namespace, mirrors pm.math
    exp = _lift(jnp.exp)
    log = _lift(jnp.log)
    sqrt = _lift(jnp.sqrt)
    abs = _lift(jnp.abs)
    tanh = _lift(jnp.tanh)
    sigmoid = _lift(jax.nn.sigmoid)
    invlogit = _lift(jax.nn.sigmoid)
    softmax = _lift(jax.nn.softmax)
    logsumexp = _lift(jax.scipy.special.logsumexp)
    floor = _lift(jnp.floor)
    clip = _lift(jnp.clip)
    maximum = _lift(jnp.maximum)
    minimum = _lift(jnp.minimum)
    sum = _lift(jnp.sum)
    mean = _lift(jnp.mean)
    where = _lift(jnp.where)
    dot = _lift(jnp.matmul)
    constant = staticmethod(lambda x: Const(jnp.asarray(x)))
