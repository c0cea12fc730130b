"""Hamiltonian Monte Carlo for the non-BART free RVs (compound step).

The reference delegates non-BART RVs to PyMC's NUTS in a compound step
(reference tests/test_bart.py:54-58; SURVEY 3.2).  Here the equivalent is
an in-graph HMC kernel on the model's log-density with the BART outputs
held as constant inputs (the BART logp is identically zero, reference
bart.py:170-182, so tree values enter the gradient only through the
likelihood terms).

Adaptation (during tuning): dual-averaging step size targeting 0.8
acceptance (Hoffman & Gelman 2014, Algorithm 5) and a diagonal mass
matrix from a Welford variance estimate of the posterior draws.  The
trajectory length is jittered uniformly over [1, max_leapfrog] steps.
BART models carry only a handful of continuous parameters (sigmas,
intercepts), so a well-adapted HMC matches NUTS statistically at a
fraction of the control-flow cost inside the jitted graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HmcState:
    theta: jax.Array        # float32[d] unconstrained parameters
    log_step: jax.Array     # float32[] log step size
    # dual averaging state
    da_log_step_avg: jax.Array  # float32[]
    da_h: jax.Array             # float32[]
    da_count: jax.Array         # float32[]
    # Welford for diagonal mass adaptation
    wf_count: jax.Array     # float32[]
    wf_mean: jax.Array      # float32[d]
    wf_m2: jax.Array        # float32[d]
    inv_mass: jax.Array     # float32[d]


def init_state(theta0) -> HmcState:
    theta0 = jnp.asarray(theta0, jnp.float32)
    d = theta0.shape[0]
    return HmcState(
        theta=theta0,
        log_step=jnp.log(jnp.asarray(0.1, jnp.float32)),
        da_log_step_avg=jnp.log(jnp.asarray(0.1, jnp.float32)),
        da_h=jnp.zeros((), jnp.float32),
        da_count=jnp.zeros((), jnp.float32),
        wf_count=jnp.zeros((), jnp.float32),
        wf_mean=jnp.zeros((d,), jnp.float32),
        wf_m2=jnp.zeros((d,), jnp.float32),
        inv_mass=jnp.ones((d,), jnp.float32),
    )


def hmc_step(key, state: HmcState, logp_fn: Callable, logp_params,
             tuning: bool, max_leapfrog: int = 32,
             target_accept: float = 0.8):
    """One HMC transition.  ``logp_fn(theta, logp_params) -> scalar``.

    Returns (new_state, accept_prob).
    """
    k_mom, k_steps, k_acc = jax.random.split(key, 3)
    theta = state.theta
    d = theta.shape[0]
    step = jnp.exp(state.log_step)
    inv_mass = state.inv_mass

    grad_fn = jax.value_and_grad(lambda t: logp_fn(t, logp_params))

    r0 = jax.random.normal(k_mom, (d,)) / jnp.sqrt(inv_mass)
    logp0, grad0 = grad_fn(theta)
    h0 = logp0 - 0.5 * jnp.sum(r0 * r0 * inv_mass)

    n_steps = jax.random.randint(k_steps, (), 1, max_leapfrog + 1)

    def leapfrog(carry, _):
        q, r, grad, i = carry
        do = i < n_steps
        r_half = r + 0.5 * step * grad
        q_new = q + step * r_half * inv_mass
        logp_new, grad_new = grad_fn(q_new)
        r_new = r_half + 0.5 * step * grad_new
        q = jnp.where(do, q_new, q)
        r = jnp.where(do, r_new, r)
        grad = jnp.where(do, grad_new, grad)
        return (q, r, grad, i + 1), logp_new

    (q, r, _, _), logps = jax.lax.scan(
        leapfrog, (theta, r0, grad0, jnp.zeros((), jnp.int32)), None,
        length=max_leapfrog,
    )
    logp1 = logps[jnp.clip(n_steps - 1, 0, max_leapfrog - 1)]
    h1 = logp1 - 0.5 * jnp.sum(r * r * inv_mass)
    log_accept = jnp.minimum(0.0, h1 - h0)
    log_accept = jnp.where(jnp.isfinite(log_accept), log_accept, -jnp.inf)
    accept_prob = jnp.exp(log_accept)
    accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept
    theta_new = jnp.where(accept, q, theta)

    if tuning:
        # dual averaging (Hoffman & Gelman 2014, Alg. 5)
        mu = jnp.log(10.0) + state.log_step * 0.0 + jnp.log(0.1)
        count = state.da_count + 1.0
        kappa, gamma, t0 = 0.75, 0.05, 10.0
        eta = 1.0 / (count + t0)
        h = (1.0 - eta) * state.da_h + eta * (target_accept - accept_prob)
        log_step = mu - jnp.sqrt(count) / gamma * h
        w = count ** (-kappa)
        log_step_avg = w * log_step + (1.0 - w) * state.da_log_step_avg
        # Welford variance of draws -> diagonal inverse mass
        wf_count = state.wf_count + 1.0
        delta = theta_new - state.wf_mean
        wf_mean = state.wf_mean + delta / wf_count
        wf_m2 = state.wf_m2 + delta * (theta_new - wf_mean)
        var = wf_m2 / jnp.maximum(wf_count - 1.0, 1.0)
        inv_mass_new = jnp.where(wf_count > 50.0, jnp.maximum(var, 1e-6), state.inv_mass)
        new_state = HmcState(
            theta=theta_new, log_step=log_step,
            da_log_step_avg=log_step_avg, da_h=h, da_count=count,
            wf_count=wf_count, wf_mean=wf_mean, wf_m2=wf_m2,
            inv_mass=inv_mass_new,
        )
    else:
        new_state = dataclasses.replace(state, theta=theta_new)
    return new_state, accept_prob


def finalize_adaptation(state: HmcState) -> HmcState:
    """Freeze the dual-averaged step size at the end of tuning."""
    return dataclasses.replace(state, log_step=state.da_log_step_avg)
