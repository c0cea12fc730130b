"""pymc_bart_tpu — an accelerator-native Bayesian Additive Regression Trees engine.

A from-scratch JAX/XLA re-design of the capabilities of
pymc-devs/pymc-bart (reference mounted read-only; see SURVEY.md):
the BART sum-of-trees random variable, the PGBART particle-Gibbs sampler
over fixed-depth SoA tree tensors, an HMC compound step for non-BART free
RVs, and the interpretability/variable-selection toolkit — all inside one
jitted, mesh-shardable program.

Public surface mirrors reference ``pymc_bart/__init__.py:24-47`` plus the
slice of PyMC the reference depends on (Model, distributions, sample).
"""

from .config import (
    BartConfig,
    ContinuousSplitRule,
    OneHotSplitRule,
    PgbartConfig,
    SplitRule,
    SubsetSplitRule,
)
from .models import (
    BART,
    BARTRV,
    Bernoulli,
    Categorical,
    Data,
    Deterministic,
    Exponential,
    Gamma,
    HalfNormal,
    InferenceData,
    LogNormal,
    Model,
    NegativeBinomial,
    Normal,
    Poisson,
    StudentT,
    Uniform,
    math,
    preprocess_xy,
    set_data,
)
from .models.predictive import (
    sample_posterior_predictive,
    sample_prior_predictive,
)
from .sampler import PGBART, sample
from .utils import (
    check_convergence,
    compute_variable_importance,
    export_variable_inclusion,
    ess_bulk,
    rhat,
    summary,
    get_variable_inclusion,
    plot_convergence,
    plot_ice,
    plot_pdp,
    plot_scatter_submodels,
    plot_variable_importance,
    plot_variable_inclusion,
    vi_to_kulprit,
)

__all__ = [
    "compute_variable_importance",
    "export_variable_inclusion",
    "get_variable_inclusion",
    "plot_convergence",
    "plot_ice",
    "plot_pdp",
    "plot_scatter_submodels",
    "plot_variable_importance",
    "plot_variable_inclusion",
    "sample_posterior_predictive",
    "sample_prior_predictive",
    "vi_to_kulprit",
    "check_convergence",
    "ess_bulk",
    "rhat",
    "summary",
    "BART",
    "BARTRV",
    "BartConfig",
    "ContinuousSplitRule",
    "OneHotSplitRule",
    "SplitRule",
    "SubsetSplitRule",
    "Bernoulli",
    "Categorical",
    "Data",
    "Deterministic",
    "Exponential",
    "Gamma",
    "HalfNormal",
    "InferenceData",
    "LogNormal",
    "Model",
    "NegativeBinomial",
    "Normal",
    "PGBART",
    "PgbartConfig",
    "Poisson",
    "StudentT",
    "Uniform",
    "math",
    "preprocess_xy",
    "sample",
    "set_data",
]

__version__ = "0.5.0"
