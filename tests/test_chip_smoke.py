"""chip_smoke.py: its refusal without a GPU, its comparison functions at
tiny widths on the CPU device, and the compile-cache rule."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from pymc_bart_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run_script(REPO)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("linear", [False, True], ids=["constant", "linear"])
def test_predict_check_passes_on_cpu(linear):
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.check_predict(cpu, 200, m=4, depth=6, linear=linear)
    assert res["max_abs_err"] <= chip_smoke.PRED_REL_TOL * res["max_abs_pred"]


@pytest.mark.parametrize("kind", ["const", "suff", "linear"])
def test_grow_check_passes_on_cpu(kind):
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.check_grow(cpu, cpu, kind, n=300, P=4)
    assert res["max_rel_err"] == 0.0
    assert res.get("fit_rel_err_unbounded", 0.0) == 0.0
    assert res["nodes_grown"] > 0


def test_grow_comparison_catches_a_misrouted_row():
    cpu = jax.devices("cpu")[0]
    from pymc_bart_tpu.config import BartConfig

    inp = chip_smoke.grow_inputs(3, 4, 200, 5, 1, 2, 6, nan_rows=True)
    want = jax.device_get(chip_smoke.grow_round_const_fn(
        BartConfig(max_depth=6), 2, suff=False)(jax.device_put(inp, cpu)))
    got = dict(want)
    got["leaf_idx"] = want["leaf_idx"].copy()
    got["leaf_idx"][1, 7] += 1
    with pytest.raises(AssertionError):
        chip_smoke.compare_outputs(got, want)
    got = dict(want, leaf=want["leaf"] * (1 + 1e-3))
    with pytest.raises(AssertionError):
        chip_smoke.compare_outputs(got, want)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    # nothing is set in code when the variable is present
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture
def gpu_device():
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return gpus[0]


@pytest.mark.gpu
def test_comparisons_at_real_width_on_gpu(gpu_device):
    cpu = jax.devices("cpu")[0]
    for linear in (False, True):
        chip_smoke.check_predict(gpu_device, 50_000, linear=linear)
    for kind, n, P in (("const", 1000, 20), ("suff", 50_000, 10),
                       ("linear", 1000, 20)):
        chip_smoke.check_grow(gpu_device, cpu, kind, n, P)
