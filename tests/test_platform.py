"""Platform plumbing: compile-cache placement, pinned matmul precision, the
peak table, and chip_smoke.py refusing to run without a GPU."""

import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topo_descriptors_tpu import config
from topo_descriptors_tpu.ops import dft_conv
from topo_descriptors_tpu.utils.profiling import PEAKS, roofline_for

ROOT = Path(__file__).resolve().parent.parent
vr = importlib.import_module("topo_descriptors_tpu.ops.valley_ridge")


# --- compile cache ------------------------------------------------------------


@pytest.fixture()
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_env_wins(monkeypatch, cache_dir_restored, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert config.ensure_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_default_is_fixed_inside_checkout(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    first = config.ensure_compilation_cache()
    assert first == config.ensure_compilation_cache()  # stable, no temp name
    assert Path(first) == ROOT / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == first


def test_cache_set_by_the_caller_is_left_alone(monkeypatch, cache_dir_restored,
                                               tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert config.ensure_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_installed_package_sets_nothing(monkeypatch, cache_dir_restored,
                                              tmp_path):
    # outside a checkout (no pyproject.toml beside the package)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(config, "CHECKOUT", tmp_path)
    jax.config.update("jax_compilation_cache_dir", None)
    assert config.ensure_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_importing_the_drivers_places_no_cache():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("import jax, topo_descriptors_tpu.pipeline, "
            "topo_descriptors_tpu.streaming, topo_descriptors_tpu.cli; "
            "print(jax.config.jax_compilation_cache_dir)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "None"


def test_cache_dir_is_git_ignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# --- pinned precision ---------------------------------------------------------


def _product_precisions(jaxpr):
    """Precision of every matmul and convolution in a jaxpr, sub-jaxprs
    included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            found.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _product_precisions(sub)
    return found


def _valley_programs():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((24, 32)),
                    jnp.float32)
    plan = dft_conv.get_plan(24, 32, 9, 9, "same")
    kern = jnp.ones((3, 9, 9), jnp.float32)
    return {
        "field_spectrum": (lambda a: dft_conv.field_spectrum(a, plan), x),
        "conv_bank": (lambda a: dft_conv.conv_bank(kern, a, a, plan),
                      jnp.zeros((plan.fh, plan.nb), jnp.float32)),
        "valley_dftmm": (lambda a: vr.valley_ridge(a, 7, "valley", (0, 0.2),
                                                   method="dftmm"), x),
        "valley_streamed": (lambda a: vr.valley_ridge_streamed(
            a, 7, "ridge", (0, 0.2), conv_method="mm"), x),
    }


@pytest.mark.parametrize("program", sorted(_valley_programs()))
def test_valley_products_carry_pinned_precision(program):
    fn, arg = _valley_programs()[program]
    pinned = jax.lax.Precision.HIGHEST
    precisions = _product_precisions(jax.make_jaxpr(fn)(arg).jaxpr)
    assert precisions, f"{program} has no product to check"
    for p in precisions:
        assert p == (pinned, pinned), (program, p)


def test_dot_precision_is_highest():
    assert dft_conv.dot_precision() == jax.lax.Precision.HIGHEST


# --- peak table ---------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(PEAKS))
def test_peak_table_known_kinds(kind):
    peaks = roofline_for(kind)
    assert "H100" in kind and "data sheet" in peaks.source
    assert peaks.tf32_tflops > peaks.fp32_tflops > 0
    assert peaks.hbm_light_speed_ms(peaks.hbm_gbps * 1e9) == pytest.approx(1e3)


@pytest.mark.parametrize(
    "kind", ["NVIDIA GeForce RTX 4090", "cpu", "NVIDIA A100-SXM4-80GB"]
)
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak-table entry"):
        roofline_for(kind)


# --- chip_smoke.py without a GPU ------------------------------------------------


def _run_smoke(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "TOPO_TEST_ON_GPU"}
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_refuses_cpu_only_run():
    proc = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
