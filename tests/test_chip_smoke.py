"""chip_smoke.py off the card: its refusals, its cache rule, and its
phase checks at tiny sizes on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from celerite2_tpu.utils.cache import (  # noqa: E402
    ENV_VAR,
    compilation_cache_dir,
)


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(ENV_VAR, None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    proc = _run_script(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_script(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cache_dir_honours_environment(tmp_path):
    chosen = str(tmp_path / "cache")
    got = compilation_cache_dir("unused", environ={ENV_VAR: chosen})
    assert got == chosen


def test_cache_dir_defaults_to_fixed_checkout_path():
    default = os.path.join(ROOT, ".jax_cache")
    assert compilation_cache_dir(default, environ={}) == default
    # the same on every call: the path is part of the cache key
    assert compilation_cache_dir(default, environ={}) == default


@pytest.mark.parametrize(
    "phase,kwargs",
    [
        ("hot_f32", dict(n=512, chain_len=2, reps=1)),
        ("hot_f64", dict(n=512)),
        ("gp_api", dict(n=256, m=20, draws=2)),
        ("fleet", dict(n=128, chains=4, steps=2, max_leapfrog=4)),
        ("island", dict(n=300, reps=1)),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_phase_parity_tiny(phase, kwargs):
    record = chip_smoke.PHASES[phase](**kwargs)
    assert record["phase"] == phase


def test_hot_f32_reports_tier():
    record = chip_smoke.phase_hot_f32(n=2048, chain_len=2, reps=1)
    assert record["auto_tier"] == "assoc"
    assert "factor_solve.assoc" in record["tiers"]


def test_four_runs_only_the_multi_device_phase():
    assert chip_smoke.selected_phases(four=True) == ["four"]
    assert "four" not in chip_smoke.selected_phases(four=False)
    record = chip_smoke.phase_four(
        n=128, chains=8, n_fleet=64, devices=jax.devices()[:4], reps=1
    )
    assert record["devices"] == 4
