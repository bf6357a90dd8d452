"""The device route: compile cache placement, the on-card smoke test's
refusal to run without a GPU, and (on a GPU only) the compiled kernels
against their plain references."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

from oscen_tpu.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper
    sets no other directory."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Without the variable the cache goes to the fixed, gitignored
    ``.jax_cache/`` in the checkout."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits nonzero and prints no result line when JAX
    finds no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        assert not line.startswith("{"), line


@pytest.mark.gpu
def test_compiled_lane_scan_matches_scan(gpu):
    """On the card: the compiled Triton lane scan against lax.scan of the
    same step (phase: bit-exact; TPT: FMA contraction only)."""
    import jax.numpy as jnp
    from oscen_tpu.nodes.filters import tpt_step
    from oscen_tpu.ops.pallas import recurrence
    from oscen_tpu.ops.scan import phase_step

    rng = np.random.default_rng(0)
    V, B = 256, 1024
    with jax.default_device(gpu):
        dt = jnp.asarray(rng.uniform(0, 0.1, (B, V)), jnp.float32)
        p0 = jnp.zeros((V,), jnp.float32)
        a = recurrence._plain_scan(phase_step, p0, dt)
        b = recurrence._pallas_scan(phase_step, p0, dt, B, interpret=False)
        for u, w in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(w))
        x = jnp.asarray(rng.standard_normal((B, V)), jnp.float32)
        xs = (x, jnp.full((1, V), 0.5), jnp.full((1, V), 0.1),
              jnp.full((1, V), 1.4))
        z = (jnp.zeros((V,)), jnp.zeros((V,)))
        a = recurrence._plain_scan(tpt_step, z, xs)
        b = recurrence._pallas_scan(tpt_step, z, xs, B, interpret=False)
        for u, w in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(np.asarray(u), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
