"""Per-backend policy, the compile-cache helper, and device placement of
derived transposes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.config import platform_policy
from surfh_tpu.core.linop import build_transpose
from surfh_tpu.utils import cache


def test_platform_policy_cpu():
    p = platform_policy("cpu")
    assert p.conv_impl == "fft" and p.max_unrolled_pointings == 2
    assert platform_policy() == p  # the tests run on the CPU backend


def test_platform_policy_gpu():
    p = platform_policy("gpu")
    # matmul: the only conv with the λ-rank factorization and PSF stamps
    assert p.conv_impl == "matmul" and p.max_unrolled_pointings == 4


def test_platform_policy_unknown_backend_raises():
    with pytest.raises(ValueError, match="no platform policy"):
        platform_policy("rocm")


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_compile_cache()
    assert got == cache.cache_dir("jax") == jax.config.jax_compilation_cache_dir
    # a fixed directory inside the checkout, listed in .gitignore
    assert got.endswith("/.surfh_cache/jax")
    with open(cache.CACHE_ROOT.replace(".surfh_cache", ".gitignore")) as fh:
        assert ".surfh_cache/" in fh.read().split()


def test_compile_cache_env_set(monkeypatch, restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    # JAX took its directory from the variable; the helper sets no other
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_transpose_runs_on_default_device():
    """An eager derived transpose computes where the caller's default device
    is, not on a pinned host device."""
    mat = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    transpose = build_transpose(
        lambda x: jnp.asarray(mat) @ x, jax.ShapeDtypeStruct((4,), jnp.float32)
    )
    target = jax.devices()[-1]
    y = jax.device_put(np.ones(3, np.float32), target)
    with jax.default_device(target):
        (xt,) = transpose(y)
    assert set(xt.devices()) == {target}
    np.testing.assert_allclose(np.asarray(xt), mat.T @ np.ones(3))
