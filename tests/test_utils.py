"""utils: batched host fetch and the persistent compile-cache location."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytheiasfm_tpu.utils import cache
from pytheiasfm_tpu.utils.fetch import fetch


def test_fetch_mixed_dtypes_round_trip():
    tree = {
        "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "b": (jnp.int32(7), jnp.ones((4,), jnp.float32)),
        "c": jnp.array([True, False]),
        "host": np.arange(3),
        "scalar": 2.5,
    }
    out = fetch(tree)
    assert isinstance(out["a"], np.ndarray)
    np.testing.assert_array_equal(out["a"], np.arange(6).reshape(2, 3))
    assert out["b"][0] == 7 and out["b"][0].shape == ()
    np.testing.assert_array_equal(out["b"][1], np.ones(4))
    np.testing.assert_array_equal(out["c"], [True, False])
    assert out["host"] is tree["host"]
    assert out["scalar"] == 2.5


def test_fetch_prng_key_leaf():
    """Extended-dtype leaves (typed PRNG keys) are pulled on their own."""
    key = jax.random.key(3)
    out = fetch({"k": key, "x": jnp.arange(3.0), "keys": jax.random.split(key, 4)})
    np.testing.assert_array_equal(out["x"], [0.0, 1.0, 2.0])
    assert jax.dtypes.issubdtype(out["k"].dtype, jax.dtypes.extended)
    np.testing.assert_array_equal(
        jax.random.key_data(out["k"]), jax.random.key_data(key)
    )
    assert out["keys"].shape == (4,)
    np.testing.assert_array_equal(
        jax.random.normal(out["keys"][1], (2,)),
        jax.random.normal(jax.random.split(key, 4)[1], (2,)),
    )


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them, so the
    test process keeps its own (disabled) compile cache."""
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.__setitem__(name, value)
    )
    return calls


def test_cache_follows_env_var(tmp_path, monkeypatch, config_updates):
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert cache.enable_persistent_cache() == env_dir
    # JAX reads the variable itself: no other directory is set in code.
    assert "jax_compilation_cache_dir" not in config_updates
    assert (tmp_path / "from_env").is_dir()


def test_cache_default_is_fixed_checkout_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_persistent_cache()
    assert path == cache.DEFAULT_DIR
    assert path.endswith(".jax_cache")
    assert config_updates["jax_compilation_cache_dir"] == cache.DEFAULT_DIR
    # Same answer on every call: no pid, time or temporary name.
    assert cache.enable_persistent_cache() == path


def test_cache_explicit_dir_wins(tmp_path, monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    explicit = str(tmp_path / "explicit")
    assert cache.enable_persistent_cache(explicit) == explicit
    assert config_updates["jax_compilation_cache_dir"] == explicit
