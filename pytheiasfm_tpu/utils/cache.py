"""Persistent XLA compilation cache.

The reference is a C++ library: its "compile time" is paid once at build.
A JAX pipeline pays it at trace time in every fresh process, and for the
pipelines here compiling can take most of a cold run's wall-clock. JAX's
persistent compilation cache amortizes that across runs: the second
invocation of any pipeline finds its executables on disk.

Call `enable_persistent_cache()` once, before the first jitted call, from
any entry script (tools/, bench.py, chip_smoke.py). Library code does not call
it implicitly — opting into on-disk state is the application's decision.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
module sets no directory of its own; otherwise the cache lives at the
fixed path `<checkout>/.jax_cache` (a fixed path, because the directory
is part of what a later process must find again).
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_DIR", "enable_persistent_cache"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Enable the on-disk XLA compilation cache. Returns the cache dir:
    `cache_dir` if given, else `$JAX_COMPILATION_CACHE_DIR`, else
    `DEFAULT_DIR`."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = cache_dir or env_dir or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    if path != env_dir:
        jax.config.update("jax_compilation_cache_dir", path)
    # Keep every executable, not only those that took over a second.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
