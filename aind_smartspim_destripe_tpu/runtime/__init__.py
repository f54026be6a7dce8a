"""Streaming host<->device runtime: pipeline, tracing, journal."""

import os

# Fixed in-checkout cache directory (listed in .gitignore): the path is part
# of the persistent cache's key, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is configured here; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR` inside the checkout. Programs whose compile
    takes at least ``min_compile_time_secs`` are cached in both cases."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    return cache_dir
