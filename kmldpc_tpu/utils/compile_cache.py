"""JAX's persistent compilation cache, kept at one fixed place.

Entry points (the CLI, bench.py, chip_smoke.py, tools/campaign.py) call
:func:`enable_compile_cache` before they compile; importing the package
does not.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <repo>/.jax_cache (listed in .gitignore).  A fixed path, never a per-run
# one: a cache that moves is never hit again.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to ``<repo>/.jax_cache``.
    """
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
