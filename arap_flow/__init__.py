"""arap_flow — dense non-rigid optical-flow ground-truth generation in JAX, with
the capabilities of lhoangan/arap_flow (arXiv:1812.01946).

The reference stack (Python2 driver -> C++ solver apps -> Opt/Terra JIT -> CUDA) is
rebuilt as one JAX/XLA package:

- ``io``        Middlebury .flo + Sintel-format IO, PNG/mask conventions, constraints.
- ``ops``       Stencil energy derivatives, fused GN+PCG solver loops, rasterization,
                correlation-pyramid matching — the device compute path.
- ``models``    The ARAP deformation problem (energy spec + solve schedule) — the
                framework's flagship "model" (reference: arap_plan.t).
- ``parallel``  Device-mesh sharding of batched solves (replaces the reference's
                multi-GPU process farm, para_gen.py:560-567).
- ``pipeline``  Dataset-generation drivers preserving the reference CLI surface
                (para_gen.py / generate.py / run_arap.py / run_warp.py).
- ``native``    C++ host runtime: reference-exact rasterizer, .flo codec, async IO.
"""

__version__ = "0.1.0"

import os as _os

# fixed path inside the checkout (git-ignored): the cache directory is part
# of every cache key, so it must not move between runs
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compile_cache():
    """Persistent XLA compilation cache. The reference pays its Opt/Terra JIT
    per process per image size (o.t:867-872); a cache hit skips it.

    JAX reads JAX_COMPILATION_CACHE_DIR itself: when it is set, nothing is
    set here. Otherwise the cache lives at COMPILE_CACHE_DIR.
    ARAP_NO_COMPILE_CACHE=1 turns the cache off."""
    if _os.environ.get("ARAP_NO_COMPILE_CACHE") == "1":
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()

from . import io  # noqa: F401
