"""Host-side native runtime: reference-exact forward rasterizer and fast codecs.

The exact rasterizer exists in two implementations with identical semantics:
- a C++ extension (``_arap_native``) for production host fallback/verification,
- a vectorised numpy implementation (``host_raster``) used as the build-free
  fallback and the exactness oracle in tests.

Device-side (XLA) rasterization lives in ``arap_flow.ops.rasterize``.
"""

from .host_raster import rasterize_warp_exact  # noqa: F401
