"""Zero-padded stencil shifts over (..., H, W) arrays.

The ARAP energy couples each pixel to its 4-neighborhood (arap_plan.t:14). The
layout is row-major planes with W contiguous; neighbor access is a pad+slice that XLA fuses into the consuming elementwise op — the
equivalent of the reference's guarded CUDA texture loads (o.t:436-634) without
materialising anything.
"""

from __future__ import annotations

import jax.numpy as jnp

# Stencil directions as (dy, dx); the plan's {(1,0),(-1,0),(0,1),(0,-1)} offsets
# are in (x, y) notation (arap_plan.t:14) — identical set.
DIRS: tuple[tuple[int, int], ...] = ((0, 1), (0, -1), (1, 0), (-1, 0))


def shift(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Return b with b[..., y, x] = a[..., y+dy, x+dx], zero where out of bounds.

    Zero padding implements the plan's InBounds gating (arap_plan.t:17) for free
    when combined with multiplicative masks.
    """
    H, W = a.shape[-2], a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [
        (max(-dy, 0), max(dy, 0)),
        (max(-dx, 0), max(dx, 0)),
    ]
    ap = jnp.pad(a, pad)
    # After padding by max(-d,0) on the low side, index y maps to padded y+max(-dy,0);
    # the neighbor y+dy maps to padded y+dy+max(-dy,0).
    y0 = dy + max(-dy, 0)
    x0 = dx + max(-dx, 0)
    sl = [slice(None)] * (a.ndim - 2) + [slice(y0, y0 + H), slice(x0, x0 + W)]
    return ap[tuple(sl)]
