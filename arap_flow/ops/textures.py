"""Procedural random-texture synthesis on device (texture_gen.py replacement).

The reference renders random procedural materials with Blender Cycles
(texture_gen.py: Brick/Checker/Magic/Musgrave/Noise/Voronoi/Wave texture nodes
plus a random point light, 1280×720, texture_gen.py:175-281, 311-326). This
module synthesises the same texture families directly in JAX — deterministic
from a PRNG key, batchable, and running on the accelerator instead of a
Blender renderer.

Each family returns a scalar field in [0, 1] over the image grid; `render`
maps it through a random 2-color gradient and applies a random point-light
shading falloff (the Cycles lamp analogue).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

FAMILIES = ("brick", "checker", "magic", "musgrave", "noise", "voronoi", "wave")


def _grid(H, W):
    gy = jnp.arange(H, dtype=jnp.float32)[:, None] * jnp.ones((1, W), jnp.float32)
    gx = jnp.arange(W, dtype=jnp.float32)[None, :] * jnp.ones((H, 1), jnp.float32)
    return gx, gy


def _hash01(ix: jnp.ndarray, iy: jnp.ndarray, salt: jnp.ndarray) -> jnp.ndarray:
    """Cheap lattice hash -> [0,1) floats (deterministic, vectorised)."""
    h = (
        ix.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
        ^ iy.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35)
        ^ salt.astype(jnp.uint32) * jnp.uint32(0x27D4EB2F)
    )
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * jnp.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    return h.astype(jnp.float32) / jnp.float32(2 ** 32)


def _value_noise(gx, gy, scale, salt):
    """Bilinear value noise at a given lattice scale."""
    x = gx / scale
    y = gy / scale
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = x - ix
    fy = y - iy
    # smoothstep
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    v00 = _hash01(ix, iy, salt)
    v01 = _hash01(ix + 1, iy, salt)
    v10 = _hash01(ix, iy + 1, salt)
    v11 = _hash01(ix + 1, iy + 1, salt)
    return (
        v00 * (1 - ux) * (1 - uy)
        + v01 * ux * (1 - uy)
        + v10 * (1 - ux) * uy
        + v11 * ux * uy
    )


def _fbm(gx, gy, scale, salt, octaves=5, gain=0.5):
    out = jnp.zeros_like(gx)
    amp = 1.0
    norm = 0.0
    for o in range(octaves):
        out = out + amp * _value_noise(gx, gy, scale / (2.0 ** o), salt + o)
        norm += amp
        amp *= gain
    return out / norm


def noise_texture(key, H, W):
    """Cycles Noise texture analogue: fbm with random scale/detail
    (texture_gen.py NoiseTexture: scale 0.5-7, detail 0-10)."""
    k1, k2 = jax.random.split(key)
    scale = jax.random.uniform(k1, (), minval=20.0, maxval=200.0)
    salt = jax.random.randint(k2, (), 0, 10000)
    gx, gy = _grid(H, W)
    return _fbm(gx, gy, scale, salt)


def musgrave_texture(key, H, W):
    """Musgrave analogue: ridged multifractal of value noise."""
    k1, k2 = jax.random.split(key)
    scale = jax.random.uniform(k1, (), minval=40.0, maxval=300.0)
    salt = jax.random.randint(k2, (), 0, 10000)
    gx, gy = _grid(H, W)
    out = jnp.zeros_like(gx)
    amp = 1.0
    for o in range(5):
        n = _value_noise(gx, gy, scale / (2.0 ** o), salt + 17 + o)
        out = out + amp * (1.0 - jnp.abs(2.0 * n - 1.0)) ** 2
        amp *= 0.55
    return out / 2.2


def checker_texture(key, H, W):
    """Checker with random scale and random distortion (texture_gen.py
    CheckerTexture: scale 1-15)."""
    k1, k2 = jax.random.split(key)
    size = jax.random.uniform(k1, (), minval=20.0, maxval=120.0)
    salt = jax.random.randint(k2, (), 0, 10000)
    gx, gy = _grid(H, W)
    wob = (_value_noise(gx, gy, 80.0, salt) - 0.5) * size * 0.3
    cx = jnp.floor((gx + wob) / size).astype(jnp.int32)
    cy = jnp.floor((gy + wob) / size).astype(jnp.int32)
    return ((cx + cy) % 2).astype(jnp.float32)


def brick_texture(key, H, W):
    """Brick analogue: staggered rows with mortar lines (texture_gen.py
    BrickTexture: random offsets/squash)."""
    k1, k2, k3 = jax.random.split(key, 3)
    bh = jax.random.uniform(k1, (), minval=20.0, maxval=60.0)
    bw = bh * jax.random.uniform(k2, (), minval=1.5, maxval=3.5)
    mortar = 0.08
    salt = jax.random.randint(k3, (), 0, 10000)
    gx, gy = _grid(H, W)
    row = jnp.floor(gy / bh)
    offs = jnp.where(row.astype(jnp.int32) % 2 == 0, 0.0, bw / 2)
    fx = (gx + offs) / bw
    fy = gy / bh
    mx = jnp.abs(fx - jnp.floor(fx) - 0.5) > (0.5 - mortar)
    my = jnp.abs(fy - jnp.floor(fy) - 0.5) > (0.5 - mortar)
    shade = _hash01(
        jnp.floor(fx).astype(jnp.int32), row.astype(jnp.int32), salt
    )
    return jnp.where(mx | my, 0.0, 0.3 + 0.7 * shade)


def voronoi_texture(key, H, W):
    """Voronoi cell-distance texture (texture_gen.py VoronoiTexture)."""
    k1, k2 = jax.random.split(key)
    scale = jax.random.uniform(k1, (), minval=40.0, maxval=160.0)
    salt = jax.random.randint(k2, (), 0, 10000)
    gx, gy = _grid(H, W)
    x = gx / scale
    y = gy / scale
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    best = jnp.full(gx.shape, jnp.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            px = ix + dx + _hash01(ix + dx, iy + dy, salt)
            py = iy + dy + _hash01(ix + dx, iy + dy, salt + 1)
            d = (x - px) ** 2 + (y - py) ** 2
            best = jnp.minimum(best, d)
    return jnp.clip(jnp.sqrt(best), 0.0, 1.0)


def wave_texture(key, H, W):
    """Wave texture: banded sin with fbm distortion (texture_gen.py
    WaveTexture: bands/rings + distortion 0-20)."""
    k1, k2, k3 = jax.random.split(key, 3)
    scale = jax.random.uniform(k1, (), minval=30.0, maxval=150.0)
    distort = jax.random.uniform(k2, (), minval=0.0, maxval=8.0)
    salt = jax.random.randint(k3, (), 0, 10000)
    gx, gy = _grid(H, W)
    base = (gx + gy * 0.3) / scale
    d = _fbm(gx, gy, scale, salt) * distort
    return 0.5 + 0.5 * jnp.sin((base + d) * 2.0 * jnp.pi)


def magic_texture(key, H, W):
    """Magic texture analogue: iterated trig swirl (Blender's magic node)."""
    k1, k2 = jax.random.split(key)
    scale = jax.random.uniform(k1, (), minval=60.0, maxval=250.0)
    turb = jax.random.uniform(k2, (), minval=1.0, maxval=3.0)
    gx, gy = _grid(H, W)
    x = gx / scale * 2 * jnp.pi
    y = gy / scale * 2 * jnp.pi
    a = jnp.sin(x + jnp.sin(y * turb))
    b = jnp.cos(y + jnp.cos(x * turb) * turb)
    for _ in range(2):
        a, b = jnp.sin(a * turb + b), jnp.cos(b * turb - a)
    return 0.5 + 0.25 * (a + b)


_FAMILY_FNS = {
    "brick": brick_texture,
    "checker": checker_texture,
    "magic": magic_texture,
    "musgrave": musgrave_texture,
    "noise": noise_texture,
    "voronoi": voronoi_texture,
    "wave": wave_texture,
}


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    """Piecewise sRGB EOTF (texture_gen.py:142-149): Blender's HSV color picker
    works in sRGB, so sampled colors must be linearised before shading."""
    c = jnp.asarray(c, jnp.float32)
    a = 0.055
    return jnp.where(c <= 0.04045, c / 12.92, ((c + a) / (1 + a)) ** 2.4)


def linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    """Inverse of srgb_to_linear (texture_gen.py:133-140): applied to the
    shaded linear image on output, mirroring the Cycles PNG color transform."""
    c = jnp.asarray(c, jnp.float32)
    a = 0.055
    return jnp.where(
        c <= 0.0031308, 12.92 * c, (1 + a) * jnp.maximum(c, 1e-12) ** (1 / 2.4) - a
    )


def hsv_to_rgb(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """colorsys.hsv_to_rgb, vectorised; returns a (..., 3) stack."""
    h = jnp.asarray(h, jnp.float32)
    k = (jnp.stack([jnp.full_like(h, 5.0), jnp.full_like(h, 3.0),
                    jnp.full_like(h, 1.0)], axis=-1) + h[..., None] * 6.0) % 6.0
    f = jnp.clip(jnp.minimum(k, jnp.minimum(4.0 - k, 1.0)), 0.0, 1.0)
    return jnp.asarray(v, jnp.float32)[..., None] * (
        1.0 - jnp.asarray(s, jnp.float32)[..., None] * f
    )


def _random_color_linear(key) -> jnp.ndarray:
    """random_color() (texture_gen.py:163-173): uniform hue, uniform
    saturation, value=1, in sRGB space, then linearised for shading."""
    kh, ks = jax.random.split(key)
    h = jax.random.uniform(kh, ())
    s = jax.random.uniform(ks, ())
    return srgb_to_linear(hsv_to_rgb(h, s, jnp.float32(1.0)))


def _lamp_color_linear(key) -> jnp.ndarray:
    """Lamp color (texture_gen.py:99-100, :318-320): uniform hue, saturation
    clamp(N(0.35, 0.25), 0, 1), value=1, sRGB -> linear."""
    kh, ks = jax.random.split(key)
    h = jax.random.uniform(kh, ())
    s = jnp.clip(0.35 + 0.25 * jax.random.normal(ks, ()), 0.0, 1.0)
    return srgb_to_linear(hsv_to_rgb(h, s, jnp.float32(1.0)))


@partial(jax.jit, static_argnames=("family", "H", "W"))
def render(key, family: str, H: int = 720, W: int = 1280) -> jnp.ndarray:
    """Render one (H, W, 3) uint8 texture image: family field -> random 2-color
    gradient (HSV-sampled in sRGB, shaded in linear RGB) -> random point-light
    falloff with a random lamp color (the Cycles lamp analogue,
    texture_gen.py:43-56, 311-320) -> linear_to_srgb output transform."""
    kf, kc1, kc2, kl = jax.random.split(key, 4)
    field = jnp.clip(_FAMILY_FNS[family](kf, H, W), 0.0, 1.0)
    c1 = _random_color_linear(kc1)
    c2 = _random_color_linear(kc2)
    rgb = field[..., None] * c1 + (1.0 - field[..., None]) * c2
    # point light: random position above the plane, inverse-square-ish falloff
    lx = jax.random.uniform(kl, (), minval=0.0, maxval=float(W))
    ly = jax.random.uniform(
        jax.random.fold_in(kl, 1), (), minval=0.0, maxval=float(H)
    )
    lz = jax.random.uniform(
        jax.random.fold_in(kl, 2), (), minval=0.4, maxval=1.2
    ) * W
    lamp = _lamp_color_linear(jax.random.fold_in(kl, 3))
    gx, gy = _grid(H, W)
    d2 = ((gx - lx) ** 2 + (gy - ly) ** 2 + lz ** 2) / (lz ** 2)
    light = jnp.clip(1.6 / d2, 0.25, 1.6)
    out = jnp.clip(rgb * lamp * light[..., None], 0.0, 1.0)
    return (jnp.clip(linear_to_srgb(out), 0.0, 1.0) * 255.0).astype(jnp.uint8)


def random_texture(key, H: int = 720, W: int = 1280) -> jnp.ndarray:
    """Render with a uniformly random family (host chooses the family so the
    jitted renderer stays shape/branch static)."""
    import numpy as np

    fam = FAMILIES[int(np.asarray(jax.random.randint(key, (), 0, len(FAMILIES))))]
    return render(jax.random.fold_in(key, 7), fam, H, W)
