"""Texture synthesis tests: every family renders deterministically, the sRGB
color pipeline matches the reference's conversions (texture_gen.py:133-163),
and each family's field has its characteristic distribution (so texture
regressions are caught, not just shape/dtype breaks)."""

import colorsys

import jax
import numpy as np
import pytest

from arap_flow.ops.textures import (
    FAMILIES,
    brick_texture,
    checker_texture,
    hsv_to_rgb,
    linear_to_srgb,
    magic_texture,
    musgrave_texture,
    noise_texture,
    render,
    srgb_to_linear,
    voronoi_texture,
    wave_texture,
)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_renders(family):
    img = np.asarray(render(jax.random.PRNGKey(3), family, 72, 96))
    assert img.shape == (72, 96, 3) and img.dtype == np.uint8
    # non-degenerate: some variation and sane dynamic range
    assert img.std() > 4.0, family
    assert img.max() > 40, family


def test_deterministic():
    a = np.asarray(render(jax.random.PRNGKey(5), "voronoi", 48, 64))
    b = np.asarray(render(jax.random.PRNGKey(5), "voronoi", 48, 64))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(render(jax.random.PRNGKey(6), "voronoi", 48, 64))
    assert (a != c).any()


def test_cli(tmp_path):
    from arap_flow.pipeline.texture_gen import main

    main(["--output", str(tmp_path), "--num", "3", "--size", "64", "48",
          "--seed", "1"])
    import os

    files = os.listdir(tmp_path)
    assert len(files) == 3


# ---------------------------------------------------------------------------
# sRGB color pipeline (texture_gen.py:133-163)
# ---------------------------------------------------------------------------


def test_srgb_golden_triple():
    """The reference documents the exact conversion for hsv(.4, .8, 1)
    (texture_gen.py:152-160): srgb_to_linear(hsv_to_rgb(...)) must reproduce
    (0.03310476657088504, 1.0, 0.23302199930143835)."""
    rgb = np.asarray(hsv_to_rgb(0.4, 0.8, 1.0), np.float64)
    np.testing.assert_allclose(rgb, colorsys.hsv_to_rgb(0.4, 0.8, 1.0),
                               atol=1e-6)
    lin = np.asarray(srgb_to_linear(rgb), np.float64)
    np.testing.assert_allclose(
        lin, [0.03310476657088504, 1.0, 0.23302199930143835], atol=2e-6
    )


def test_srgb_roundtrip_and_range():
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    lin = np.asarray(srgb_to_linear(x))
    back = np.asarray(linear_to_srgb(lin))
    np.testing.assert_allclose(back, x, atol=1e-5)
    # both transforms are monotone [0,1] -> [0,1] with the right curvature
    assert (np.diff(lin) > 0).all() and (np.diff(np.asarray(linear_to_srgb(x))) > 0).all()
    assert lin[128] < x[128] < np.asarray(linear_to_srgb(x))[128]


def test_hsv_matches_colorsys():
    rng = np.random.default_rng(0)
    for _ in range(50):
        h, s, v = rng.uniform(size=3)
        got = np.asarray(hsv_to_rgb(h, s, v), np.float64)
        np.testing.assert_allclose(got, colorsys.hsv_to_rgb(h, s, v), atol=1e-6)


def test_render_colors_are_value1_srgb():
    """Material colors are HSV value=1 in sRGB (random_color,
    texture_gen.py:163-173): over a few renders the brightest pixels must
    reach high sRGB values despite lamp tinting."""
    p99 = []
    for seed in range(6):
        img = np.asarray(render(jax.random.PRNGKey(seed), "checker", 64, 64))
        p99.append(np.percentile(img.max(axis=-1), 99))
    assert np.mean(p99) > 120.0, p99


# ---------------------------------------------------------------------------
# Per-family field distributions
# ---------------------------------------------------------------------------

_KEYS = [jax.random.PRNGKey(s) for s in (0, 1, 2, 3)]


def _fields(fn, H=96, W=128):
    return [np.asarray(fn(k, H, W)) for k in _KEYS]


def test_checker_is_bimodal():
    for f in _fields(checker_texture, 192, 256):
        frac_extreme = np.mean((f < 0.05) | (f > 0.95))
        assert frac_extreme > 0.95
        # both cell colors present
        assert np.mean(f > 0.95) > 0.05 and np.mean(f < 0.05) > 0.05


def test_brick_mortar_fraction():
    for f in _fields(brick_texture, 256, 384):
        mortar = np.mean(f == 0.0)
        assert 0.05 < mortar < 0.6, mortar  # mortar lines exist, bricks dominate-ish
        bricks = f[f > 0.0]
        assert bricks.min() >= 0.3 - 1e-6 and bricks.max() <= 1.0 + 1e-6
        # per-brick random shading: multiple distinct brick values
        assert len(np.unique(np.round(bricks, 4))) > 3


def test_noise_fbm_statistics():
    means = [f.mean() for f in _fields(noise_texture)]
    stds = [f.std() for f in _fields(noise_texture)]
    assert 0.3 < np.mean(means) < 0.7
    assert 0.03 < np.mean(stds) < 0.35


def test_musgrave_ridged_nonnegative():
    for f in _fields(musgrave_texture):
        assert f.min() >= 0.0
        assert f.std() > 0.02
        # ridged multifractal: right-skewed with mass near 0
        assert np.percentile(f, 10) < f.mean()


def test_voronoi_distance_field():
    for f in _fields(voronoi_texture, 256, 384):
        assert f.min() < 0.2  # some pixel is near a cell seed
        assert 0.0 <= f.min() and f.max() <= 1.0
        assert f.std() > 0.05


def test_wave_band_distribution():
    """Sinusoidal bands have an arcsine-like value histogram: more mass near
    the 0/1 extremes than in the middle band."""
    extreme, middle = 0.0, 0.0
    for f in _fields(wave_texture):
        extreme += np.mean((f < 0.15) | (f > 0.85))
        middle += np.mean((f > 0.425) & (f < 0.575))
    assert extreme > middle, (extreme, middle)


def test_magic_bounded_and_varied():
    for f in _fields(magic_texture):
        assert f.min() >= -1e-6 and f.max() <= 1.0 + 1e-6
        assert f.std() > 0.05


def test_field_spatial_structure():
    """Every family field is spatially correlated (textures, not white noise):
    neighbor correlation well above zero."""
    from arap_flow.ops.textures import _FAMILY_FNS

    for name, fn in _FAMILY_FNS.items():
        f = np.asarray(fn(jax.random.PRNGKey(9), 96, 128)).astype(np.float64)
        a = f[:, :-1].ravel() - f.mean()
        b = f[:, 1:].ravel() - f.mean()
        denom = np.sqrt((a * a).sum() * (b * b).sum())
        corr = (a * b).sum() / denom if denom > 0 else 1.0
        assert corr > 0.5, (name, corr)
