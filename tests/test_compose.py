"""Device-side segment composition must match the reference flatten() semantics
(para_gen.py:136-175): later segments overwrite where their warped mask != 0."""

import jax.numpy as jnp
import numpy as np

from arap_flow.ops.compose import add_background, compose_segments


def test_compose_segments_last_write_wins():
    rng = np.random.default_rng(0)
    S, H, W = 3, 10, 12
    flows = rng.standard_normal((S, 2, H, W)).astype(np.float32)
    rgbs = rng.integers(0, 255, (S, 3, H, W)).astype(np.float32)
    masks = np.zeros((S, H, W), np.float32)
    masks[0, :, :6] = 255
    masks[1, 2:7] = 255
    masks[2, 5:, 8:] = 255

    flow, rgb, mask = compose_segments(
        jnp.asarray(flows), jnp.asarray(rgbs), jnp.asarray(masks)
    )

    # reference sequential semantics
    ef, er, em = flows[0].copy(), rgbs[0].copy(), masks[0].copy()
    for i in (1, 2):
        ob = masks[i] != 0
        ef[:, ob] = flows[i][:, ob]
        er[:, ob] = rgbs[i][:, ob]
        em[ob] = masks[i][ob]
    np.testing.assert_allclose(np.asarray(flow), ef)
    np.testing.assert_allclose(np.asarray(rgb), er)
    np.testing.assert_allclose(np.asarray(mask), em)


def test_add_background():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (3, 6, 7)).astype(np.float32)
    bg = rng.integers(0, 255, (3, 6, 7)).astype(np.float32)
    mask = np.zeros((6, 7), np.float32)
    mask[2:4] = 255
    out = np.asarray(add_background(jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(bg)))
    np.testing.assert_allclose(out[:, 2:4], rgb[:, 2:4])
    np.testing.assert_allclose(out[:, 0], bg[:, 0])
