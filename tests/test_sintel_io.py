"""Round-trips for the Sintel auxiliary formats (sintel_io.py parity) and a
solver determinism check."""

import numpy as np

from arap_flow.io import sintel


def test_depth_roundtrip(tmp_path):
    d = np.random.default_rng(0).standard_normal((14, 17)).astype(np.float32)
    p = tmp_path / "x.dpt"
    sintel.depth_write(p, d)
    np.testing.assert_array_equal(sintel.depth_read(p), d)


def test_disparity_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 500, (10, 12))
    p = tmp_path / "x.png"
    sintel.disparity_write(p, d, bitdepth=32)
    back = sintel.disparity_read(p)
    assert np.abs(back - d).max() < 1.0 / 2 ** 13


def test_cam_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    M = rng.standard_normal((3, 3))
    N = rng.standard_normal((3, 4))
    p = tmp_path / "x.cam"
    sintel.cam_write(p, M, N)
    M2, N2 = sintel.cam_read(p)
    np.testing.assert_array_equal(M, M2)
    np.testing.assert_array_equal(N, N2)


def test_segmentation_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 2 ** 20, (9, 11)).astype(np.int32)
    p = tmp_path / "x.png"
    sintel.segmentation_write(p, seg)
    np.testing.assert_array_equal(sintel.segmentation_read(p), seg)


def test_solver_determinism():
    """Same inputs -> bitwise-identical flow across runs. The reference's PCG
    reductions use unordered float atomicAdd (util.t:528-596) and are NOT
    deterministic; ours are (XLA reductions) — a documented improvement."""
    from arap_flow.io.constraints import add_border_pins
    from arap_flow.ops import energy as E
    from arap_flow.ops import solver as S

    H, W = 20, 24
    mask = np.zeros((H, W), np.uint8)
    cons = add_border_pins(np.array([[6, 7, 9, 9]], np.int32), W, H)
    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=50,
                         pcg_iters=50.0)
    flows = []
    for _ in range(2):
        ops = E.build_operands(mask, cons)
        _, flow = S.solve(ops, cfg)
        flows.append(np.asarray(flow))
    np.testing.assert_array_equal(flows[0], flows[1])


def test_imagedump_roundtrip(tmp_path):
    from arap_flow.io.imagedump import imagedump_read, imagedump_write

    rng = np.random.default_rng(5)
    img = rng.standard_normal((7, 9, 2)).astype(np.float32)
    p = tmp_path / "x.imagedump"
    imagedump_write(p, img)
    np.testing.assert_array_equal(imagedump_read(p), img)
    # header layout: w, h, c, dtype=0
    hdr = np.fromfile(p, np.int32, 4)
    np.testing.assert_array_equal(hdr, [9, 7, 2, 0])
