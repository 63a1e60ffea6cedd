"""chip_smoke.py off the GPU: it refuses to run, and its plain-reference
comparator holds a tiny batched multseg run to the stated tolerance."""

import os
import os.path as osp
import subprocess
import sys

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs 1 GPU" in r.stderr


def _two_object_tree(root, H=96, W=160, n_frames=3):
    from arap_flow.io.image import save_image

    rng = np.random.default_rng(3)
    tex = np.kron(rng.uniform(60, 255, (H // 8 + 2, W // 8 + 2, 3)),
                  np.ones((8, 8, 1)))[:H, :W].astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    for sub in ("orgRGB", "orgMasks"):
        os.makedirs(osp.join(root, sub, "seq0"), exist_ok=True)
    for t in range(n_frames):
        img = (tex[::-1, ::-1] // 3).copy()
        mask = np.zeros((H, W), np.uint8)
        for sid, (y0, x0, dy, dx, h, w) in enumerate(
                ((14, 12, 2, 3, 34, 44), (52, 96, -1, -2, 30, 40)), 1):
            ob = ((yy >= y0 + dy * t) & (yy < y0 + dy * t + h)
                  & (xx >= x0 + dx * t) & (xx < x0 + dx * t + w))
            img[ob] = tex[yy[ob] - dy * t, xx[ob] - dx * t]
            mask[ob] = sid
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


def test_reference_comparator_tiny(tmp_path):
    from arap_flow.ops.solver import SolverConfig

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _two_object_tree(data)
    # PCG deep enough to converge on these small segments, so float32 and
    # float64 agree to ~1e-5 px and what is left is the 1/64 px flow
    # quantisation (a 40-iteration budget stops short of convergence, and
    # the two precisions then part by up to ~0.09 px)
    cfg = SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=200,
                       pcg_iters=200.0)
    assert chip_smoke._run_pipeline(data, out, "batched", cfg) == 2
    stats = chip_smoke.compare_to_reference(data, out, cfg)
    assert stats["pairs"] == 2
    assert sorted(stats["per_segment"]) == [1, 2]
    assert all(s["pixels"] > 500 for s in stats["per_segment"].values())
    assert stats["mean_epe"] <= chip_smoke.TOL_MEAN, stats
    assert stats["max_epe"] <= chip_smoke.TOL_MAX, stats
    # the comparator sees a wrong product: a 0.1 px shift of one .flo
    from arap_flow.io import flo

    p = osp.join(out, "Flow", "seq0", "00000.flo")
    u, v = flo.flow_read(p)
    flo.flow_write(p, np.stack([u + 0.1, v], -1).astype(np.float32))
    bad = chip_smoke.compare_to_reference(data, out, cfg)
    assert bad["max_epe"] > chip_smoke.TOL_MAX
