"""Tests for constraint filtering and files (reference: para_gen.py:216-223, 466-479,
main.cpp:26-50, 95-101)."""

import numpy as np

from arap_flow.io import constraints as C
from arap_flow.io.image import mask_to_arap, segment_mask_to_arap, ARAP_BG


def test_filter_matches_vectorized_matches_scalar():
    rng = np.random.default_rng(2)
    msk1 = rng.integers(0, 3, size=(40, 50)).astype(np.uint8)
    msk2 = rng.integers(0, 3, size=(40, 50)).astype(np.uint8)
    m = rng.integers(0, 70, size=(500, 4)).astype(np.int32)
    kept, segs = C.filter_matches(m, msk1, msk2)
    expected = [
        row
        for row in m
        if C.valid_constraint(row[0], row[1], row[2], row[3], msk1, msk2)
    ]
    np.testing.assert_array_equal(kept, np.array(expected).reshape(-1, 4))
    for row, s in zip(kept, segs):
        assert msk1[row[1], row[0]] == s


def test_filter_rejects_negative_coords():
    """Stricter than the reference (whose Python indexing would wrap negatives —
    real matcher output is never negative): negatives are dropped."""
    msk = np.ones((10, 10), dtype=np.uint8)
    kept, _ = C.filter_matches(np.array([[-1, 2, 3, 4], [2, 2, 4, 4]]), msk, msk)
    np.testing.assert_array_equal(kept, [[2, 2, 4, 4]])


def test_constraint_file_roundtrip(tmp_path):
    c = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=np.int32)
    p = tmp_path / "c.txt"
    C.write_constraint_file(p, c)
    # header then tuples, exactly like para_gen.py:479
    assert p.read_text().splitlines()[0] == "2"
    c2 = C.read_constraint_file(p)
    np.testing.assert_array_equal(c, c2)


def test_golden_cstr_file_parses(cat512_deform):
    c = C.read_constraint_file(cat512_deform["cstr"])
    assert c.shape == (9, 4)
    assert (c >= 0).all() and (c < 512).all()


def test_border_pins():
    pins = C.add_border_pins(np.zeros((0, 4), np.int32), width=5, height=4)
    assert len(pins) == 2 * 5 + 2 * (4 - 2)
    # identity constraints
    np.testing.assert_array_equal(pins[:, :2], pins[:, 2:])


def test_mask_conversions():
    annot = np.array([[0, 1], [2, 1]], dtype=np.uint8)
    single = mask_to_arap(annot)
    np.testing.assert_array_equal(single, [[ARAP_BG, 0], [0, 0]])
    seg1 = segment_mask_to_arap(annot, 1)
    np.testing.assert_array_equal(seg1, [[ARAP_BG, 0], [ARAP_BG, 0]])
