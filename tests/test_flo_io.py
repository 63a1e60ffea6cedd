"""Tests for .flo IO: byte-compatibility and round-trips against the reference
format (sintel_io.py:26-73) and the shipped cat512 golden flow."""

import numpy as np
import pytest

from arap_flow.io import flo


def test_roundtrip_random(tmp_path):
    rng = np.random.default_rng(0)
    uv = rng.standard_normal((33, 47, 2)).astype(np.float32)
    p = tmp_path / "x.flo"
    flo.flow_write(p, uv)
    u, v = flo.flow_read(p)
    np.testing.assert_array_equal(u, uv[:, :, 0])
    np.testing.assert_array_equal(v, uv[:, :, 1])


def test_roundtrip_separate_uv(tmp_path):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((16, 24)).astype(np.float32)
    v = rng.standard_normal((16, 24)).astype(np.float32)
    p = tmp_path / "x.flo"
    flo.flow_write(p, u, v)
    u2, v2 = flo.flow_read(p)
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(v, v2)


def test_byte_layout(tmp_path):
    """File bytes must be: 'PIEH', w, h, interleaved rows — main.cpp:53-75 layout."""
    uv = np.zeros((2, 3, 2), dtype=np.float32)
    uv[0, 0] = [1.5, -2.5]
    uv[1, 2] = [3.0, 4.0]
    data = flo.flow_encode(uv)
    assert data[:4] == b"PIEH"
    assert np.frombuffer(data, np.float32, 1)[0] == np.float32(202021.25)
    w = np.frombuffer(data, np.int32, 1, 4)[0]
    h = np.frombuffer(data, np.int32, 1, 8)[0]
    assert (w, h) == (3, 2)
    body = np.frombuffer(data, np.float32, offset=12)
    assert body.shape == (12,)
    # row 0: (u00,v00,u01,v01,u02,v02)
    np.testing.assert_array_equal(body[:6], [1.5, -2.5, 0, 0, 0, 0])
    np.testing.assert_array_equal(body[6:], [0, 0, 0, 0, 3.0, 4.0])


def test_bad_tag_rejected(tmp_path):
    p = tmp_path / "bad.flo"
    p.write_bytes(b"XXXX" + b"\x00" * 20)
    with pytest.raises(ValueError):
        flo.flow_read(p)


def test_golden_cat512_read_and_reencode(cat512_warp):
    """The shipped cat512_iFlo.flo must decode, and re-encoding must be
    byte-identical (proves our writer matches the reference's on real data)."""
    u, v = flo.flow_read(cat512_warp["flo"])
    assert u.shape == (512, 512)
    assert np.isfinite(u).all() and np.isfinite(v).all()
    reenc = flo.flow_encode(np.dstack([u, v]))
    original = cat512_warp["flo"].read_bytes()
    assert reenc == original
