"""Native data-path extension: repack correctness + pool recycling."""

import numpy as np
import pytest

from mpv_frame_interpolator import native


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
class TestRepack:
    def test_roundtrip(self, dtype):
        rng = np.random.default_rng(0)
        hi = 255 if dtype == np.uint8 else 65535
        u = rng.integers(0, hi, (54, 96)).astype(dtype)
        v = rng.integers(0, hi, (54, 96)).astype(dtype)
        out = np.empty((54, 192), dtype)
        native.interleave_chroma_into(u, v, out)
        assert np.array_equal(out[:, 0::2], u)
        assert np.array_equal(out[:, 1::2], v)
        u2, v2 = np.empty_like(u), np.empty_like(v)
        native.deinterleave_chroma_into(out, u2, v2)
        assert np.array_equal(u2, u) and np.array_equal(v2, v)


class TestFramePool:
    def test_recycles(self):
        pool = native.FramePool()
        a = pool.get((64, 64), np.uint8)
        a[:] = 7
        pool.give_back(a)
        b = pool.get((64, 64), np.uint8)
        assert b.shape == (64, 64)
        if native.HAVE_NATIVE:
            assert pool.stats()["hits"] == 1

    def test_different_sizes(self):
        pool = native.FramePool()
        a = pool.get((16, 16), np.uint8)
        pool.give_back(a)
        c = pool.get((32, 32), np.uint16)
        assert c.nbytes == 32 * 32 * 2

    def test_give_back_by_buffer_address(self):
        pool = native.FramePool()
        a = pool.get((8, 8), np.uint8)
        addr = a.__array_interface__["data"][0]
        pool.give_back(a)
        if native.HAVE_NATIVE:
            b = pool.get((8, 8), np.uint8)
            assert b.__array_interface__["data"][0] == addr  # recycled
