"""Deterministic fuzzing of the C++ ring parsers (VERDICT r2 item 8).

The Python-parser fuzz suite (test_fuzz_parsers.py) never touched the
memory-unsafe readers: `Y4MRing` parses FRAME markers from untrusted
bytes in C++ (native/repack.cpp:read_marker / ring_reader) and
`IndexedRing` preads attacker-influenced (offset, size) records.  These
drive both through fd-backed hostile streams -- truncations, giant and
garbage markers, mid-frame EOF, out-of-range and overlapping offsets.
Contract (reference analog fuzzers/fuzzer_load.c): typed error, clean
EOF, or valid frames -- never a crash, hang, or heap smash.  Seeds are
fixed so failures reproduce.
"""

import os
import random
import tempfile

import numpy as np
import pytest

from mpv_frame_interpolator.io import ingest

pytestmark = pytest.mark.skipif(
    not ingest.have_native_ingest(), reason="native extension not built")

W, H = 16, 16
HDR = b"YUV4MPEG2 W16 H16 F24:1 Ip A1:1 C420mpeg2\n"
PAYLOAD = W * H * 3 // 2


def frame_rec(seed=0, marker=b"FRAME\n"):
    body = bytes((seed + i) & 0xFF for i in range(PAYLOAD))
    return marker + body


def drain(data: bytes, max_frames=64):
    """Feed bytes to NativeY4MSource via a real file; returns
    ('ok', n) or ('err', msg).  Never crashes, never hangs (file EOF
    terminates every native read)."""
    with tempfile.NamedTemporaryFile() as tf:
        tf.write(data)
        tf.flush()
        try:
            src = ingest.NativeY4MSource(tf.name, ring_depth=2)
        except Exception as e:  # noqa: BLE001 - header reject is fine
            return ("err", f"open: {e}")
        n = 0
        try:
            for f in src:
                assert f.y.shape == (H, W)
                n += 1
                if f.recycle:
                    f.recycle()
                if n >= max_frames:
                    break
            return ("ok", n)
        except RuntimeError as e:
            return ("err", str(e))
        finally:
            src.close()


class TestFuzzY4MRing:
    def test_valid_stream_baseline(self):
        data = HDR + b"".join(frame_rec(i) for i in range(5))
        assert drain(data) == ("ok", 5)

    def test_truncations(self):
        base = HDR + b"".join(frame_rec(i) for i in range(4))
        for cut in range(len(HDR), len(base), 7):
            kind, info = drain(base[:cut])
            # whole frames parse, a partial tail is corrupt or EOF
            assert kind in ("ok", "err"), info

    def test_mutated_bytes(self):
        r = random.Random(77)
        base = bytearray(HDR + b"".join(frame_rec(i) for i in range(4)))
        for _ in range(4000):
            data = bytearray(base)
            for _ in range(r.randint(1, 8)):
                data[r.randrange(len(data))] = r.randrange(256)
            drain(bytes(data))           # contract: no crash/hang

    def test_hostile_markers(self):
        r = random.Random(1234)
        cases = [
            b"FRAME",                        # no newline, EOF
            b"FRAME " + b"X" * 10_000,       # giant marker line
            b"FRAME\xff\xfe\n",              # binary params
            b"FRAME" + b"\x00" * 300 + b"\n",
            b"NOTFRAME\n",
            b"\n" * 500,
            b"FRAME\n",                      # marker, no payload
        ]
        for _ in range(3000):
            n_pre = r.randint(0, 2)
            data = HDR + b"".join(frame_rec(i) for i in range(n_pre))
            data += cases[r.randrange(len(cases))]
            if r.random() < 0.5:
                data += frame_rec(9)[r.randint(0, PAYLOAD):]
            kind, info = drain(data)
            if kind == "ok":
                assert info >= n_pre or info == 0

    def test_random_garbage_bodies(self):
        r = random.Random(555)
        for _ in range(3000):
            body = bytes(r.getrandbits(8)
                         for _ in range(r.randint(0, 2000)))
            drain(HDR + body)


class TestFuzzIndexedRing:
    """Drives _native.IndexedRing directly with hostile offset tables."""

    def setup_method(self):
        if not hasattr(ingest._native, "IndexedRing"):
            pytest.skip("IndexedRing not built")

    def run_ring(self, payload: bytes, offsets):
        with tempfile.NamedTemporaryFile() as tf:
            tf.write(payload)
            tf.flush()
            ring = ingest._native.IndexedRing(
                tf.file.fileno(), W, H, "i420",
                np.ascontiguousarray(offsets, np.int64))
            bufs = {t: (np.empty((H, W), np.uint8),
                        np.empty((H // 2, W), np.uint8)) for t in range(2)}
            for t, (y, uv) in bufs.items():
                ring.push_free(t, y, uv)
            n = 0
            try:
                while n < 64:
                    tag = ring.pop()
                    if tag is None:
                        return ("ok", n)
                    n += 1
                    ring.push_free(tag, *bufs[tag])
                return ("ok", n)
            except RuntimeError as e:
                return ("err", str(e))
            finally:
                ring.stop()

    def test_valid_baseline(self):
        payload = bytes(PAYLOAD * 3)
        assert self.run_ring(payload, [0, PAYLOAD, 2 * PAYLOAD]) == ("ok", 3)

    def test_hostile_offsets(self):
        r = random.Random(4242)
        payload = bytes(range(256)) * 8          # 2048 bytes < 3 frames
        for _ in range(10_000):
            n_off = r.randint(0, 6)
            offs = []
            for _ in range(n_off):
                roll = r.random()
                if roll < 0.3:
                    offs.append(r.randint(-(1 << 40), 0))      # negative
                elif roll < 0.6:
                    offs.append(r.randint(0, 1 << 41))         # beyond EOF
                else:
                    offs.append(r.randint(0, len(payload)))    # short tail
            kind, info = self.run_ring(payload, offs)
            assert kind in ("ok", "err")

    def test_file_shrunk_mid_stream(self):
        # index promises 8 frames, the file holds 1.5
        payload = bytes(PAYLOAD + PAYLOAD // 2)
        kind, info = self.run_ring(payload,
                                   [i * PAYLOAD for i in range(8)])
        assert kind == "err" or info <= 1
