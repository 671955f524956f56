"""Image-sequence source (demux_mf analog) + full PNG decoder tests.

Reference behaviors covered: mf:// pattern forms (demux_mf.c:parse_mf),
--mf-fps pacing, O(1) seek over the resolved file list, and the image
decoders the sequences ride on (PNG all-filters, PNM, JPEG reuse)."""

import os
import struct
import zlib

import numpy as np
import pytest

from mpv_frame_interpolator.io import mf
from mpv_frame_interpolator.utils.png import (decode_png, encode_png,
                                                  write_png)

rng = np.random.default_rng(7)


# ---------------------------------------------------------------- PNG

def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _filter_row(f, cur, prev, bpp):
    """Forward PNG filter (spec §6) for building test vectors."""
    out = np.empty_like(cur, dtype=np.int32)
    c32, p32 = cur.astype(np.int32), prev.astype(np.int32)
    for i in range(len(cur)):
        a = c32[i - bpp] if i >= bpp else 0
        b = p32[i]
        c = p32[i - bpp] if i >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (c32[i] - pred) & 255
    return out.astype(np.uint8)


def _make_png(px, color_type, filters, plte=None):
    h, w = px.shape[:2]
    ch = 1 if px.ndim == 2 else px.shape[2]
    flat = px.reshape(h, w * ch)
    lines = bytearray()
    prev = np.zeros(w * ch, np.uint8)
    for r in range(h):
        f = filters[r % len(filters)]
        lines.append(f)
        lines += _filter_row(f, flat[r], prev, ch).tobytes()
        prev = flat[r]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if plte is not None:
        out += _chunk(b"PLTE", plte.tobytes())
    # split IDAT in two to exercise multi-chunk reassembly
    z = zlib.compress(bytes(lines))
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return out + _chunk(b"IEND", b"")


def test_png_roundtrip_own_encoder():
    for arr in (rng.integers(0, 256, (13, 17), dtype=np.uint8),
                rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)):
        np.testing.assert_array_equal(decode_png(encode_png(arr)), arr)


@pytest.mark.parametrize("filters", [[1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("ch", [1, 3])
def test_png_all_scanline_filters(filters, ch):
    shape = (11, 14) if ch == 1 else (11, 14, 3)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    got = decode_png(_make_png(px, 0 if ch == 1 else 2, filters))
    np.testing.assert_array_equal(got, px)


def test_png_rgba_and_gray_alpha_drop_alpha():
    rgba = rng.integers(0, 256, (6, 7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_make_png(rgba, 6, [0, 4])),
                                  rgba[:, :, :3])
    ga = rng.integers(0, 256, (6, 7, 2), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_make_png(ga, 4, [2])),
                                  ga[:, :, 0])


def test_png_palette():
    plte = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (9, 5), dtype=np.uint8)
    got = decode_png(_make_png(idx, 3, [1, 3], plte=plte))
    np.testing.assert_array_equal(got, plte[idx])


def test_png_cross_check_pil():
    PIL = pytest.importorskip("PIL.Image")
    import io as _io
    for mode, shape in (("L", (33, 41)), ("RGB", (24, 31, 3))):
        # gradient + noise makes PIL's adaptive filter heuristic pick
        # different filters per row (exercises the unfilter paths on
        # real encoder output)
        base = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 256
        arr = ((base[..., None] if len(shape) == 3 else base)
               + rng.integers(0, 32, shape)).astype(np.uint8)
        buf = _io.BytesIO()
        PIL.fromarray(arr, mode).save(buf, format="PNG")
        np.testing.assert_array_equal(decode_png(buf.getvalue()), arr)


@pytest.mark.parametrize("mutate", [
    lambda d: d[:20],                              # truncated
    lambda d: b"\x89PNG\r\n\x1a\n" + d[8:28],      # chopped chunks
    lambda d: d.replace(b"IDAT", b"IDAW", 1),      # no pixel data
    lambda d: d[:40] + bytes([255]) + d[41:],      # corrupt zlib/filters
    lambda d: b"junk" + d,
])
def test_png_malformed_raises(mutate):
    good = encode_png(rng.integers(0, 256, (5, 5), dtype=np.uint8))
    with pytest.raises(ValueError):
        decode_png(mutate(good))


def test_png_zlib_bomb_rejected_without_inflation():
    """A crafted tiny-header PNG whose IDAT inflates to ~870MB must be
    rejected by the capped decompressor BEFORE allocating (ADVICE r3:
    OOM/DoS vector on the 1-core host)."""
    import resource
    bomb = zlib.compress(b"\x00" * (870 * 1024 * 1024), 9)
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", bomb) + _chunk(b"IEND", b""))
    assert len(data) < 2 * 1024 * 1024
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with pytest.raises(ValueError):
        decode_png(data)
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on linux; the decode must not have ballooned
    assert after - before < 100 * 1024


def test_png_rejects_interlace_and_16bit():
    px = rng.integers(0, 256, (4, 4), dtype=np.uint8)
    data = bytearray(_make_png(px, 0, [0]))
    data[8 + 8 + 12] = 1  # IHDR interlace byte
    with pytest.raises(ValueError):
        decode_png(bytes(data))


# ---------------------------------------------------------------- PNM

def test_pnm_p5_p6():
    g = rng.integers(0, 256, (6, 9), dtype=np.uint8)
    data = b"P5\n# comment\n9 6\n255\n" + g.tobytes()
    np.testing.assert_array_equal(mf._read_pnm(data), g)
    c = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    data = b"P6 5 4 255 " + c.tobytes()
    np.testing.assert_array_equal(mf._read_pnm(data), c)
    with pytest.raises(ValueError):
        mf._read_pnm(b"P5\n9 6\n255\n" + g.tobytes()[:-3])
    with pytest.raises(ValueError):
        mf._read_pnm(b"P7\n1 1\n255\n\x00")


# ------------------------------------------------- pattern expansion

def _write_seq(tmp_path, names, size=(16, 12)):
    paths = []
    for i, n in enumerate(names):
        arr = np.full((size[1], size[0]), i * 10, np.uint8)
        paths.append(write_png(str(tmp_path / n), arr))
    return paths


def test_expand_glob_natural_sort(tmp_path):
    _write_seq(tmp_path, ["f_10.png", "f_9.png", "f_1.png"])
    got = mf.expand_mf_pattern(f"mf://{tmp_path}/f_*.png")
    assert [os.path.basename(p) for p in got] == \
        ["f_1.png", "f_9.png", "f_10.png"]


def test_expand_printf_sequence(tmp_path):
    _write_seq(tmp_path, [f"s{k:04d}.png" for k in range(5)])
    got = mf.expand_mf_pattern(str(tmp_path / "s%04d.png"))
    assert len(got) == 5
    # sequences starting at 1 are found too
    _write_seq(tmp_path, [f"t{k:02d}.png" for k in range(1, 4)])
    assert len(mf.expand_mf_pattern(str(tmp_path / "t%02d.png"))) == 3


def test_expand_printf_gap_tolerance(tmp_path):
    """Reference demux_mf.c probes while error_count < 5 CUMULATIVELY:
    sequences starting at index 2-4 are found, and a single mid-sequence
    gap does not end playback."""
    _write_seq(tmp_path, [f"g{k:02d}.png" for k in (2, 3, 5, 6)])
    got = mf.expand_mf_pattern(str(tmp_path / "g%02d.png"))
    assert [os.path.basename(p) for p in got] == \
        ["g02.png", "g03.png", "g05.png", "g06.png"]
    # starting at 4 (4 leading misses < 5) is still found
    _write_seq(tmp_path, ["h04.png", "h05.png"])
    assert len(mf.expand_mf_pattern(str(tmp_path / "h%02d.png"))) == 2
    # starting at 5 is not (reference gives up at 5 cumulative misses)
    _write_seq(tmp_path, ["i05.png"])
    assert mf.expand_mf_pattern(str(tmp_path / "i%02d.png")) == []


def test_expand_printf_bad_specs_raise(tmp_path):
    """Multiple or non-d specifiers must raise MFError (graceful CLI
    failure), not TypeError from the % formatter (ADVICE r3)."""
    for bad in ("a%04d_%02d.png", "a%sb%04d.png", "x%fy%d.png"):
        with pytest.raises(mf.MFError):
            mf.expand_mf_pattern(str(tmp_path / bad))
    # %% escape plus one %d is fine
    _write_seq(tmp_path, ["100%_0.png", "100%_1.png"])
    got = mf.expand_mf_pattern(str(tmp_path / "100%%_%d.png"))
    assert len(got) == 2


def test_expand_magicless_prefix_globs(tmp_path):
    """demux_mf.c appends '*' to a pattern with no wildcard: a bare
    prefix expands; an existing single file stays a single file."""
    _write_seq(tmp_path, ["pre_1.png", "pre_2.png", "pre_10.png"])
    got = mf.expand_mf_pattern(f"mf://{tmp_path}/pre_")
    assert [os.path.basename(p) for p in got] == \
        ["pre_1.png", "pre_2.png", "pre_10.png"]
    assert mf.expand_mf_pattern(str(tmp_path / "pre_1.png")) == \
        [str(tmp_path / "pre_1.png")]


def test_expand_list_and_comma(tmp_path):
    paths = _write_seq(tmp_path, ["a.png", "b.png"])
    lst = tmp_path / "frames.txt"
    lst.write_text("# header\na.png\n\nb.png\n")
    assert mf.expand_mf_pattern(f"mf://@{lst}") == [
        str(tmp_path / "a.png"), str(tmp_path / "b.png")]
    assert mf.expand_mf_pattern(",".join(paths)) == paths


# ---------------------------------------------------------- MFReader

def test_mf_reader_sequence_and_seek(tmp_path):
    _write_seq(tmp_path, [f"f_{k}.png" for k in range(6)])
    r = mf.MFReader(f"mf://{tmp_path}/f_*.png", fps=2.0)
    assert (r.width, r.height, r.n_frames()) == (16, 12, 6)
    frames = list(r)
    assert len(frames) == 6
    assert frames[0].nominal_fps == 2.0
    assert abs(frames[3].pts - 1.5) < 1e-9
    # luma tracks the per-frame fill (BT.709 limited-range mapping)
    lum = [int(f.y.mean()) for f in frames]
    assert lum == sorted(lum) and lum[0] < lum[-1]
    # O(1) index seek
    got = r.seek_pts(2.0)
    assert abs(got - 2.0) < 1e-9
    rest = list(r)
    assert len(rest) == 2 and abs(rest[0].pts - 2.0) < 1e-9


def test_mf_reader_odd_and_mixed_geometry(tmp_path):
    write_png(str(tmp_path / "a.png"),
              rng.integers(0, 256, (11, 15), dtype=np.uint8))  # odd: padded
    write_png(str(tmp_path / "b.png"),
              rng.integers(0, 256, (24, 32), dtype=np.uint8))  # scaled down
    r = mf.MFReader(f"{tmp_path}/a.png,{tmp_path}/b.png", fps=1.0)
    frames = list(r)
    assert (r.width, r.height) == (16, 12)
    assert all(f.fmt.width == 16 and f.fmt.height == 12 for f in frames)
    assert len(frames) == 2


def test_mf_reader_jpeg_and_pnm(tmp_path):
    pytest.importorskip("PIL.Image")
    from PIL import Image
    arr = np.zeros((12, 16, 3), np.uint8)
    arr[:, :, 0] = 200
    Image.fromarray(arr, "RGB").save(str(tmp_path / "x0.jpg"), quality=95)
    with open(tmp_path / "x1.ppm", "wb") as fh:
        fh.write(b"P6\n16 12\n255\n" + arr.tobytes())
    r = mf.MFReader(f"mf://{tmp_path}/x*.*", fps=1.0)
    frames = list(r)
    assert len(frames) == 2
    # same red image through both codecs; each path has its own correct
    # matrix (JPEG = JFIF BT.601 full-range: 0.299*200 = 60; PNM rides
    # rgb_to_frame's BT.709 limited: 16 + 0.2126*200*219/255 = 52)
    assert abs(int(frames[0].y.mean()) - 60) <= 2
    assert abs(int(frames[1].y.mean()) - 52) <= 2


def test_mf_reader_p010(tmp_path):
    _write_seq(tmp_path, ["p.png"])
    r = mf.MFReader(str(tmp_path / "p.png"), fps=1.0, pixfmt="p010")
    f = next(iter(r))
    assert f.y.dtype == np.uint16


def test_mf_errors(tmp_path):
    with pytest.raises(ValueError):
        mf.MFReader(f"mf://{tmp_path}/nothing_*.png")
    with pytest.raises(ValueError):
        mf.MFReader(f"mf://{tmp_path}/a.png,{tmp_path}/missing.png")
    with pytest.raises(ValueError):
        mf.MFReader("mf://", fps=1.0)
    _write_seq(tmp_path, ["ok.png"])
    with pytest.raises(ValueError):
        mf.MFReader(str(tmp_path / "ok.png"), fps=0.0)


def test_mf_cli_routing(tmp_path):
    from mpv_frame_interpolator.cli import build_parser, make_source
    _write_seq(tmp_path, [f"c{k}.png" for k in range(3)])
    parser = build_parser()
    args = parser.parse_args([f"mf://{tmp_path}/c*.png", "--mf-fps", "4"])
    src, w, h = make_source(args)
    assert (w, h) == (16, 12)
    frames = list(src)
    assert len(frames) == 3 and frames[0].nominal_fps == 4.0
    # bare image path routes through mf too (single-image source)
    args = parser.parse_args([str(tmp_path / "c0.png")])
    src, w, h = make_source(args)
    assert len(list(src)) == 1
