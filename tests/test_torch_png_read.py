"""The port's PNG reader (``data/png.py`` ``read_png``, the row unfilter
``csrc/png_unfilter.cpp``) against PIL, bit for bit.

The files are written here with zlib alone, each row filtered by the type
the case names (0-4, or all five in turn), interlaced or not, so every
unfilter branch and every (colour type, bit depth) pair the specification
allows is read; PIL (``np.asarray(Image.open(...))``, with
``LOAD_TRUNCATED_IMAGES`` for the files cut short) is the oracle for the
pixels, their dtype and shape (the mode PIL opens the file in) and, through
``data/image.convert``, the palette.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFile

from thermal_semantic_segmentation_torch.data import image as im
from thermal_semantic_segmentation_torch.data import png

ImageFile.LOAD_TRUNCATED_IMAGES = True

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
HW = (13, 19)       # odd: partial Adam7 passes and sub-byte row padding


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, kinds) -> bytes:
    """Filter each row of ``raw`` (rows, row_bytes) by its type in
    ``kinds`` (the specification's forward filters)."""
    out, prior = [], np.zeros(raw.shape[1], np.int64)
    for row, kind in zip(raw.astype(np.int64), kinds):
        left = np.r_[np.zeros(bpp, np.int64), row[:-bpp]]
        upleft = np.r_[np.zeros(bpp, np.int64), prior[:-bpp]]
        pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
                4: _paeth(left, prior, upleft)}[kind]
        out.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _raw_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, width * channels) sample values -> packed row bytes."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(len(samples), -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(len(samples), -1).astype(np.uint8),
                       axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode(samples: np.ndarray, depth: int, colour: int, filters,
           interlace: bool = False, palette: bytes = b"") -> bytes:
    """A PNG of ``samples`` (H, W, channels) with zlib alone; ``filters``
    gives each row's filter type in turn (cycled)."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream, k = [], 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        raw = _raw_rows(sub.reshape(sub.shape[0], -1), depth)
        kinds = [filters[(k + i) % len(filters)] for i in range(len(raw))]
        k += len(raw)
        stream.append(_filter_rows(raw, bpp, kinds))
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                         int(interlace))
    parts = [png._SIGNATURE, _chunk(b"IHDR", header),
             _chunk(b"tEXt", b"Comment\x00ancillary, skipped")]
    if palette:
        parts.append(_chunk(b"PLTE", palette))
    data = zlib.compress(b"".join(stream), 9)
    half = len(data) // 2       # two IDAT chunks
    parts += [_chunk(b"IDAT", data[:half]), _chunk(b"IDAT", data[half:]),
              _chunk(b"IEND", b"")]
    return b"".join(parts)


def _case(colour: int, depth: int, seed: int = 0, hw=HW):
    """(samples, palette bytes) for a (colour, depth) pair."""
    rng = np.random.default_rng(seed + 100 * colour + depth)
    top = (1 << depth) if colour != 3 else min(1 << depth, 12)
    samples = rng.integers(0, top, (*hw, CHANNELS[colour]))
    palette = b""
    if colour == 3:     # 7 colours: the indices past them read black
        palette = rng.integers(0, 256, 7 * 3).astype(np.uint8).tobytes()
    return samples, palette


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_same(data: bytes):
    want = _pil(data)
    got = png.read_png(data)
    assert got.pixels.dtype == want.dtype
    np.testing.assert_array_equal(got.pixels, want)
    if got.palette is not None:     # the palette, through convert('RGB')
        np.testing.assert_array_equal(
            im.convert(got.pixels, "RGB", got.palette),
            np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("colour,depth", KINDS,
                         ids=[f"c{c}d{d}" for c, d in KINDS])
def test_read_png_matches_pil(colour, depth, filters):
    samples, palette = _case(colour, depth)
    kinds = [0, 1, 2, 3, 4] if filters == "mixed" else [int(filters)]
    _assert_same(encode(samples, depth, colour, kinds, palette=palette))


@pytest.mark.parametrize("colour,depth", KINDS,
                         ids=[f"c{c}d{d}" for c, d in KINDS])
def test_read_png_adam7_matches_pil(colour, depth):
    samples, palette = _case(colour, depth, seed=1)
    _assert_same(encode(samples, depth, colour, [0, 1, 2, 3, 4],
                        interlace=True, palette=palette))


def test_modes_pinned():
    """The mode PIL opens each kind in: 1-bit grey '1' (bool), 2- and 4-bit
    grey 'L' scaled to 0..255, 16-bit grey 'I;16', 16-bit colour 8-bit
    (the high byte), 16-bit grey+alpha 'RGBA'."""
    want = {(0, 1): ("1", np.bool_, 2), (0, 2): ("L", np.uint8, 2),
            (0, 4): ("L", np.uint8, 2), (0, 16): ("I;16", np.uint16, 2),
            (2, 16): ("RGB", np.uint8, 3), (4, 16): ("RGBA", np.uint8, 3),
            (6, 16): ("RGBA", np.uint8, 3), (3, 2): ("P", np.uint8, 2)}
    for (colour, depth), (mode, dtype, ndim) in want.items():
        samples, palette = _case(colour, depth)
        data = encode(samples, depth, colour, [0], palette=palette)
        assert Image.open(io.BytesIO(data)).mode == mode
        got = png.read_png(data)
        assert got.pixels.dtype == dtype and got.pixels.ndim == ndim
        assert im.mode_of(got.pixels, got.palette) == mode or (
            mode == "RGBA" and got.pixels.shape[-1] == 4)
    samples, _ = _case(0, 2)
    got = png.read_png(encode(samples, 2, 0, [0])).pixels
    np.testing.assert_array_equal(got, samples[..., 0] * 85)
    samples, _ = _case(2, 16)
    got = png.read_png(encode(samples, 16, 2, [0])).pixels
    np.testing.assert_array_equal(got, samples >> 8)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("cut", [0.5, 0.8])
def test_truncated_file_matches_pil(interlace, cut):
    """A file cut short: the rows its data holds, zeros below, as PIL with
    ``LOAD_TRUNCATED_IMAGES``."""
    rng = np.random.default_rng(3)
    samples = rng.integers(0, 65536, (64, 64, 1))
    data = encode(samples, 16, 0, [0, 1, 2, 3, 4], interlace=interlace)
    short = data[: int(len(data) * cut)]
    _assert_same(short)
    got = png.read_png(short).pixels
    assert (got == 0).all(1).sum() > 0 and not (got == 0).all()


def test_truncated_pil_file_rows():
    """A 64x64 PNG of PIL's cut in half decodes 64x64 with its last rows
    zero, as PIL decodes it."""
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(4).integers(
        1, 256, (64, 64)).astype(np.uint8)).save(buf, format="PNG")
    half = buf.getvalue()[: len(buf.getvalue()) // 2]
    got = png.read_png(half).pixels
    np.testing.assert_array_equal(got, _pil(half))
    zero_rows = int((got == 0).all(1).sum())
    assert got.shape == (64, 64) and 0 < zero_rows < 64
    assert (got[-zero_rows:] == 0).all()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_matches_plain_twin(bpp):
    """The C++ unfilter equals its numpy twin on random filtered rows of
    every type (random bytes: every wrap and every Paeth branch)."""
    rng = np.random.default_rng(bpp)
    rows, row_bytes = 23, 7 * bpp + 3
    filtered = rng.integers(0, 256, (rows, row_bytes + 1)).astype(np.uint8)
    filtered[:, 0] = np.arange(rows) % 5
    flat = filtered.reshape(-1)
    got = png.unfilter(flat, rows, row_bytes, bpp)
    want = png.unfilter_reference(flat, rows, row_bytes, bpp)
    np.testing.assert_array_equal(got, want)


def test_unfilter_rejects_unknown_filter_type():
    filtered = np.zeros((3, 5), np.uint8)
    filtered[1, 0] = 7
    with pytest.raises(png.PngError, match="row 1 has filter type 7"):
        png.unfilter(filtered.reshape(-1), 3, 4, 1)


@pytest.mark.parametrize("break_it,match", [
    ("depth", "colour type 2, .*no such colour type and bit depth"),
    ("filter", "bit depth 8, colour type 0.*row 2 has filter type 9"),
    ("zlib", "zlib"),
    ("signature", "not a PNG file"),
    ("palette", "without a PLTE chunk"),
])
def test_undecodable_png_raises_naming_file_and_ihdr(tmp_path, break_it,
                                                     match):
    samples, _ = _case(0, 8)
    if break_it == "depth":     # 4-bit RGB does not exist
        data = (png._SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 4, 4, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(4 * 7)))
            + _chunk(b"IEND", b""))
    elif break_it == "filter":
        raw = _raw_rows(samples.reshape(HW[0], -1), 8)
        stream = bytearray(_filter_rows(raw, 1, [0] * HW[0]))
        stream[2 * (HW[1] + 1)] = 9
        data = (png._SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", HW[1], HW[0], 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(stream)))
            + _chunk(b"IEND", b""))
    elif break_it == "zlib":
        data = (png._SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 4, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", b"\x78\x9c\xff\xff\xff\xff")
            + _chunk(b"IEND", b""))
    elif break_it == "signature":
        data = b"GIF89a" + bytes(20)
    else:
        data = encode(samples, 8, 3, [0]).replace(b"PLTE", b"xxxx")
    path = tmp_path / "broken.png"
    path.write_bytes(data)
    with pytest.raises(png.PngError, match=match) as info:
        png.read_png(str(path))
    assert str(path) in str(info.value)


def test_read_png_sources_agree(tmp_path):
    """A path, a file object and bytes decode alike."""
    samples, _ = _case(2, 8)
    data = encode(samples, 8, 2, [4])
    path = tmp_path / "x.png"
    path.write_bytes(data)
    a = png.read_png(str(path)).pixels
    with open(path, "rb") as f:
        b = png.read_png(f).pixels
    c = png.read_png(io.BytesIO(data)).pixels
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(a, samples)


def test_writers_round_trip_through_the_reader():
    """``data/png.py``'s writers and its reader invert each other."""
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (9, 14)).astype(np.uint8)
    rgb = rng.integers(0, 256, (9, 14, 3)).astype(np.uint8)
    pal = rng.integers(0, 256, 12).astype(np.uint8)
    np.testing.assert_array_equal(png.read_png(png.gray_png_bytes(gray))
                                  .pixels, gray)
    np.testing.assert_array_equal(png.read_png(png.rgb_png_bytes(rgb))
                                  .pixels, rgb)
    got = png.read_png(png.palette_png_bytes(gray % 4, pal))
    np.testing.assert_array_equal(got.pixels, gray % 4)
    np.testing.assert_array_equal(got.palette, pal.reshape(-1, 3))


@pytest.mark.parametrize("which", ["unfilter", "resample"])
def test_host_libraries_build_into_build_dir(which):
    """The unfilter and the resample are compiled with g++ into the
    package's ``_build/`` under a hash of their source, and loaded with
    ctypes."""
    from thermal_semantic_segmentation_torch.data import gxx
    lib, source = {"unfilter": (png._unfilter_lib, png.UNFILTER_SOURCE),
                   "resample": (im._resample_lib, im.RESAMPLE_SOURCE)}[which]
    path = gxx.library_path(source)
    assert lib()._name == str(path) and path.parent == gxx.BUILD_DIR
    assert path.name.startswith(f"lib{source.stem}-")


def _bomb_body(kind: str) -> bytes:
    """A request body that costs far more to decode than it weighs: an
    IHDR that claims 60000x60000 16-bit pixels over a few bytes of data
    ('ihdr'), or a 4x4 grey image whose IDAT inflates to 64 MiB of zeros
    ('zlib')."""
    if kind == "ihdr":
        return (png._SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 60000, 60000, 16, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(64)))
            + _chunk(b"IEND", b""))
    deflate, zeros = zlib.compressobj(9), bytes(1 << 20)
    stream = b"".join(deflate.compress(zeros) for _ in range(64))
    return (png._SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 4, 4, 8, 0, 0, 0, 0))
        + _chunk(b"IDAT", stream + deflate.flush()) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("width,height", [(10, 10), (11, 10)])
def test_pixel_limit_matches_pil(monkeypatch, width, height):
    """``read_png`` refuses an image of more than ``2 * MAX_IMAGE_PIXELS``
    pixels exactly where PIL's ``Image.open`` raises
    ``DecompressionBombError`` (both limits lowered to 50 here)."""
    monkeypatch.setattr(png, "MAX_IMAGE_PIXELS", 50)
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 50)
    data = png.gray_png_bytes(np.full((height, width), 7, np.uint8))
    try:
        with Image.open(io.BytesIO(data)) as img:
            want = np.asarray(img)
    except Image.DecompressionBombError:
        with pytest.raises(png.PngError, match="decompression bomb"):
            png.read_png(data)
        assert width * height > 100
    else:
        np.testing.assert_array_equal(png.read_png(data).pixels, want)
        assert width * height <= 100


def test_limit_is_pils():
    assert png.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS


@pytest.mark.parametrize("kind", ["ihdr", "zlib"])
def test_bomb_bodies_cost_little(kind):
    """The IHDR bomb is refused before anything is allocated; the zlib
    bomb is inflated only as far as its 4x4 rows need and decodes as PIL
    decodes it. Neither takes more than a few MiB (tracemalloc sees numpy's
    and zlib's buffers)."""
    import tracemalloc

    body = _bomb_body(kind)
    tracemalloc.start()
    try:
        if kind == "ihdr":
            with pytest.raises(png.PngError, match="60000x60000.*bomb"):
                png.read_png(body, name="request body")
        else:
            got = png.read_png(body).pixels
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 8 << 20, peak
    if kind == "zlib":
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(io.BytesIO(body))))


@pytest.mark.parametrize("kind,status", [("ihdr", 400), ("zlib", 200)])
def test_server_answers_bomb_bodies(kind, status):
    """Over HTTP the seg server answers the IHDR bomb 400 and the zlib bomb
    200 (a 4x4 frame), each well inside a second of decode."""
    import threading
    import time
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from thermal_semantic_segmentation_torch.serving import (batcher,
                                                             endpoints)

    def zeros(model, x):
        return torch.zeros(x.shape[:3], dtype=torch.uint8)

    srv = batcher.InferenceServer(None, batch_size=1, label_hw=(8, 16),
                                  device="cpu", predict_fn=zeros)
    srv.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), endpoints.make_handler(
        srv, {"checkpoint": "t"}))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/segment?format=ids"
    try:
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url, data=_bomb_body(kind), method="POST"),
                    timeout=60) as r:
                got, text = r.status, r.read()
        except urllib.error.HTTPError as e:
            got, text = e.code, e.read()
        seconds = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    assert got == status, text
    if status == 400:
        assert b"decompression bomb" in text
    else:
        assert png.read_png(text).pixels.shape == (8, 16)
    assert seconds < 5, seconds
