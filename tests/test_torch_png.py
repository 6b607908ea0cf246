"""The port's PNG reader and writer (`catnerf_torch/data/png.py`) against
OpenCV, byte for byte: every file of the Replica fixture
(tests/test_replica_fixture.py's layout, written by cv2), files cv2
writes at 8 and 16 bits in grey, BGR and BGRA, files PIL writes (adaptive
row filters, palettes, tRNS), a file with every row filter, the writer's
round trip with its adaptive row filters, and the files it refuses."""

from __future__ import annotations

import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from catnerf_torch.data import png
from catnerf_tpu.data.synthetic import make_scene

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_replica_fixture import write_replica_layout  # noqa: E402

FIXTURE = dict(n_frames=6, width=96, height=72, n_categories=2,
               insts_per_cat=2, seed=1)


def _cv2_color(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _assert_same(ours, theirs):
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def _check(path):
    _assert_same(png.imread_unchanged(str(path)),
                 cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    _assert_same(png.imread_color(str(path)), _cv2_color(path))


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica")
    write_replica_layout(make_scene(**FIXTURE), str(root), 1.0 / 1000.0)
    return sorted(root.rglob("*.png"))


def test_every_file_of_the_replica_fixture(fixture_files):
    assert len(fixture_files) == 4 * FIXTURE["n_frames"]
    for path in fixture_files:
        _check(path)


CV2_IMAGES = [(shape, dtype) for shape in ((37, 53), (37, 53, 3), (37, 53, 4))
              for dtype in (np.uint8, np.uint16)]


@pytest.mark.parametrize("shape,dtype", CV2_IMAGES,
                         ids=[f"{len(s)}d-{d.__name__}" if len(s) == 2
                              else f"{s[-1]}ch-{d.__name__}"
                              for s, d in CV2_IMAGES])
def test_files_cv2_writes(tmp_path, shape, dtype):
    rng = np.random.default_rng(len(shape) * 10 + np.dtype(dtype).itemsize)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    img[:9] = img[0, 0]  # flat rows as well as noise
    path = tmp_path / "img.png"
    assert cv2.imwrite(str(path), img)
    _check(path)


def _pil_files(root: Path):
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:41, 0:67]
    smooth = np.stack([(2 * x + y) % 256, (3 * y) % 256,
                       (x * y) % 256], -1).astype(np.uint8)
    files = {}
    files["rgb_adaptive"] = Image.fromarray(smooth)
    files["rgba_adaptive"] = Image.fromarray(np.concatenate(
        [smooth, rng.integers(0, 256, (41, 67, 1), dtype=np.uint8)], -1))
    files["grey16"] = Image.fromarray(
        rng.integers(0, 65536, (41, 67), dtype=np.uint16))
    pal = Image.fromarray(rng.integers(0, 256, (41, 67), dtype=np.uint8),
                          mode="P")
    pal.putpalette(rng.integers(0, 256, 768).tolist())
    files["palette"] = pal
    out = {}
    for name, im in files.items():
        out[name] = root / f"{name}.png"
        im.save(out[name])
    out["palette_trns"] = root / "palette_trns.png"
    pal.save(out["palette_trns"],
             transparency=bytes(rng.integers(0, 256, 100, dtype=np.uint8)))
    out["rgb_trns"] = root / "rgb_trns.png"
    Image.fromarray(rng.integers(0, 3, (41, 67, 3), dtype=np.uint8)).save(
        out["rgb_trns"], transparency=(1, 2, 0))
    out["grey_trns"] = root / "grey_trns.png"
    Image.fromarray(rng.integers(0, 3, (41, 67), dtype=np.uint8)).save(
        out["grey_trns"], transparency=2)
    return out


PIL_FILES = ["rgb_adaptive", "rgba_adaptive", "grey16", "palette",
             "palette_trns", "rgb_trns", "grey_trns"]


@pytest.mark.parametrize("name", PIL_FILES)
def test_files_pil_writes(tmp_path, name):
    _check(_pil_files(tmp_path)[name])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode_all_filters(img: np.ndarray, depth: int, ctype: int) -> bytes:
    """A PNG whose row y uses filter y % 5, filtered by a plain loop over
    the bytes (the PNG specification's definitions)."""
    h = img.shape[0]
    rows = img.astype(f">u{depth // 8}").reshape(h, -1).view(np.uint8)
    bpp = (img.shape[2] if img.ndim == 3 else 1) * depth // 8
    out = bytearray()
    prev = [0] * rows.shape[1]
    for y in range(h):
        cur = [int(v) for v in rows[y]]
        kind = y % 5
        out.append(kind)
        for i, v in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((v - pred) & 0xFF)
        prev = cur
    w = img.shape[1]
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (png.SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype,shape", [
    (8, png.RGB, (11, 9, 3)), (16, png.GREY, (11, 9)),
    (8, png.RGBA, (10, 7, 4)), (16, png.RGB, (10, 7, 3))],
    ids=["rgb8", "grey16", "rgba8", "rgb16"])
def test_every_row_filter(tmp_path, depth, ctype, shape):
    rng = np.random.default_rng(depth + ctype)
    img = rng.integers(0, 2 ** depth, shape).astype(f"u{depth // 8}")
    path = tmp_path / "filters.png"
    path.write_bytes(_encode_all_filters(img, depth, ctype))
    _check(path)
    order = [2, 1, 0, 3][:shape[-1]] if len(shape) == 3 else ...
    _assert_same(png.imread_unchanged(str(path)),
                 img[..., order] if len(shape) == 3 else img)


@pytest.mark.parametrize("shape,dtype", CV2_IMAGES,
                         ids=[f"{len(s)}d-{d.__name__}" if len(s) == 2
                              else f"{s[-1]}ch-{d.__name__}"
                              for s, d in CV2_IMAGES])
def test_writer_round_trip(tmp_path, shape, dtype):
    """imwrite takes what cv2.imwrite takes (BGR order); both readers and
    cv2 read back the same image."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    path = tmp_path / "ours.png"
    png.imwrite(str(path), img)
    _assert_same(png.imread_unchanged(str(path)), img)
    _check(path)


def _natural(shape, dtype):
    """A smooth image with noise, as a camera's or a depth sensor's, so
    that the adaptive choice varies from row to row."""
    rng = np.random.default_rng(shape[0] * shape[1])
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    top = np.iinfo(dtype).max
    base = (np.sin(x / 7.0) + np.cos(y / 5.0) + 2.0) * top / 4.0
    if len(shape) == 3:
        base = base[..., None] * np.linspace(0.5, 1.0, shape[2])
    noise = rng.normal(0, top / 200.0, shape) * (y[..., None] % 3 == 0
                                                  if len(shape) == 3
                                                  else y % 3 == 0)
    return np.clip(base + noise, 0, top).astype(dtype)


WRITER_CASES = [((23, 61, 3), np.uint8), ((59, 17), np.uint16),
                ((31, 29, 4), np.uint8)]


@pytest.mark.parametrize("shape,dtype", WRITER_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{d.__name__}"
                              for s, d in WRITER_CASES])
def test_writer_filters_rows_adaptively(tmp_path, shape, dtype):
    """imwrite's rows, filtered by libpng's adaptive choice: cv2 and both
    readers read the image back, byte for byte, and the choice takes more
    than one filter."""
    img = _natural(shape, dtype)
    path = tmp_path / "ours.png"
    png.imwrite(str(path), img)
    _assert_same(png.imread_unchanged(str(path)), img)
    _check(path)
    data = path.read_bytes()
    idat = b"".join(b for k, b in png._chunks(str(path), data)
                    if k == b"IDAT")
    kinds = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], -1)[:, 0]
    assert len(np.unique(kinds)) > 1


def _ihdr_patched(path: Path, **fields) -> Path:
    """A copy of a PNG file with IHDR fields replaced (CRC recomputed)."""
    data = path.read_bytes()
    names = ("width", "height", "depth", "ctype", "method", "filter",
             "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    out = path.with_name("patched.png")
    out.write_bytes(data[:8] + _chunk(b"IHDR", body) + data[33:])
    return out


def test_adam7_raises_with_the_files_name(tmp_path):
    path = tmp_path / "plain.png"
    png.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))
    bad = _ihdr_patched(path, interlace=1)
    with pytest.raises(ValueError, match=f"{bad}.*Adam7"):
        png.imread_color(str(bad))
    with pytest.raises(ValueError, match="Adam7"):
        png.imread_unchanged(str(bad))


def test_unsupported_files_raise(tmp_path):
    path = tmp_path / "one_bit.png"
    Image.fromarray(np.eye(8, dtype=bool)).save(path)  # 1-bit grey
    with pytest.raises(ValueError, match="bit depth 1"):
        png.imread_unchanged(str(path))
    la = tmp_path / "la.png"
    Image.fromarray(np.zeros((4, 4, 2), np.uint8), mode="LA").save(la)
    with pytest.raises(ValueError, match="colour type 4"):
        png.imread_color(str(la))
    plain = tmp_path / "plain.png"
    png.imwrite(str(plain), np.zeros((4, 4), np.uint8))
    data = bytearray(plain.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT chunk
    plain.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.imread_unchanged(str(plain))
    gif = tmp_path / "x.png"
    gif.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.imread_color(str(gif))


def test_an_unknown_row_filter_raises_with_the_files_name(tmp_path):
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    raw = bytearray(zlib.compress(b"".join(
        bytes([5 if y == 2 else 1]) + img[y].tobytes() for y in range(4))))
    header = struct.pack(">IIBBBBB", 4, 4, 8, png.RGB, 0, 0, 0)
    path = tmp_path / "filter5.png"
    path.write_bytes(png.SIGNATURE + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", bytes(raw)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"{path}.*row filter 5 in row 2"):
        png.imread_unchanged(str(path))
