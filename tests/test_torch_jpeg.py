"""The port's JPEG decoder and encoder (`catnerf_torch/data/jpeg.py`,
`native/src/jpeg.cpp`) against OpenCV (libjpeg-turbo): files cv2 writes
at qualities 50 and 98, 4:2:0, 4:2:2, 4:4:0 and 4:4:4 sampling, grey,
sizes that are not multiples of 16, restart intervals and optimised
Huffman tables decode byte for byte as `cv2.imread` decodes them; the
files it refuses raise with their name; and the encoder's files decode
in cv2 to exactly what the port's decoder gives, as close to the source
as cv2's own encoder's at the same quality (within PSNR_SLACK dB) and
above ENCODE_PSNR."""

from __future__ import annotations

import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from catnerf_torch.data import jpeg
from catnerf_tpu.data.synthetic import make_scene

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_scannet_fixture import write_scannet_layout  # noqa: E402

# the encoder's PSNR (dB) of a rendered synthetic frame (160 x 120), at
# least, by quality (cv2's own: 29.25 / 32.77 dB, its 4:2:0 chroma
# blurring the spheres' edges), and at most PSNR_SLACK below cv2's own
# encoder's
ENCODE_PSNR = {50: 29.0, 98: 32.5}
PSNR_SLACK = 0.01
SIZE = (73, 97)  # rows, columns: neither a multiple of 16


def _images():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:SIZE[0], 0:SIZE[1]]
    smooth = np.stack([(2 * x + y) % 256, (3 * y) % 256,
                       (x * y) % 256], -1).astype(np.uint8)
    noisy = np.clip(smooth.astype(int) + rng.integers(-30, 30, smooth.shape),
                    0, 255).astype(np.uint8)
    return {"smooth": smooth, "noisy": noisy,
            "noise": rng.integers(0, 256, smooth.shape, dtype=np.uint8)}


SAMPLINGS = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
EXTRAS = {"plain": [], "rst": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
          "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}


def _check(tmp_path, img, params):
    path = tmp_path / "img.jpg"
    assert cv2.imwrite(str(path), img, params)
    ours = jpeg.imread(str(path))
    theirs = cv2.imread(str(path))
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("quality", [50, 98])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("extra", sorted(EXTRAS))
def test_colour_files_cv2_writes(tmp_path, quality, sampling, extra):
    for img in _images().values():
        _check(tmp_path, img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               SAMPLINGS[sampling], *EXTRAS[extra]])


@pytest.mark.parametrize("quality", [50, 98])
@pytest.mark.parametrize("extra", sorted(EXTRAS))
def test_grey_files_cv2_writes(tmp_path, quality, extra):
    """A grey file comes out as three equal channels, as IMREAD_COLOR."""
    for img in _images().values():
        _check(tmp_path, img[..., 1].copy(),
               [cv2.IMWRITE_JPEG_QUALITY, quality, *EXTRAS[extra]])


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (8, 8), (16, 17),
                                   (33, 15), (120, 160)])
def test_small_and_ragged_sizes(tmp_path, shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    for sampling in SAMPLINGS.values():
        _check(tmp_path, img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])


def test_every_colour_file_of_the_scannet_fixture(tmp_path):
    """The JAX package's ScanNet fixture (cv2 at quality 98, 4:2:0)."""
    write_scannet_layout(make_scene(n_frames=3, width=96, height=72,
                                    n_categories=2, insts_per_cat=2, seed=2),
                         str(tmp_path), 1.0 / 1000.0)
    files = sorted((tmp_path / "color").glob("*.jpg"))
    assert len(files) == 3
    for path in files:
        np.testing.assert_array_equal(jpeg.imread(str(path)),
                                      cv2.imread(str(path)))


def _exif_app1(orientation: int) -> bytes:
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _with_segment(data: bytes, segment: bytes) -> bytes:
    return data[:2] + segment + data[2:]


REFUSED = {
    "progressive": ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1], None,
                    "progressive JPEG files are not supported"),
    "411": ([cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411], None,
            "sampling factors above 2"),
    "exif-rotated": ([], _exif_app1(6), "EXIF orientation 6"),
    "truncated": ([], None, "truncated|not a JPEG"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_files_raise_with_their_name(tmp_path, case):
    params, segment, match = REFUSED[case]
    ok, buf = cv2.imencode(".jpg", _images()["smooth"], params)
    data = buf.tobytes()
    if segment is not None:
        data = _with_segment(data, segment)
    if case == "truncated":
        data = data[:3]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{path.name}: .*({match})"):
        jpeg.imread(str(path))


def test_exif_orientation_one_is_taken(tmp_path):
    ok, buf = cv2.imencode(".jpg", _images()["smooth"])
    path = tmp_path / "upright.jpg"
    path.write_bytes(_with_segment(buf.tobytes(), _exif_app1(1)))
    np.testing.assert_array_equal(jpeg.imread(str(path)),
                                  cv2.imread(str(path)))


def _frame():
    scene = make_scene(n_frames=1, width=160, height=120, n_categories=2,
                       insts_per_cat=2, seed=0)
    return np.ascontiguousarray(
        scene.sample_dict[0]["image"].transpose(1, 0, 2)[..., ::-1])


@pytest.mark.parametrize("quality", [50, 98])
def test_the_encoders_files(tmp_path, quality):
    """The encoder's file decodes in cv2 to exactly what the port's
    decoder gives, within ENCODE_PSNR and PSNR_SLACK on a rendered frame;
    a ragged size too."""
    def psnr(decoded, img):
        mse = np.mean((decoded.astype(np.float64) - img) ** 2)
        return 10 * np.log10(255.0 ** 2 / mse)

    for img in (_frame(), _images()["noisy"]):
        path = tmp_path / "ours.jpg"
        jpeg.imwrite(str(path), img, quality)
        theirs = cv2.imread(str(path))
        ours = jpeg.imread(str(path))
        np.testing.assert_array_equal(ours, theirs)
        if img.shape[:2] == (120, 160):
            ok, buf = cv2.imencode(".jpg", img,
                                   [cv2.IMWRITE_JPEG_QUALITY, quality])
            own = psnr(cv2.imdecode(buf, cv2.IMREAD_COLOR), img)
            assert psnr(ours, img) >= ENCODE_PSNR[quality]
            assert psnr(ours, img) >= own - PSNR_SLACK


def test_the_encoder_refuses_what_it_cannot_write(tmp_path):
    for img in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.uint8),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError, match="uint8 BGR"):
            jpeg.imencode(img)
