"""The port's raw-frame protocol and host image codecs against the JAX
package's: constants, `payload_nbytes`, the `cv2` colour conversions and
letterbox (exact: the same `cv2` calls on both sides), and `utils/io.py`'s
PNG round trip (exact: PNG is lossless)."""

import builtins

import cv2
import numpy as np
import pytest

from facerecognitionpipeline_tpu.serve import rawproto as jraw
from facerecognitionpipeline_tpu_torch.serve import rawproto as traw
from facerecognitionpipeline_tpu_torch.utils import io as tio


def _img(seed, h, w, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def test_constants_equal():
    for name in ("HEADER_FORMAT", "HEADER_WIDTH", "HEADER_HEIGHT", "HEADER_SCALE",
                 "HEADER_COUNT", "HEADER_TIMESTAMP", "RAW_FORMATS"):
        assert getattr(traw, name) == getattr(jraw, name)


@pytest.mark.parametrize("fmt", ["rgb24", "i420"])
@pytest.mark.parametrize("h,w", [(640, 640), (160, 160), (480, 640), (4, 2)])
def test_payload_nbytes_equal(fmt, h, w):
    assert traw.payload_nbytes(fmt, h, w) == jraw.payload_nbytes(fmt, h, w)


def test_payload_nbytes_rejects_unknown_format_on_both():
    for mod in (jraw, traw):
        with pytest.raises(ValueError, match="unknown raw frame format"):
            mod.payload_nbytes("bgr", 4, 4)


@pytest.mark.parametrize("h,w", [(160, 160), (120, 200), (640, 640), (4, 2)])
def test_rgb_to_i420_equals_the_jax_package(h, w):
    rgb = _img(h + w, h, w)
    got = traw.rgb_to_i420(rgb)
    assert got.shape == (h * 3 // 2, w) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jraw.rgb_to_i420(rgb))


@pytest.mark.parametrize("h,w", [(160, 160), (120, 200), (640, 640), (4, 2)])
def test_i420_to_rgb_equals_the_jax_package(h, w):
    yuv = np.random.default_rng(h * w).integers(0, 256, (h * 3 // 2, w), dtype=np.uint8)
    got = traw.i420_to_rgb(yuv)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jraw.i420_to_rgb(yuv))


def test_i420_round_trip_is_close_on_a_smooth_image():
    y, x = np.mgrid[0:64, 0:64]
    rgb = np.stack([2 * x + 40, 3 * y + 20, x + y + 60], -1).astype(np.uint8)
    back = traw.i420_to_rgb(traw.rgb_to_i420(rgb))
    assert np.abs(back.astype(int) - rgb.astype(int)).max() <= 6  # chroma is subsampled


def test_i420_host_and_device_decoders_agree():
    """The client's host encoder feeds the engine's device decoder: that pair
    is within 2 grey levels of cv2's own round trip (float against 20-bit
    fixed point)."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.image import i420_to_rgb as dev_i420

    rgb = _img(3, 64, 48)
    yuv = traw.rgb_to_i420(rgb)
    dev = dev_i420(torch.from_numpy(yuv), 64, 48).numpy()
    assert np.abs(dev - traw.i420_to_rgb(yuv).astype(np.float32)).max() <= 2.0


@pytest.mark.parametrize("frame_hw", [(480, 640), (160, 160), (300, 100), (90, 240)])
def test_letterbox_equals_the_jax_package(frame_hw):
    frame = _img(7, *frame_hw)
    ref, ref_scale = jraw.letterbox_rgb(frame, (160, 160))
    got, scale = traw.letterbox_rgb(frame, (160, 160))
    assert scale == ref_scale and got.shape == (160, 160, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    if frame_hw == (160, 160):  # already at det_size: an exact copy
        np.testing.assert_array_equal(got, frame)


# ------------------------------------------------------------ utils/io.py


@pytest.mark.parametrize("source", ["rgb_png", "grey_png", "rgba_png", "jpeg"])
def test_decode_image_rgb(source):
    """Grey is replicated and alpha dropped, as the JAX server's
    `cv2.imdecode(..., IMREAD_COLOR)` does."""
    img = _img(4, 21, 17)
    if source == "rgb_png":
        blob, want = cv2.imencode(".png", img[..., ::-1])[1].tobytes(), img
    elif source == "grey_png":
        blob = cv2.imencode(".png", img[..., 0])[1].tobytes()
        want = np.repeat(img[..., :1], 3, axis=2)
    elif source == "rgba_png":
        bgra = np.concatenate([img[..., ::-1], _img(5, 21, 17, 1)], axis=2)
        blob, want = cv2.imencode(".png", bgra)[1].tobytes(), img
    else:
        img = np.full((32, 32, 3), 120, np.uint8)
        blob, want = cv2.imencode(".jpg", img)[1].tobytes(), None
    got = tio.decode_image_rgb(blob)
    if want is None:  # JPEG is lossy: a flat grey comes back within 3 levels
        assert got.shape == (32, 32, 3) and np.abs(got.astype(int) - 120).max() <= 3
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("payload", [b"", b"not an image", b"\x89PNG\r\n\x1a\n garbage"])
def test_decode_image_rgb_returns_none_for_non_images(payload):
    assert tio.decode_image_rgb(payload) is None


def test_imwrite_imread_round_trip(tmp_path):
    img = _img(8, 30, 20)
    path = str(tmp_path / "deep" / "dir" / "x.png")
    tio.imwrite_rgb(path, img.astype(np.float32) + 0.4)  # floats are clipped and cast
    np.testing.assert_array_equal(tio.imread_rgb(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    assert tio.imread_rgb(str(tmp_path / "missing.png")) is None
    assert tio.list_images(str(tmp_path / "deep" / "dir")) == [path]
    assert tio.list_images(str(tmp_path / "nowhere")) == []


def test_imwrite_takes_a_lazy_device_view(tmp_path):
    """The server hands imwrite_rgb the batcher's lazy slice: it crosses to
    the host inside np.asarray, once."""
    import torch

    from facerecognitionpipeline_tpu_torch.serve.batcher import _LazySlice

    batch = torch.from_numpy(_img(2, 4 * 16, 16).reshape(4, 16, 16, 3).astype(np.float32))
    view = _LazySlice(batch, (2,))
    path = str(tmp_path / "crop.png")
    tio.imwrite_rgb(path, view)
    np.testing.assert_array_equal(tio.imread_rgb(path), batch[2].numpy().astype(np.uint8))


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_encode_image_rgb_round_trips(fmt):
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([3 * x, 4 * y, x + y], -1).astype(np.uint8)
    back = tio.decode_image_rgb(tio.encode_image_rgb(img, fmt))
    if fmt == "png":
        np.testing.assert_array_equal(back, img)
    else:
        assert np.abs(back.astype(int) - img.astype(int)).mean() < 3.0


def test_client_payload_equals_the_jax_clients():
    """Same bytes on the wire for the base64 PNG transport (cv2 on both)."""
    from facerecognitionpipeline_tpu.serve.client import _encode_image_base64 as jenc
    from facerecognitionpipeline_tpu_torch.serve.client import _encode_image_base64 as tenc

    img = _img(12, 60, 80)
    assert tenc(img) == jenc(img)
    assert tenc(img, "jpeg") == jenc(img, "jpeg")


def test_modules_look_cv2_up_at_the_call_only():
    """Neither module binds cv2 at import; a host without it gets the
    ImportError at the call that needs the codec, not before."""
    assert not hasattr(traw, "cv2") and not hasattr(tio, "cv2")
    real_import = builtins.__import__

    def no_cv2_import(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 hidden for this test")
        return real_import(name, *a, **k)

    builtins.__import__ = no_cv2_import
    try:
        assert traw.payload_nbytes("i420", 4, 2) == 12
        with pytest.raises(ImportError):
            traw.letterbox_rgb(_img(1, 80, 160), (160, 160))
        with pytest.raises(ImportError):
            tio.decode_image_rgb(b"x")
    finally:
        builtins.__import__ = real_import
