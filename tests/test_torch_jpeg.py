"""The port's JPEG codec (``ihpr_tpu_torch/data/jpeg.py``): the CPU codec
(cv2) against the fixture's libjpeg pixels here, and nvJPEG on the card.

The ``cuda``-marked tests skip on a host without a card. On the card they
run without JAX (``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jpeg.py
"""

import os

import numpy as np
import pytest
import torch

from ihpr_tpu_torch.data import jpeg

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "real_root")

# nvJPEG (12.4, CUDA 12.9, on an H100) against libjpeg on the fixture's
# frames (q95, 4:2:0), in levels of 255. Measured: every channel sits ~0.5
# level lower (half the pixels 1 lower: the colour conversion rounds
# otherwise), 0.59-0.69 levels apart on average per image, and up to 67 at
# the saturated blobs' edges, where nvJPEG's chroma upsampling differs from
# libjpeg's triangle ("fancy") filter.
NVJPEG_MAX_LEVELS = 70
NVJPEG_MEAN_LEVELS = 0.75


def _fixture():
    """{file name: (JPEG bytes, libjpeg's RGB pixels)}."""
    pixels = np.load(os.path.join(FIXTURE, "pixels.npz"))
    out = {}
    for name in pixels.files:
        with open(os.path.join(FIXTURE, "images", name), "rb") as f:
            out[name] = (f.read(), pixels[name])
    return out


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cpu_decode_is_libjpegs_pixels():
    fix = _fixture()
    got = jpeg.decode([blob for blob, _ in fix.values()], "cpu", list(fix))
    for (name, (_, want)), img in zip(fix.items(), got):
        assert img.dtype == torch.uint8 and img.device.type == "cpu", name
        np.testing.assert_array_equal(img.numpy(), want, err_msg=name)


def test_cpu_encode_round_trip():
    """cv2.imencode then cv2.imdecode: the frame comes back within JPEG's
    loss at quality 95: a fraction of a level on average, up to a few tens
    at the saturated blobs' edges, where 4:2:0 halves the chroma
    resolution (18 levels measured)."""
    _, want = next(iter(_fixture().values()))
    (blob,) = jpeg.encode([want], 95, "cpu")
    assert blob[:2] == b"\xff\xd8" and blob[-2:] == b"\xff\xd9"
    (back,) = jpeg.decode([blob], "cpu")
    diff = np.abs(back.numpy().astype(int) - want.astype(int))
    assert back.shape == want.shape and diff.mean() < 0.5 and diff.max() <= 32, (diff.mean(), diff.max())


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_undecodable_bytes_raise_naming_the_file(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    good, _ = next(iter(_fixture().values()))
    with pytest.raises(ValueError, match="bad.jpg"):
        jpeg.decode([good, b"not a jpeg" * 20], device, ["good.jpg", "bad.jpg"])


def test_encode_refuses_what_it_cannot_encode():
    with pytest.raises(ValueError, match="quality"):
        jpeg.encode([np.zeros((8, 8, 3), np.uint8)], 0, "cpu")
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode([np.zeros((8, 8), np.uint8)], 95, "cpu")


@pytest.mark.cuda
def test_nvjpeg_decode_against_libjpeg(cuda):
    fix = _fixture()
    jpeg.launches = 0
    got = jpeg.decode([blob for blob, _ in fix.values()], cuda, list(fix))
    torch.cuda.synchronize()
    assert jpeg.launches == 1  # one batched call for the six files
    for (name, (_, want)), img in zip(fix.items(), got):
        assert img.device.type == "cuda" and img.shape == want.shape, name
        diff = np.abs(img.cpu().numpy().astype(int) - want.astype(int))
        print(f"{name}: nvJPEG vs libjpeg max {diff.max()} mean {diff.mean():.4f} levels")
        assert diff.max() <= NVJPEG_MAX_LEVELS and diff.mean() <= NVJPEG_MEAN_LEVELS, name


@pytest.mark.cuda
def test_nvjpeg_batch_equals_one_at_a_time(cuda):
    """Frames of different sizes in one batch land at their own offsets: each
    equals its decode alone."""
    fix = _fixture()
    small = jpeg.encode([np.ascontiguousarray(p[:97, :131]) for _, p in fix.values()], 90, "cpu")
    blobs = [b for pair in zip([b for b, _ in fix.values()], small) for b in pair]
    batch = jpeg.decode(blobs, cuda)
    for blob, img in zip(blobs, batch):
        (alone,) = jpeg.decode([blob], cuda)
        assert torch.equal(img, alone)


@pytest.mark.cuda
def test_nvjpeg_encode_round_trip(cuda):
    """nvJPEG's encoder writes 4:2:0 baseline JPEGs that its decoder reads
    back within JPEG's loss at the quality asked for. Through nvJPEG both
    ways the q95 frame comes back 1.51 levels off on average (measured):
    the encoder's colour conversion sits ~1.2 levels low in R and B (its
    file read by libjpeg), the decoder's ~0.5."""
    _, want = next(iter(_fixture().values()))
    jpeg.encode_launches = 0
    hi, lo = jpeg.encode([torch.from_numpy(want).to(cuda), want], 95, cuda)[0], jpeg.encode([want], 50, cuda)[0]
    assert jpeg.encode_launches == 3
    assert hi[:2] == b"\xff\xd8" and hi[-2:] == b"\xff\xd9" and len(lo) < len(hi)
    sof = hi.index(b"\xff\xc0")  # baseline: Y 2x2, Cb and Cr 1x1
    assert hi[sof + 11 : sof + 18 : 3] == bytes([0x22, 0x11, 0x11])
    for blob, tol in ((hi, 2.0), (lo, 5.0)):
        back = jpeg.decode([blob], cuda)[0].cpu().numpy().astype(int)
        diff = np.abs(back - want.astype(int))
        print(f"encode q{95 if blob is hi else 50} -> decode: max {diff.max()} mean {diff.mean():.4f}")
        assert back.shape == want.shape and diff.mean() <= tol


@pytest.mark.cuda
def test_loader_decodes_beside_the_step_in_flight(cuda):
    """The loader decodes and copies back on a stream of its own, and waits
    for that stream alone: a batch of JPEGs reaches the host while a kernel
    (standing in for the train step in flight) still runs on the current
    stream."""
    from ihpr_tpu_torch.data.pipeline import _load_images

    fix = _fixture()
    samples = [{"img_path": os.path.join(FIXTURE, "images", name)} for name in fix]
    _load_images(samples, cuda)  # nvJPEG's buffers for a batch of this size
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of cycles on the current stream
    got = _load_images(samples, cuda)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    for (name, (_, want)), img in zip(fix.items(), got):
        diff = np.abs(img.astype(int) - want.astype(int))
        assert diff.max() <= NVJPEG_MAX_LEVELS and diff.mean() <= NVJPEG_MEAN_LEVELS, name
