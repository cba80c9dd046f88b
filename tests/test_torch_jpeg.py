"""The port's JPEG codec (``ihpr_tpu_torch/data/jpeg.py``): the CPU codec
(cv2) against the fixture's libjpeg pixels here, and nvJPEG on the card.

The ``cuda``-marked tests skip on a host without a card. On the card they
run without JAX (``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jpeg.py
"""

import io
import os

import numpy as np
import pytest
import torch

from ihpr_tpu_torch.data import jpeg
from ihpr_tpu_torch.ops import jpeg_color

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "real_root")
# libjpeg's planes of the fixture's frames (PIL): Y at full size, Cb and Cr
# as stored at 4:2:0, before upsampling (``_libjpeg_planes``).
YCBCR = os.path.join(FIXTURE, "ycbcr.npz")
# Small frames at odd sizes in each subsampling the card decodes, and
# libjpeg's RGB of each (cv2): {sampling}/jpeg, {sampling}/rgb.
SAMPLINGS = os.path.join(FIXTURE, "samplings.npz")
# name: (PIL's subsampling argument, or None for a grayscale frame; (h, w))
ODD_FRAMES = {"4:2:0": (2, (37, 53)), "4:2:2": (1, (37, 53)), "4:4:4": (0, (21, 19)), "gray": (None, (23, 35))}

# The card's decode (nvJPEG's planes, then libjpeg's upsampling and colour
# conversion in the colour kernel) against libjpeg on the fixture's frames
# (q95, 4:2:0), in levels of 255, on an H100 (CUDA 12.8). Only the IDCTs
# differ: nvJPEG's Y, Cb and Cr planes sit at most 1 level from libjpeg's,
# 0.0015-0.0172 of a level on average per plane; through the conversion
# that becomes at most 3 levels in RGB, 0.0172-0.0186 on average per image.
# The bars are those measurements plus a margin of 1 level (max) and about
# a third (mean). (nvJPEG's own upsampling and conversion sat up to 67
# levels and 0.59-0.69 on average away: bars of 70 and 0.75 before.)
NVJPEG_MAX_LEVELS = 4
NVJPEG_MEAN_LEVELS = 0.025
NVJPEG_PLANE_MAX_LEVELS = 2
NVJPEG_PLANE_MEAN_LEVELS = 0.025


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


# --- libjpeg's colour arithmetic (ops/jpeg_color.py) -------------------------------------------------------------


def _pil_ycbcr(blob: bytes, size=None) -> np.ndarray:
    """libjpeg's upsampled YCbCr (PIL), at ``size`` (w, h) through libjpeg's
    DCT scaling, or at full size."""
    from PIL import Image

    im = Image.open(io.BytesIO(blob))
    im.draft("YCbCr", size or im.size)
    return np.asarray(im)


def _libjpeg_planes(blob: bytes):
    """libjpeg's Y, and its Cb and Cr as stored at 4:2:0, of a 4:2:0 JPEG.
    Decoded at half scale, libjpeg gives the chroma its full 8x8 IDCT and
    no upsampling (its per-component DCT scaling), so the half-scale Cb and
    Cr are the stored planes exactly."""
    full = _pil_ycbcr(blob)
    h, w = full.shape[:2]
    half = _pil_ycbcr(blob, (w // 2, h // 2))
    assert half.shape[:2] == (-(-h // 2), -(-w // 2)), half.shape
    return full[..., 0], half[..., 1].copy(), half[..., 2].copy()


def _odd_frame(sub, size, seed=0) -> bytes:
    """A smooth random frame of ``size`` as a q90 JPEG at PIL subsampling
    ``sub`` (None: grayscale)."""
    from PIL import Image

    h, w = size
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, ((h + 3) // 4, (w + 3) // 4, 3)).astype(np.uint8)
    img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
    buf = io.BytesIO()
    if sub is None:
        img.convert("L").save(buf, "JPEG", quality=90)
    else:
        img.save(buf, "JPEG", quality=90, subsampling=sub)
    return buf.getvalue()


def write_colour_fixtures():
    """(Re)write ``ycbcr.npz`` and ``samplings.npz`` (PIL and cv2 needed):
    ``python tests/test_torch_jpeg.py``."""
    import cv2

    planes = {}
    for name, (blob, _) in _fixture().items():
        for key, plane in zip(("y", "cb", "cr"), _libjpeg_planes(blob)):
            planes[f"{name}/{key}"] = plane
    np.savez_compressed(YCBCR, **planes)
    frames = {}
    for name, (sub, size) in ODD_FRAMES.items():
        blob = _odd_frame(sub, size)
        frames[f"{name}/jpeg"] = np.frombuffer(blob, np.uint8)
        frames[f"{name}/rgb"] = cv2.imdecode(frames[f"{name}/jpeg"], cv2.IMREAD_COLOR)[:, :, ::-1]
    np.savez_compressed(SAMPLINGS, **frames)


def _odd_frames():
    """{sampling: (JPEG bytes, libjpeg's RGB)} of ``samplings.npz``."""
    data = np.load(SAMPLINGS)
    return {name: (data[f"{name}/jpeg"].tobytes(), data[f"{name}/rgb"]) for name in ODD_FRAMES}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def test_colour_fixtures_are_libjpegs():
    """The committed planes are PIL's libjpeg decode of the fixture's
    frames, and the committed odd-size frames decode (cv2) to their
    committed pixels at the subsampling each is named for."""
    planes = np.load(YCBCR)
    for name, (blob, _) in _fixture().items():
        for key, want in zip(("y", "cb", "cr"), _libjpeg_planes(blob)):
            np.testing.assert_array_equal(planes[f"{name}/{key}"], want, err_msg=f"{name}/{key}")
    for name, (blob, rgb) in _odd_frames().items():
        (got,) = jpeg.decode([blob], "cpu")
        np.testing.assert_array_equal(got.numpy(), rgb, err_msg=name)
        want = jpeg_color.GRAY if name == "gray" else jpeg_color.SAMPLINGS[name]
        assert jpeg.subsampling(blob, name) == want
        assert rgb.shape[:2] == ODD_FRAMES[name][1]


def test_plain_convert_of_libjpegs_ycbcr_is_cv2s_rgb():
    """``jpeg_color.plain`` at 4:4:4 on libjpeg's own upsampled YCbCr (PIL's
    draft("YCbCr")) equals cv2's RGB decode of every fixture frame, bitwise:
    the colour conversion is libjpeg's ycc_rgb_convert."""
    for name, (blob, want) in _fixture().items():
        ycc = _pil_ycbcr(blob)
        got = jpeg_color.plain(*(_t(ycc[..., k]) for k in range(3)), 1, 1)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_plain_decode_of_libjpegs_planes_is_cv2s_rgb():
    """Upsampling and conversion together: ``plain`` at 4:2:0 on libjpeg's
    stored planes (``ycbcr.npz``) gives cv2's pixels of every fixture frame
    bitwise, so only an IDCT can put the card's decode anywhere else."""
    planes = np.load(YCBCR)
    for name, (_, want) in _fixture().items():
        got = jpeg_color.plain(*(_t(planes[f"{name}/{k}"]) for k in ("y", "cb", "cr")), 2, 2)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("size", [(37, 53), (33, 30), (17, 9), (40, 64)])
def test_plain_h2v2_upsampling_follows_libjpeg_on_odd_sizes(size):
    """4:2:0 frames with odd heights and widths: ``jpeg_color.upsample`` of
    libjpeg's stored Cb and Cr equals libjpeg's upsampled planes, the first
    and last rows and columns included."""
    h, w = size
    blob = _odd_frame(2, size, seed=h * w)
    _, cb, cr = _libjpeg_planes(blob)
    full = _pil_ycbcr(blob)
    for k, plane in ((1, cb), (2, cr)):
        got = jpeg_color.upsample(_t(plane), h, w, 2, 2)
        np.testing.assert_array_equal(got.numpy(), full[..., k])


@pytest.mark.parametrize("size", [(37, 53), (24, 64), (9, 31)])
def test_plain_h2v1_upsampling_follows_libjpeg_on_odd_sizes(size):
    """4:2:2 frames with odd widths: ``upsample`` equals libjpeg's. libjpeg
    has no scaled decode that gives 4:2:2's stored chroma, so the frame's
    colour is constant on 16x8 blocks and written at quality 100: each
    stored chroma sample is then the 4:4:4 encoding's (its forward DCT is
    exact on a constant block), while the upsampling blends each block
    boundary and the odd last column."""
    from PIL import Image

    h, w = size
    blocks = np.random.RandomState(w).randint(0, 256, ((h + 7) // 8, (w + 15) // 16, 3)).astype(np.uint8)
    img = np.ascontiguousarray(blocks.repeat(8, 0).repeat(16, 1)[:h, :w])

    def encoded(sub):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=100, subsampling=sub)
        return buf.getvalue()

    blob = encoded(1)
    assert jpeg.subsampling(blob) == (2, 1)
    stored = _pil_ycbcr(encoded(0))[:, 0::2]
    full = _pil_ycbcr(blob)
    for k in (1, 2):
        got = jpeg_color.upsample(_t(stored[..., k]), h, w, 2, 1).numpy()
        np.testing.assert_array_equal(got, full[..., k])
        assert (got != stored[..., k].repeat(2, 1)[:, :w]).any()  # not a box filter


def test_to_rgb_on_the_cpu_is_plain_per_frame():
    """``to_rgb`` on CPU planes runs ``plain`` at each frame's offset and
    subsampling: a batch of a 4:2:0, a 4:2:2, a 4:4:4 and a grayscale
    frame at odd sizes."""
    rng = np.random.RandomState(1)
    layouts, chunks, offset = [], [], 0
    for (hs, vs), (h, w) in zip([(2, 2), (2, 1), (1, 1), (0, 0)], [(5, 7), (6, 9), (3, 4), (4, 5)]):
        lay = jpeg_color.Layout(offset, 0, 0, h, w, hs, vs)
        ch, cw = lay.chroma_shape
        lay = lay._replace(cb=offset + h * w, cr=offset + h * w + ch * cw)
        chunks.append(rng.randint(0, 256, h * w + 2 * ch * cw).astype(np.uint8))
        layouts.append(lay)
        offset += h * w + 2 * ch * cw
    planes = _t(np.concatenate(chunks))
    jpeg_color.launches = 0
    got = jpeg_color.to_rgb(planes, layouts)
    assert jpeg_color.launches == 0  # the CPU takes the plain version
    for lay, img in zip(layouts, got):
        want = jpeg_color.plain(*jpeg_color.plane_views(planes, lay), lay.hs, lay.vs)
        assert img.shape == (lay.h, lay.w, 3) and torch.equal(img, want)
    assert torch.equal(got[3][..., 0], got[3][..., 2])  # gray: R = G = B = Y


def _with_sampling(blob: bytes, factors) -> bytes:
    """``blob`` with its start-of-frame header's sampling factors replaced."""
    sof = blob.index(b"\xff\xc0")
    out = bytearray(blob)
    for k, (h, v) in enumerate(factors):
        out[sof + 11 + 3 * k] = h << 4 | v
    return bytes(out)


def test_subsampling_reads_each_header_and_refuses_the_rest():
    blob, _ = next(iter(_fixture().values()))
    assert jpeg.subsampling(blob) == (2, 2)
    assert jpeg.subsampling(_with_sampling(blob, [(1, 1)] * 3)) == (1, 1)
    for factors in ([(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)], [(2, 2), (2, 1), (1, 1)]):
        with pytest.raises(ValueError, match="odd.jpg"):
            jpeg.subsampling(_with_sampling(blob, factors), "odd.jpg")
    with pytest.raises(ValueError, match="bad.jpg"):
        jpeg.subsampling(b"not a jpeg", "bad.jpg")
    with pytest.raises(ValueError, match="cut.jpg: truncated"):
        jpeg.subsampling(blob[: blob.index(b"\xff\xc0") + 12], "cut.jpg")


@pytest.mark.cuda
def test_unsupported_subsampling_raises_on_the_card(cuda):
    blob, _ = next(iter(_fixture().values()))
    with pytest.raises(ValueError, match="odd.jpg"):
        jpeg.decode([blob, _with_sampling(blob, [(1, 2), (1, 1), (1, 1)])], cuda, ["good.jpg", "odd.jpg"])


@pytest.mark.cuda
def test_colour_kernel_equals_plain_on_nvjpegs_planes(cuda):
    """The colour kernel, one launch over the fixture's six frames and the
    odd-size 4:2:0, 4:2:2, 4:4:4 and grayscale frames, equals ``plain`` on
    the same nvJPEG planes bitwise."""
    blobs = [b for b, _ in _fixture().values()] + [b for b, _ in _odd_frames().values()]
    planes, layouts = jpeg.decode_planes(blobs, cuda)
    assert [(lay.hs, lay.vs) for lay in layouts[6:]] == [(2, 2), (2, 1), (1, 1), (0, 0)]
    jpeg_color.launches = 0
    got = jpeg_color.to_rgb(planes, layouts)
    torch.cuda.synchronize()
    assert jpeg_color.launches == 1
    host = planes.cpu()
    for lay, img in zip(layouts, got):
        want = jpeg_color.plain(*jpeg_color.plane_views(host, lay), lay.hs, lay.vs)
        assert torch.equal(img.cpu(), want), lay



def plane_gaps(planes: torch.Tensor, layouts, names):
    """{frame: {plane: (max, mean) |nvJPEG - libjpeg| in levels}} of
    ``decode_planes``' output for the fixture's frames against
    ``ycbcr.npz``."""
    want = np.load(YCBCR)
    host = planes.cpu()
    out = {}
    for name, lay in zip(names, layouts):
        out[name] = {}
        for key, got in zip(("y", "cb", "cr"), jpeg_color.plane_views(host, lay)):
            diff = np.abs(got.numpy().astype(int) - want[f"{name}/{key}"].astype(int))
            out[name][key] = (int(diff.max()), float(diff.mean()))
    return out


@pytest.mark.cuda
def test_nvjpeg_planes_against_libjpegs(cuda):
    """nvJPEG's Y, Cb and Cr planes against libjpeg's (``ycbcr.npz``): only
    the IDCTs differ here."""
    fix = _fixture()
    planes, layouts = jpeg.decode_planes([b for b, _ in fix.values()], cuda, list(fix))
    for name, gaps in plane_gaps(planes, layouts, list(fix)).items():
        print(f"{name}: nvJPEG planes vs libjpeg (max, mean) {gaps}")
        for key, (mx, mean) in gaps.items():
            assert mx <= NVJPEG_PLANE_MAX_LEVELS and mean <= NVJPEG_PLANE_MEAN_LEVELS, (name, key)


if __name__ == "__main__":
    write_colour_fixtures()
