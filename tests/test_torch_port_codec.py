"""The port's image codec against the JAX package and cv2, on the CPU.

* ``data/native_loader.py`` (the port's own copy of ``native/dataloader.cpp``,
  built from its own sources into ``_build/``) against the JAX package's
  native loader on the same files: ``decode_image`` with and without the
  centre crop and bilinear resize, ``load_batch`` at 1 and 4 threads and
  ``image_dims`` bit-equal; the port's ``ImageLoader`` against JAX's over a
  mixed JPEG/PNG manifest of mismatched and non-square sizes, one epoch,
  batches and indices bit-equal, and the ``DeviceDatasetCache`` datasets.
* ``decode_buffer`` against ``cv2.imdecode`` and ``encode_jpeg`` against
  ``cv2.imencode`` at quality 95: the JAX package's own tolerance for its
  native decoder against cv2, max 3 LSB and mean below 1.0
  (``tests/test_native_loader.py:36-37``).
* ``ops.image.resize_cubic`` against ``cv2.resize(INTER_CUBIC)``: bit-equal
  to OpenCV's own implementation. A cv2 built with IPP may route the
  resize through IPP's, which OpenCV itself marks as not exact: with IPP
  on, cv2 5.0 differs from OpenCV's own by 1 LSB in 4.2% of values on
  random uint8 frames of 8-96 pixels, so against cv2's default the bound
  is 1 LSB.
* ``inference.crop_resize`` and ``prepare_frame`` against JAX's
  ``prepare_frame``: bit-equal with cv2 (both resize through it), and with
  cv2 hidden from the port bit-equal to JAX's with IPP off (the port then
  resizes with ``resize_cubic``); the server's ``POST /v1/swap`` against
  the JAX server's recipe built by hand around the same 64^2 resnet18
  engine, byte-equal with cv2, and within the decode tolerance with cv2
  hidden.
* the loader's decoder rule against JAX's (``decode_fn``, the native
  library, cv2) over every combination of ``decode_fn``, ``use_native``,
  the native library and cv2: the same batches where JAX's yields, an
  error naming what is missing where JAX's raises for want of a decoder;
  the server's encoded route with neither; the native library's
  availability (g++ and the codecs' headers) and the error of a library
  that does not load.

The fixtures in ``tests/data/codec/`` and their cv2 decodes were written by
``tests/data/codec/make_codec_fixtures.py``.
"""

import dataclasses
import http.client
import json
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from denoising_diffusion_deep_fake_tpu import inference as jax_inference
from denoising_diffusion_deep_fake_tpu.data import loader as jax_loader
from denoising_diffusion_deep_fake_tpu.data import (
    native_loader as jax_native,
)
from denoising_diffusion_deep_fake_tpu.data.device_cache import (
    DeviceDatasetCache as JaxDeviceCache,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch import inference
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.data import (
    codec,
    loader,
    native_loader,
)
from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import resize_cubic
from denoising_diffusion_deep_fake_tpu_torch.serving import SwapEngine
from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
    SwapServer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)

FIXTURES = Path(__file__).resolve().parent / "data" / "codec"
JPEGS = sorted(p.name for p in FIXTURES.glob("*.jpg"))
PNGS = sorted(p.name for p in FIXTURES.glob("*.png"))
MAX_LSB, MEAN_LSB = 3, 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test run's workers share the cores, and
    torch's own pool on each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the loaders' files and the
    server's checkpoint would stay on disk until pytest drops the run's
    directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 hidden from the port: ``import cv2`` raises ImportError."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _no_native(monkeypatch, reason: str = "g++ cannot include jpeglib.h "
               "here") -> None:
    """The port's native library unavailable, for ``reason``."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", reason)


def _within(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= MAX_LSB and diff.mean() < MEAN_LSB, (
        what, int(diff.max()), float(diff.mean()))


def _smooth(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (5, 5, 3), dtype=np.uint8)
    return cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)


# ------------------------------------------------- native loader against JAX


@pytest.mark.parametrize("name", JPEGS + PNGS)
def test_native_decode_matches_jax(name):
    path = str(FIXTURES / name)
    w, h = native_loader.image_dims(path)
    assert (w, h) == jax_native.image_dims(path)
    for target in (min(w, h), 32):
        np.testing.assert_array_equal(native_loader.decode_image(path,
                                                                 target),
                                      jax_native.decode_image(path, target))


@pytest.mark.parametrize("threads", [1, 4])
def test_native_load_batch_matches_jax(threads):
    paths = [str(FIXTURES / n) for n in JPEGS + PNGS]
    np.testing.assert_array_equal(
        native_loader.load_batch(paths, 40, n_threads=threads),
        jax_native.load_batch(paths, 40, n_threads=threads))
    with pytest.raises(IOError, match="missing.png"):
        native_loader.load_batch(paths[:2] + [str(FIXTURES / "missing.png")],
                                 40, n_threads=threads)


@pytest.fixture(scope="module")
def mixed_manifest(tmp_path_factory):
    """JPEG and PNG files at the loader's size, above it, below it and not
    square, and the committed fixtures."""
    root = tmp_path_factory.mktemp("mixed")
    names = []
    for i, (h, w, ext) in enumerate([(32, 32, "jpg"), (32, 32, "png"),
                                     (40, 24, "jpg"), (24, 40, "png"),
                                     (48, 48, "jpg"), (20, 20, "png"),
                                     (33, 35, "jpg"), (32, 32, "jpg")]):
        assert cv2.imwrite(str(root / f"{i}.{ext}"), _smooth(h, w, i),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
        names.append(str(root / f"{i}.{ext}"))
    names += [str(FIXTURES / n) for n in JPEGS + PNGS]
    (root / "images.txt").write_text("".join(n + "\n" for n in names))
    yield root / "images.txt"
    shutil.rmtree(root, ignore_errors=True)


def test_image_loader_matches_jax(mixed_manifest):
    port = loader.ImageLoader(mixed_manifest, 4, image_size=32, seed=3)
    jax = jax_loader.ImageLoader(mixed_manifest, 4, image_size=32, seed=3)
    assert port.decoder == "native" and jax.load_batch_fn is not None
    n = 0
    for (pb, pi), (jb, ji) in zip(port.epoch(0), jax.epoch(0), strict=True):
        np.testing.assert_array_equal(pb, jb)
        np.testing.assert_array_equal(pi, ji)
        n += 1
    assert n == len(port) // 4


def test_device_cache_dataset_matches_jax(mixed_manifest):
    port = DeviceDatasetCache(loader.ImageLoader(mixed_manifest, 4,
                                                 image_size=32),
                              device="cpu")
    jax = JaxDeviceCache(jax_loader.ImageLoader(mixed_manifest, 4,
                                                image_size=32))
    np.testing.assert_array_equal(port.dataset.numpy(),
                                  np.asarray(jax.dataset))


def test_probe_size_reads_the_chosen_decoder(tmp_path, monkeypatch):
    """``image_size=None`` probes through the chosen decoder: the native
    library's ``image_dims`` where it builds (with cv2 hidden), else cv2;
    with neither, the loader raises before it probes."""
    assert cv2.imwrite(str(tmp_path / "a.png"), _smooth(24, 24, 1))
    assert cv2.imwrite(str(tmp_path / "b.png"), _smooth(24, 30, 2))
    sq, wide = tmp_path / "sq.txt", tmp_path / "wide.txt"
    sq.write_text(str(tmp_path / "a.png") + "\n")
    wide.write_text(str(tmp_path / "b.png") + "\n")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        native = loader.ImageLoader(sq, 1)
        assert native.decoder == "native" and native.image_size == 24
        with pytest.raises(ValueError, match="not square"):
            loader.ImageLoader(wide, 1)
        with pytest.raises(RuntimeError, match="cv2 does not import"):
            loader.ImageLoader(sq, 1, use_native=False)
    bare = loader.ImageLoader(sq, 1, use_native=False)
    assert bare.decoder == "cv2" and bare.image_size == 24
    with pytest.raises(ValueError, match="not square"):
        loader.ImageLoader(wide, 1, use_native=False)


# ------------------------------------------------------ codec against cv2


@pytest.mark.parametrize("name", JPEGS + PNGS)
def test_decode_buffer_against_cv2(name):
    blob = (FIXTURES / name).read_bytes()
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(blob, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    _within(native_loader.decode_buffer(blob), want, name)


def test_encode_jpeg_against_cv2():
    """At quality 95 the port's JPEG decodes within the tolerance of cv2's;
    against the source, the PSNR of each (both ~42-45 dB on these smooth
    frames) agree within 0.1 dB."""
    for source in (np.load(FIXTURES / "source.npy"), _smooth(64, 40, 7)):
        ours = native_loader.encode_jpeg(source, 95)
        ok, theirs = cv2.imencode(".jpg", source[..., ::-1],
                                  [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok and ours[:3] == b"\xff\xd8\xff"
        got = cv2.imdecode(np.frombuffer(ours, np.uint8),
                           cv2.IMREAD_COLOR)[..., ::-1]
        want = cv2.imdecode(theirs, cv2.IMREAD_COLOR)[..., ::-1]
        _within(got, want, "encode_jpeg")

        def psnr(x):
            mse = np.mean((x.astype(np.float64) - source) ** 2)
            return 10 * np.log10(255.0 ** 2 / mse)

        assert psnr(got) > 38 and abs(psnr(got) - psnr(want)) < 0.1


@settings(max_examples=40, deadline=None)
@given(h=st.integers(8, 96), w=st.integers(8, 96), oh=st.integers(8, 96),
       ow=st.integers(8, 96), channels=st.sampled_from([0, 1, 3]),
       seed=st.integers(0, 2 ** 16))
def test_resize_cubic_matches_opencv(h, w, oh, ow, channels, seed):
    """Bit-equal to OpenCV's own INTER_CUBIC (IPP off); within 1 LSB of
    cv2's default (``channels`` 0 is a 2-D HW frame)."""
    shape = (h, w) if channels == 0 else (h, w, channels)
    frame = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    got = resize_cubic(frame, (ow, oh))
    assert got.shape == (oh, ow) + shape[2:]
    was = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        own = cv2.resize(frame, (ow, oh), interpolation=cv2.INTER_CUBIC)
        cv2.ipp.setUseIPP(True)
        default = cv2.resize(frame, (ow, oh), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(was)
    np.testing.assert_array_equal(got, own.reshape(got.shape))
    assert np.abs(got.astype(np.int16) - default.reshape(got.shape)
                  ).max() <= 1


@pytest.mark.parametrize("hw", [(480, 640), (64, 64), (50, 90), (97, 61)])
def test_crop_resize_and_prepare_frame_match_jax(hw, monkeypatch):
    """JAX's ``prepare_frame`` is its crop and cv2's cubic resize, then the
    BGR -> RGB flip; the port's ``crop_resize`` is the first two. With cv2
    the port resizes through it: bit-equal to JAX's. With cv2 hidden it
    resizes with ``resize_cubic``: bit-equal to JAX's with cv2's IPP off
    (within 1 LSB of its default, ``test_resize_cubic_matches_opencv``)."""
    frame = _smooth(*hw, seed=hw[0])
    for width, height in ((64, 64), (48, 32)):
        want = jax_inference.prepare_frame(frame, width, height)
        np.testing.assert_array_equal(
            inference.prepare_frame(frame, width, height), want)
        np.testing.assert_array_equal(
            inference.crop_resize(frame, width, height), want[..., ::-1])
        was = cv2.ipp.useIPP()
        cv2.ipp.setUseIPP(False)
        try:
            want = jax_inference.prepare_frame(frame, width, height)
        finally:
            cv2.ipp.setUseIPP(was)
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)
            got = inference.prepare_frame(frame, width, height)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the server


@pytest.fixture(scope="module")
def swap_server(tmp_path_factory):
    """A 64^2 resnet18 port engine on the CPU behind SwapServer."""
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        mode="denoise", data_path_a="a.txt", data_path_b="b.txt",
        batch_size=2, encoder_name="resnet18", compute_dtype="float32",
        image_size=64))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=64,
                              device="cpu")
    root = tmp_path_factory.mktemp("codec_server")
    ckpt = root / "ckpt"
    CheckpointManager(ckpt).save(1, trainer.init_states(seed=0),
                                 dataclasses.asdict(cfg))
    engine = SwapEngine(ckpt, "a", height=64, width=64, batch_size=2,
                        device="cpu")
    server = SwapServer(engine, host="127.0.0.1", port=0)
    server.start()
    yield engine, server
    server.shutdown()
    shutil.rmtree(root, ignore_errors=True)


def _post_swap(port: int, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/swap", body=body,
                     headers={"Content-Type": "image/jpeg"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_swap_encoded_route(swap_server, monkeypatch):
    """With cv2, byte-equal to the JAX server's recipe around the same
    engine; with cv2 hidden, the native codec's reply decodes within the
    tolerance of it."""
    engine, server = swap_server
    ok, body = cv2.imencode(".jpg", _smooth(96, 128, 5),
                            [cv2.IMWRITE_JPEG_QUALITY, 95])
    body = body.tobytes()
    frame_bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    fake = engine.swap(jax_inference.prepare_frame(frame_bgr, 64, 64))
    ok, want = cv2.imencode(".jpg", fake[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 95])
    status, got = _post_swap(server.port, body)
    assert status == 200 and got == want.tobytes()
    monkeypatch.setitem(sys.modules, "cv2", None)
    status, bare = _post_swap(server.port, body)
    assert status == 200
    _within(native_loader.decode_buffer(bare),
            native_loader.decode_buffer(got), "the route without cv2")
    status, _ = _post_swap(server.port, b"not an image")
    assert status == 400


# ------------------------------------------------------- decoder selection


def test_loader_names_its_decoder_and_what_is_missing(mixed_manifest,
                                                       no_cv2, monkeypatch):
    """JAX's rule: ``decode_fn``, then the native library, then cv2; with
    neither of the last two the loader, ``decode_bytes`` and
    ``encode_jpeg`` raise, naming what is missing."""
    assert loader.ImageLoader(mixed_manifest, 4, image_size=32
                              ).decoder == "native"
    assert loader.ImageLoader(mixed_manifest, 4, image_size=32,
                              decode_fn=np.load).decoder == "decode_fn"
    with pytest.raises(RuntimeError, match=(
            r"no codec for the images of .*images\.txt here: the native "
            r"loader is off \(use_native=False\), and cv2 does not import")):
        loader.ImageLoader(mixed_manifest, 4, image_size=32,
                           use_native=False)
    _no_native(monkeypatch)
    absent = (r"there is no native loader \(g\+\+ cannot include jpeglib\.h "
              r"here\), and cv2 does not import")
    with pytest.raises(RuntimeError, match=absent):
        loader.ImageLoader(mixed_manifest, 4, image_size=32)
    assert loader.ImageLoader(mixed_manifest, 4, image_size=32,
                              decode_fn=np.load).decoder == "decode_fn"
    with pytest.raises(RuntimeError, match="an image in memory.*" + absent):
        codec.decode_bytes((FIXTURES / JPEGS[0]).read_bytes())
    with pytest.raises(RuntimeError, match="JPEG encoding.*" + absent):
        codec.encode_jpeg(np.zeros((8, 8, 3), np.uint8))


def test_native_library_needs_its_headers_and_raises_if_it_cannot_load(
        mixed_manifest, monkeypatch):
    """Without a codec's header g++ builds nothing and the library is
    unavailable, the header named; with the headers, a library that does
    not load (one built on another machine, say) raises."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "HEADERS",
                        ("jpeglib.h", "no_such_codec.h"))
    built = []
    monkeypatch.setattr(native_loader._build, "load_host",
                        lambda *args: built.append(args))
    assert not native_loader.available() and not built
    assert native_loader.unavailable_reason() == (
        "g++ cannot include no_such_codec.h here")

    def does_not_load(*args):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "HEADERS", ("jpeglib.h", "png.h"))
    monkeypatch.setattr(native_loader._build, "load_host", does_not_load)
    with pytest.raises(OSError, match="libjpeg.so.62"):
        native_loader.available()
    with pytest.raises(OSError, match="libjpeg.so.62"):
        loader.ImageLoader(mixed_manifest, 4, image_size=32)


def test_loader_keeps_the_route_it_chose(mixed_manifest, monkeypatch):
    """The decoder and the resize are chosen when the loader is built: a
    cv2 loader goes on decoding and resizing through cv2, as JAX's, after
    cv2 is hidden."""
    port = loader.ImageLoader(mixed_manifest, 4, image_size=32, seed=5,
                              use_native=False)
    jax = jax_loader.ImageLoader(mixed_manifest, 4, image_size=32, seed=5,
                                 use_native=False)
    assert port.decoder == "cv2"
    want = [b for b, _ in jax.epoch(0)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = [b for b, _ in port.epoch(0)]
    assert port.decoder == "cv2" and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------- the decoder rule against JAX's


def _sidecar(path: str) -> np.ndarray:
    """A ``decode_fn`` that needs no codec: the frame saved beside the
    file."""
    return np.load(path + ".npy")


@pytest.fixture(scope="module")
def square_manifest(tmp_path_factory):
    """JPEG and PNG files at the loaders' size, so that no route resizes,
    each with a frame beside it for ``_sidecar``."""
    root = tmp_path_factory.mktemp("square")
    names = []
    for i, ext in enumerate(["jpg", "png", "jpg", "png", "jpg", "jpg"]):
        path = str(root / f"{i}.{ext}")
        assert cv2.imwrite(path, _smooth(32, 32, 20 + i),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
        np.save(path + ".npy", _smooth(32, 32, 40 + i))
        names.append(path)
    (root / "images.txt").write_text("".join(n + "\n" for n in names))
    yield root / "images.txt"
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("with_cv2", [True, False], ids=["cv2", "no_cv2"])
@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "no_native"])
@pytest.mark.parametrize("use_native", [True, False],
                         ids=["use_native", "native_off"])
@pytest.mark.parametrize("decode_fn", [None, _sidecar],
                         ids=["default", "decode_fn"])
def test_decoder_rule_matches_jax(square_manifest, decode_fn, use_native,
                                  native, with_cv2, monkeypatch):
    """Every combination of ``decode_fn``, ``use_native``, the native
    library (unavailable in both packages) and cv2 (hidden from both):
    where JAX's ``ImageLoader`` yields batches, the port's yields the same
    bytes; where JAX's raises for want of a decoder (its ``default_decode``
    imports cv2), the port's raises, naming what is missing."""
    if not native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
        _no_native(monkeypatch, "no libjpeg here")
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)

    def epoch(make):
        ld = make(square_manifest, 2, image_size=32, seed=4,
                  decode_fn=decode_fn, use_native=use_native)
        return [(b.copy(), i) for b, i in ld.epoch(0)]

    try:
        want = epoch(jax_loader.ImageLoader)
    except ImportError as e:
        assert "cv2" in str(e)
        assert decode_fn is None and not with_cv2
        assert not (use_native and native)
        off = ("no libjpeg here" if not native
               else "the native loader is off (use_native=False)")
        with pytest.raises(RuntimeError) as got:
            epoch(loader.ImageLoader)
        assert "cv2 does not import" in str(got.value)
        assert off in str(got.value)
        return
    got = epoch(loader.ImageLoader)
    assert len(got) == len(want) == 3
    for (gb, gi), (wb, wi) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gi, wi)


def test_swap_encoded_route_without_a_codec(swap_server, monkeypatch):
    """With neither cv2 nor the native library, ``POST /v1/swap`` fails
    with an error naming what is missing (the JAX server needs cv2)."""
    engine, server = swap_server
    ok, body = cv2.imencode(".jpg", _smooth(96, 128, 6),
                            [cv2.IMWRITE_JPEG_QUALITY, 95])
    monkeypatch.setitem(sys.modules, "cv2", None)
    _no_native(monkeypatch, "no libjpeg here")
    status, reply = _post_swap(server.port, body.tobytes())
    assert status == 500
    error = json.loads(reply)["error"]
    assert error.startswith("RuntimeError: no codec for an image in memory")
    assert "no libjpeg here" in error and "cv2 does not import" in error
