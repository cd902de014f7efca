"""The port's video tools, ``video`` and ``serve`` commands, on the CPU.

* ``video_to_center_cropped_images`` against the JAX package's on the same
  small cv2 mp4: the same file names and manifest, every frame file
  bit-equal (a video that needs the crop and resize, and one already at
  size, where the port skips cv2's resize: a copy in cv2 too).
* ``render_fake_video`` fed ``frames=`` and collecting ``write_frame=``:
  single-pass rgb, single-pass i420 and DDIM at 3 steps. Ten frames in
  batches of 4, so the tail of 2 is padded to 4 with its last frame; every
  output is the real frame beside the pipeline's fake of the batch that
  carried it (packed and unpacked on the host for i420), bit for bit.
* the same through a real cv2 mp4 in and out: frame count, 2W x H, fps.
* ``video prep``, ``video swap`` and ``serve --check`` through ``main.py``
  with ``--device cpu`` (their option names against the JAX package's:
  ``tests/test_torch_port_cli.py``).

32^2, resnet18, fp32; cv2 writes and reads the videos here (the card
machine has none, hence ``frames=`` and ``write_frame=``).
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from denoising_diffusion_deep_fake_tpu.data import video as jax_video
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch import inference
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.data import video
from denoising_diffusion_deep_fake_tpu_torch.main import main
from denoising_diffusion_deep_fake_tpu_torch.ops import image
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)

cv2 = pytest.importorskip("cv2")

SIZE, BATCH, N_FRAMES = 32, 4, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the checkpoints and videos
    written here would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("video")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def checkpoint(root):
    """A swap-mode pair at 32^2 (shadows for ``use_ema``), saved by the
    port's manager."""
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        mode="swap", data_path_a="a", data_path_b="b", batch_size=2,
        encoder_name="resnet18", compute_dtype="float32", image_size=SIZE,
        mean_a=(0.485, 0.456, 0.406), std_a=(0.229, 0.224, 0.225)))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=SIZE,
                              device="cpu")
    CheckpointManager(root / "ckpt").save(1, trainer.init_states(seed=0),
                                          dataclasses.asdict(cfg))
    return root / "ckpt"


def _bgr_frames(n, h, w, seed):
    return list(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                      np.uint8))


def _write_mp4(path, frames, fps=12.0):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    for f in frames:
        writer.write(f)
    writer.release()
    return path


@pytest.mark.parametrize("hw", [(48, 80), (SIZE, SIZE)])
def test_video_prep_matches_jax(root, hw):
    mp4 = _write_mp4(root / f"prep_{hw[0]}x{hw[1]}.mp4",
                     _bgr_frames(6, *hw, seed=1))
    want = jax_video.video_to_center_cropped_images(
        mp4, root / f"jax_{hw[0]}", SIZE, SIZE)
    got = video.video_to_center_cropped_images(mp4, root / f"port_{hw[0]}",
                                               SIZE, SIZE)
    names = want.read_text().split()
    assert got.name == "images.txt" and got.read_text() == want.read_text()
    assert len(names) == 6
    for name in names:
        assert (got.parent / name).read_bytes() == \
            (want.parent / name).read_bytes(), name


def _expected(checkpoint, frames, transfer, steps):
    """Each input frame beside the pipeline's fake of its padded batch."""
    model = inference.load_swap_model(checkpoint, "a", device="cpu")
    pipe = inference.make_device_pipeline(model, sampler_steps=steps,
                                          transfer=transfer)
    out = []
    for k in range(0, len(frames), BATCH):
        batch = frames[k:k + BATCH]
        n_valid = len(batch)
        batch = batch + [batch[-1]] * (BATCH - n_valid)
        rgb = np.ascontiguousarray(np.stack(batch)[..., ::-1])
        if transfer == "i420":
            fake = image.unpack_i420_batch_to_rgb_np(pipe(torch.from_numpy(
                image.pack_rgb_batch_to_i420_np(rgb)), k // BATCH).numpy())
        else:
            fake = pipe(torch.from_numpy(rgb), k // BATCH).numpy()
        out += [np.concatenate([f, g[..., ::-1]], axis=1)
                for f, g in zip(batch[:n_valid], fake[:n_valid])]
    return out


@pytest.mark.parametrize("transfer,steps", [("rgb", 0), ("i420", 0),
                                            ("rgb", 3)])
def test_render_from_frames_matches_the_pipeline(checkpoint, transfer,
                                                 steps):
    frames = _bgr_frames(N_FRAMES, SIZE, SIZE, seed=2)
    written, stats = [], {}
    out = video.render_fake_video(
        None, checkpoint, "a", width=SIZE, height=SIZE, batch_size=BATCH,
        sampler_steps=steps, transfer=transfer, progress=False,
        stats_out=stats, device="cpu", frames=iter(frames),
        write_frame=written.append)
    assert out is None
    assert len(written) == N_FRAMES
    want = _expected(checkpoint, frames, transfer, steps)
    for k, (got, w) in enumerate(zip(written, want)):
        assert got.shape == (SIZE, 2 * SIZE, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, w, err_msg=f"frame {k}")
    assert stats["frames"] == N_FRAMES and stats["batches"] == 3
    for key in ("first_batch_s", "steady_batch_s", "steady_fps",
                "delivered_fps"):
        assert stats[key] >= 0, key


def test_render_through_mp4(root, checkpoint):
    """A 40x48 video (cropped and resized to 32^2) in, an mp4 out: every
    frame, twice the width, the input's fps."""
    src = _write_mp4(root / "in.mp4", _bgr_frames(7, 40, 48, seed=3),
                     fps=15.0)
    out = video.render_fake_video(src, checkpoint, "b", width=SIZE,
                                  height=SIZE, batch_size=BATCH,
                                  progress=False, device="cpu")
    assert out == root / "in_fake_b.mp4"
    capture = cv2.VideoCapture(str(out))
    try:
        assert capture.get(cv2.CAP_PROP_FPS) == pytest.approx(15.0)
        frames = []
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        capture.release()
    assert len(frames) == 7
    assert all(f.shape == (SIZE, 2 * SIZE, 3) for f in frames)


def test_render_surfaces_a_writer_error(checkpoint):
    def broken(frame):
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        video.render_fake_video(
            None, checkpoint, "a", width=SIZE, height=SIZE,
            batch_size=BATCH, progress=False, device="cpu",
            frames=iter(_bgr_frames(N_FRAMES, SIZE, SIZE, seed=4)),
            write_frame=broken)


# ---------------------------------------------------------------- the CLI


def test_video_commands(root, checkpoint):
    src = _write_mp4(root / "cli.mp4", _bgr_frames(5, 48, 80, seed=5))
    main(["video", "prep", str(src), str(root / "cli_frames"), "--width",
          str(SIZE), "--height", str(SIZE), "--device", "cpu"])
    assert len((root / "cli_frames" / "images.txt").read_text().split()) == 5
    out = root / "cli_fake.mp4"
    main(["video", "swap", str(src), str(checkpoint), "a", "--width",
          str(SIZE), "--height", str(SIZE), "--output", str(out),
          "--batch_size", "2", "--transfer", "i420", "--device", "cpu"])
    capture = cv2.VideoCapture(str(out))
    try:
        n = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
        w = int(capture.get(cv2.CAP_PROP_FRAME_WIDTH))
    finally:
        capture.release()
    assert (n, w) == (5, 2 * SIZE)


def test_serve_check(checkpoint, capsys):
    main(["serve", str(checkpoint), "both", "--width", str(SIZE),
          "--height", str(SIZE), "--batch_size", "2", "--transfer", "i420",
          "--check", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [x["engine"] for x in lines] == ["a", "b"]
    assert all(x["serve_check"] == "ok" and x["transfer"] == "i420"
               and x["batches"] == 1 for x in lines)
    # Two replicas (they share the CPU here).
    main(["serve", str(checkpoint), "a", "--devices", "2", "--check",
          "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [(x["engine"], x["devices"], x["serve_check"]) for x in lines] \
        == [("a", 2, "ok")]


def test_port_and_chip_smoke_import_without_cv2():
    """The card machine has no cv2: every module of the port, and
    ``chip_smoke.py``, imports with cv2 made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['cv2'] = None\n"
        "import denoising_diffusion_deep_fake_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'denoising_diffusion_deep_fake_tpu_torch.data.video' in "
        "names\n")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parent.parent, check=True,
                   timeout=300)
