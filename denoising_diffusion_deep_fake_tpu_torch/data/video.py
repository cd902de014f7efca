"""Video tools: dataset prep and batched face-swap rendering.

Port of ``denoising_diffusion_deep_fake_tpu/data/video.py:1-261`` (the
reference's script tools ``video_to_center_cropped_images.py``,
``video_writer_context_manager.py`` and
``put_video_through_fake_model.py``):

* ``video_to_center_cropped_images``: decode, centre-crop to the target
  aspect, cubic resize, write the frames and an ``images.txt`` manifest;
* ``VideoWriter``: a context-managed cv2 mp4 writer;
* ``render_fake_video``: the swap renderer. A reader thread decodes, crops
  and batches frames; the calling thread uploads each batch and dispatches
  the swap pipeline (``inference.make_device_pipeline``); a writer thread
  fetches the result and writes the side-by-side real|fake BGR frame.
  Every batch has the one static size: the tail is padded with its last
  frame, so a frame meets the batch composition it would meet in the JAX
  renderer (cuDNN's bf16 convolutions give a frame other low bits in
  another batch slot or size). ``transfer="i420"`` sends 4:2:0-packed
  uint8 both ways, half the bytes, packed and unpacked on the host with
  ``ops.image``'s functions.

cv2 is imported only where a video file is read or written, or a frame
needs a resize: ``render_fake_video`` also takes ``frames=``, an iterable
of BGR uint8 frames, and ``write_frame=``, a callable given each
side-by-side frame, so a machine without cv2 renders frames already at the
model's size.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.data.loader import _threaded
from denoising_diffusion_deep_fake_tpu_torch.inference import (
    crop_resize,
    load_swap_model,
    make_device_pipeline,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
    pack_rgb_batch_to_i420_np,
    unpack_i420_batch_to_rgb_np,
)


class VideoWriter:
    """Context-managed cv2 mp4 writer (the reference's context manager)."""

    def __init__(self, path, fps: float, width: int, height: int):
        self.path = str(path)
        self.fps = fps
        self.size = (width, height)
        self.writer = None

    def __enter__(self):
        import cv2

        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self.writer = cv2.VideoWriter(self.path, fourcc, self.fps, self.size)
        return self.writer

    def __exit__(self, *exc):
        if self.writer is not None:
            self.writer.release()
        return False


def read_video(video_path):
    """The BGR uint8 frames of a video file, in order (cv2)."""
    import cv2

    capture = cv2.VideoCapture(str(video_path))
    if not capture.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    try:
        while True:
            ok, frame = capture.read()
            if not ok:
                return
            yield frame
    finally:
        capture.release()


def video_to_center_cropped_images(video_path, output_dir, width: int,
                                   height: int, *, ext: str = "jpg") -> Path:
    """Decode a video into centre-cropped, resized frames + manifest."""
    import cv2

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for index, frame in enumerate(read_video(video_path)):
        name = f"{index:06d}.{ext}"
        cv2.imwrite(str(output_dir / name), crop_resize(frame, width, height))
        names.append(name)
    manifest = output_dir / "images.txt"
    manifest.write_text("".join(f"{n}\n" for n in names))
    return manifest


def probe_fps(video_path) -> float:
    import cv2

    capture = cv2.VideoCapture(str(video_path))
    try:
        fps = capture.get(cv2.CAP_PROP_FPS)
    finally:
        capture.release()
    return fps or 24.0


def frame_batches(frames: Iterable[np.ndarray], width: int, height: int,
                  batch_size: int, transfer: str = "rgb"):
    """``(frames_bgr, upload, n_valid)`` per batch of ``batch_size``: the
    cropped BGR stack for the display half and the upload in the wire
    format, NHWC RGB or (B, H*3/2, W) i420. The tail is padded with its
    last frame; ``n_valid`` counts the real ones."""
    def emit(stack, n_valid):
        stack = np.stack(stack)
        rgb = np.ascontiguousarray(stack[..., ::-1])
        upload = pack_rgb_batch_to_i420_np(rgb) if transfer == "i420" else rgb
        return stack, upload, n_valid

    batch = []
    for frame in frames:
        batch.append(crop_resize(frame, width, height))
        if len(batch) == batch_size:
            yield emit(batch, batch_size)
            batch = []
    if batch:
        n_valid = len(batch)
        batch.extend([batch[-1]] * (batch_size - n_valid))
        yield emit(batch, n_valid)


def render_fake_video(video_path, checkpoint_path, model_a_or_b: str, *,
                      width: int = 448, height: int = 448,
                      output_path=None, batch_size: int = 8,
                      sampler_steps: int = 0, use_ema: bool | None = None,
                      transfer: str = "rgb", progress: bool = True,
                      stats_out: dict | None = None, device=None,
                      frames: Iterable[np.ndarray] | None = None,
                      write_frame: Callable[[np.ndarray], None] | None = None
                      ) -> Path | None:
    """Stream a video through the swap model; write side-by-side
    real|fake BGR frames of ``height x 2 width``.

    Model "a" swaps through model a and de/normalises with identity b's
    statistics, and vice versa (``put_video_through_fake_model.py``,
    ``lit_module.py:251-257``). The frames come from ``video_path``, or
    from ``frames`` when given; they go to an mp4 at ``output_path``
    (default ``<video>_fake_<a|b>.mp4`` beside the video) at the video's
    fps, or to ``write_frame`` when given (then nothing is written and
    ``None`` is returned). Runs on ``cuda`` unless given ``device``.
    ``stats_out`` receives ``batches``, ``frames``, ``first_batch_s``,
    ``steady_batch_s``, ``steady_fps`` (the dispatch rate) and
    ``delivered_fps`` (frames written after the first batch's, over the
    time since it was written).
    """
    model = load_swap_model(checkpoint_path, model_a_or_b,
                            use_ema=bool(use_ema), image_size=height,
                            device=device)
    pipeline = make_device_pipeline(model, sampler_steps=sampler_steps,
                                    transfer=transfer)
    if frames is None:
        frames = read_video(video_path)
    writer_ctx = None
    if write_frame is None:
        if output_path is None:
            v = Path(video_path)
            output_path = v.with_name(f"{v.stem}_fake_{model_a_or_b}.mp4")
        writer_ctx = VideoWriter(output_path, probe_fps(video_path),
                                 width * 2, height)

    results: queue.Queue = queue.Queue(maxsize=3)
    counters = {"frames": 0}
    failed: list[BaseException] = []

    def writer_main(write):
        while True:
            item = results.get()
            if item is None:
                return
            if failed:
                continue  # drain, so the dispatching thread never blocks
            try:
                frames_bgr, fake_dev, n_valid = item
                fake = fake_dev.cpu().numpy()[:n_valid]
                if transfer == "i420":
                    fake = unpack_i420_batch_to_rgb_np(fake)
                for real_bgr, fake_rgb in zip(frames_bgr[:n_valid], fake):
                    write(np.concatenate([real_bgr, fake_rgb[..., ::-1]],
                                         axis=1))
                    counters["frames"] += 1
                now = time.perf_counter()
                counters.setdefault("t_first_done", now)
                counters.setdefault("first_batch_frames", counters["frames"])
                counters["t_last_done"] = now
            except BaseException as e:  # raised on the calling thread
                failed.append(e)

    def run_writer():
        if writer_ctx is None:
            writer_main(write_frame)
            return
        try:
            with writer_ctx as w:
                writer_main(w.write)
        except BaseException as e:
            failed.append(e)

    dev = model.device
    writer = threading.Thread(target=run_writer, daemon=True)
    writer.start()
    batch_idx = 0
    batch_times = []
    t_prev = time.perf_counter()
    try:
        for frames_bgr, upload, n_valid in _threaded(
                lambda put: all(put(b) for b in frame_batches(
                    frames, width, height, batch_size, transfer)), 4):
            if failed:
                break
            host = torch.from_numpy(upload)
            if dev.type == "cuda":
                host = host.pin_memory()
            fake_dev = pipeline(host.to(dev, non_blocking=True), batch_idx)
            results.put((frames_bgr, fake_dev, n_valid))
            now = time.perf_counter()
            batch_times.append(now - t_prev)
            t_prev = now
            batch_idx += 1
            if progress and batch_idx % 10 == 0:
                print(f"rendered {counters['frames']} frames", flush=True)
    finally:
        results.put(None)
        writer.join()
    if failed:
        raise failed[0]
    if stats_out is not None:
        steady = batch_times[2:] or batch_times
        stats_out["batches"] = batch_idx
        stats_out["first_batch_s"] = batch_times[0] if batch_times else 0.0
        stats_out["steady_batch_s"] = (sum(steady) / len(steady)
                                       if steady else 0.0)
        stats_out["steady_fps"] = (batch_size / stats_out["steady_batch_s"]
                                   if stats_out["steady_batch_s"] else 0.0)
        span = (counters.get("t_last_done", 0.0)
                - counters.get("t_first_done", 0.0))
        delivered = counters["frames"] - counters.get("first_batch_frames",
                                                      counters["frames"])
        stats_out["delivered_fps"] = delivered / span if span > 0 else 0.0
        stats_out["frames"] = counters["frames"]
    return None if write_frame is not None else Path(output_path)
