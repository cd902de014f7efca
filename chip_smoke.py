"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py [--profile-out PATH]
    python3 chip_smoke.py --spatial-cards   # phase 20d alone, 4 cards

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ops/cuda/csrc (nvcc, sm_90a), one nvcc
   per source, all started together;
3. each kernel against its plain PyTorch version at the shapes its path
   gives it, with the kernel's and the plain version's times and the least
   time the card could take: the warp kernels bit-equal (the fused warp,
   one launch, with both stat sets and at the corners of the augment's
   ranges, timed alone into a preallocated output, uint8 in and, as an
   i420 upload reaches it, fp32 in with the normalise folded in,
   graph-timed; the axis pass's row and
   column kernels each on the x-pass and the y-pass layout at 448^2 x 16
   and 640^2 x 4, each pass timed alone, and the whole two-pass warp at
   640^2 x 4, at the range corners too; both routes also on the deep-fake
   trainer's ShiftScaleRotate draws, where some samples are not warped;
   the fused warp at 640^2 x 4, recorded only); the noise kernels'
   Philox words bit-equal, their outputs within one ulp (share of differing
   elements stated), ratio 0 exactly the normalisation, and the noise's
   moments, bound, cross-sample correlation and determinism, each noise
   kernel timed alone by CUDA-graph replay;
4. a small-input reference: one fp32 train step at 64^2 on the GPU against
   the same step on the CPU (plain versions), from the same weights and
   the same injected randomness;
5. the main path: the denoiser trainer at the width of
   configs/denoiser.yml (resnet34 U-Net, batch 16, bf16) at 448^2, whose
   auto warp route is the fused kernel and whose noise stage is the fp32
   noise kernel: 3 warm-up and 30 timed steps, then one eval-mode forward
   and a profile of 3 more steps;
6. the two-pass route: the same trainer at 640^2, batch 4 (auto routes
   sizes above 512^2 to the two-pass kernels), 2 warm-up and 10 timed
   steps, then a profile of 3 more;
7. the balancer: configs/balance.yml's width (resnet34, batch 12, bf16,
   lr 0.01, ratio 0.7, 10 classes) at 448^2: 3 warm-up and 20 timed train
   steps through the uint8 noise kernel, a profile of 3 more, then the
   scoring pass over 50 images (5 batches, the last padded from 2 to 12),
   difficulty classes, and the balanced manifest written and read back;
8. the deep-fake trainer: (a) one fp32 swap step at 64^2, batch 2,
   resnet18, on the GPU against the same step on the CPU (plain versions),
   from the same weights (shadows apart from their models, past the EMA
   warm-up) and the same injected randomness; (b) denoise mode at the
   width of configs/denoise.yml (two resnet34 U-Nets, batch 16 per
   identity, bf16) at 448^2: 2 warm-up and 10 timed steps, each warping
   both identities with the fused kernel and noising both with the fp32
   noise kernel, then a profile of 3 more; (c) the flip to swap mode with
   configs/swap.yml overlaid: shadows that are copies, then one step whose
   decay-0 updates copy b before its step and a after its; (d) swap mode
   from there, past the EMA warm-up: 3 warm-up and 20 timed steps, the
   shadows moving, the single-pass forward through model and shadow, and
   a profile of 3 more;
9. serving, from 8d's swap-mode states: (a) saved through the port's
   CheckpointManager and loaded back per identity, model and shadow, bit
   for bit; (b) a 64^2 fp32 resnet18 pair's uint8 pipeline on the GPU
   against the CPU (single-pass within 1 LSB, DDIM at 3 steps with the
   noise injected within 1e-4); (c) the single-pass pipeline at 448^2 x
   16 (configs/swap.yml's batch), no noise launch; (d) the DDIM pipeline
   at 448^2 x 8, 10 steps: one fp32 noise kernel launch a batch, its
   blend equal to the plain version's, the same batch index giving the
   same frames and another index other frames; (e) SwapEngine at 448^2,
   batch 8, behind SwapServer on 127.0.0.1: 4 client threads post 2
   untimed and then 75 timed /v1/swap_raw requests each, every reply
   bit-equal to the output of the device batch that carried it and that
   batch within 1 LSB of the pipeline run directly on it; /healthz,
   /v1/stats and a bad X-Shape;
10. training from disk, through the runners (training/runners.py) and
   their loop, on .npy frames read with ``decode_fn=np.load`` (phase 15
   reads JPEG files): (a) two identities of 48 uint8 448^2 frames and
   their manifests; (b) fit_denoiser at phase 5's width for 2 epochs of 3
   steps (one fused warp and one fp32 noise launch a step), its event file
   read back with every record's CRC checked, its final checkpoint
   restored bit for bit (weights, BN buffers, Adam's moments and steps,
   the generator), epoch 2's rate through the loop beside phase 5's; (c)
   fit_deep_fake in denoise mode (16 per identity) for 1 epoch, then
   resumed to epoch 2 from its checkpoint, and at 64^2 (resnet18, fp32,
   cudnn.deterministic) 2 epochs against 1 epoch and a resume, every
   tensor bit-equal; (d) modify to swap mode (configs/swap.yml overlaid)
   for 3 steps: a fresh Adam, shadows that are the models at the flip;
   then load_swap_model from its checkpoint answers a batch; (e)
   fit_balance at 448^2 x 12 for 1 epoch (one uint8 noise launch a step
   and a scoring batch), the balanced manifest and the histogram image in
   the event file; (f) the checkpoints' bytes, save and restore times and
   the phase's peak memory;
11. the i420 wire format and video render, from 9a's checkpoint and 10a's
   frames: (a) rgb_to_i420 and i420_to_rgb at 448^2 x 16 on the card
   against the CPU (pack within 1 LSB, unpack within 1e-3), the host pack
   and unpack against cv2's converters bit for bit (the JAX package's) and
   the device's within 1 LSB and 2 of them (bit-equal to the device's
   where cv2 does not import), and the times of a batch's host pack and
   device pack and unpack; (b) ``upload_format: i420`` at full width: the
   denoiser at 448^2 x 16 (3 + 20 steps, one fused warp on fp32 input and
   one fp32 noise launch a step, a profile of 3 more), the deep-fake
   trainer in denoise mode (2 + 5 steps, 2 and 2 a step), the balancer at
   448^2 x 12 (3 + 10 steps, one fp32 noise launch a step and no uint8
   one), each rate beside its rgb phase's; a 64^2 fp32 denoiser step and
   balancer step on the GPU against the CPU; fit_denoiser from 10a's
   frames for 1 epoch of 3 steps, packed on its prefetch thread; (c) the
   i420 pipeline, single-pass at 448^2 x 16 and DDIM at 448^2 x 8 with 10
   steps (one fp32 noise launch a batch), timed as 9c and 9d; a batch's
   upload and fetch, RGB and i420, by CUDA events; a 64^2 fp32 pair's i420
   pipeline on the GPU against the CPU (1 LSB); (d) SwapEngine with the
   i420 wire behind SwapServer: 4 clients x 25 timed ``X-Format: i420``
   requests held as in 9e, an i420 client on an rgb engine and an rgb
   client on an i420 engine; (e) render_fake_video from 60 random 448^2
   BGR frames into ``write_frame`` (the tail of 4 padded to 8): rgb and
   i420 single-pass and DDIM at 10 steps, 60 side-by-side frames each,
   every fake half bit-equal to its batch's output, one fp32 noise launch
   a DDIM batch;
12. K train steps as one CUDA graph (``steps_per_call``,
   training/multi_step.py): (a) both noise kernels' device-offset launch
   (the form a graph replays) bit-equal to the by-value one, Philox words
   and whole outputs, at offsets below and above 2^32, both forms
   graph-timed; (b) at 64^2 x2, resnet18, fp32, cudnn.deterministic, 2
   replays of a K = 3 graph against 6 eager steps from equal states for
   the denoiser, the balancer and deep-fake denoise and swap mode (the
   swap run crossing the EMA warm-up inside a group): every weight, BN
   buffer, Adam moment and step, shadow, loss, counter and the generator
   bit-equal, K launches of each kernel a step's a replay; a restored
   optimizer (denoiser) and the flip to swap mode must each capture a new
   graph that again matches eager steps; (c) the trainers and states of
   phases 5, 6, 7, 8b and 8d go on with K = 16 (8 for the deep-fake
   trainer): the first call (warm-up, capture, first replay), 2 timed
   groups beside the eager phase's rate, kernels a step and the idle share
   of one profiled group, peak memory, launches; (d) fit_denoiser from
   10a's frames with K = 2 (a group and the tail single an epoch, one
   event row a step); (e) a grouped 64^2 fit_deep_fake resumed from its
   checkpoint, bit-equal to the uninterrupted grouped run.
13. data on the device (``data_cache: device``, data/device_cache.py,
   training/cached.py): (a) at 64^2 x2, resnet18, fp32,
   cudnn.deterministic, each runner from the cache against the host
   loader: fit_denoiser at K = 1 and K = 3 (4 steps an epoch: a group and
   the tail single), fit_deep_fake in swap mode at K = 2 and a resume of
   the cached run, fit_balance with its scoring from the cache: every
   weight, BN buffer, Adam moment, shadow, counter, the generator and
   every event row bit-equal, the balanced manifests equal, one graph
   captured across a K-step run's epochs; (b) at full width from 256
   frames of 448^2, host loader against cache, 3 epochs each:
   fit_denoiser x16 eager and at K = 16, fit_deep_fake in denoise mode
   at K = 8 (16 per identity from 2 x 128 frames), fit_balance x12: imgs/s
   over epochs 2-3 on the host clock, each epoch boundary on the host
   clock and as the card's idle time, scoring ms; (c) no host batch load
   and no device_prefetch call in a cached run, and the host-to-device
   copies of one profiled cached epoch at K = 16 by count and bytes, as
   sent and as traced; (d) 10,000 frames of 448^2 (6.02 GB) made by a
   numpy decode_fn: decode and upload s, device and host memory, then K =
   16 for 32 steps.
14. the resnet encoder family and reference checkpoints in and out: (a)
   a 64^2 fp32 denoiser step on the GPU against the CPU for resnet50,
   resnext50_32x4d and wide_resnet50_2 (1e-4 relative); (b) the denoiser
   at 448^2 x16 bf16 with each of those encoders (2 warm-up and 5 timed
   steps, a profile of 3 more: imgs/s beside phase 5's resnet34, kernels
   and idle share a step, peak memory, one fused warp and one fp32 noise
   launch a step), then one eval forward at 448^2 x16 bf16 of resnet101,
   resnet152, resnext101_32x8d and wide_resnet101_2; every name's
   parameter count as the CPU tests pin it; (c) a reference Lightning
   .ckpt of a resnet34 pair in swap mode (configs/swap.yml over
   configs/denoise.yml, its data paths at 10a's frames) written here in
   the reference's layout, imported (seconds, bytes); the imported
   shadow's 448^2 x16 swap batch bit-equal to the .ckpt's shadow weights
   loaded straight; fit_deep_fake resumed from the import for one epoch
   of 3 steps, eager and as one K = 3 group captured on the imported
   fresh Adam (from epoch and global_step + 1, a fused Adam that took 3
   steps, 2 fused warps and 2 fp32 noise launches a step, finite losses);
   the grouped run's checkpoint exported and imported again, every model
   and shadow tensor bit-equal to the resumed states, its keys the
   .ckpt's less criterion.*; a resnet50 .ckpt imported and its swap batch
   checked the same way.
15. the reference's JPEG/PNG frames through the loader's route, the JAX
   package's rule (decode_fn, the native library, cv2, else an error
   naming what is missing; cv2 on the H100 machine): (a) the probe of
   what the machine has (``ctypes.util.find_library`` for jpeg,
   turbojpeg, png and z; jpeglib.h and png.h in /usr/include and
   /usr/local/include; g++, cv2, PIL), and the loader's decoder with cv2
   and with cv2 hidden from the port (``sys.modules["cv2"] = None``), each
   the one the probe implies; with neither cv2 nor the native library the
   loader raises, naming both; (b) every committed fixture of
   tests/data/codec through the loader's route against the committed cv2
   decode, within the JAX package's 3 / mean 1.0 LSB, and cv2's q95 round
   trip; (c) 2 x 256 JPEG frames of 448^2 and 8 of 512x384 written by
   ``cv2.imencode`` (q95, 4:2:0, smooth synthetic frames), then with no
   decode_fn, through cv2: fit_denoiser x16 host and data_cache device,
   eager and K = 16, 3 epochs each (imgs/s over epochs 2-3 beside 13b's
   .npy runs); fit_balance x12 for one epoch; the CLI's ``train new`` for
   3 steps; then the DeviceCache's decode of 1,024 entries and a host
   batch's decode; (d) 9a's engine behind SwapServer answering 4 clients x
   25 ``POST /v1/swap`` requests with JPEG bodies of 640x480 frames (crop
   and resize) through cv2: each reply 448^2 and byte-equal to cv2's JPEG
   of its device batch's output at its slot, each batch within 1 LSB of
   the pipeline on it; frames/s beside 9e's raw route, and the route's
   host stages timed a frame at a time.
16. color jitter, remat and the CLI's ``profile``: (a)
   ``color_jitter_normalised`` at 448^2 x16 fp32 with injected factors,
   card against CPU, and its time on the card; (b) at 64^2 x2 resnet18
   fp32 under cudnn.deterministic, a denoiser step and a deep-fake swap
   step (jitter on) with ``remat`` none, dots and full bit-equal to one
   another (weights, BN running statistics, Adam, losses, generator), a K
   = 3 graph with ``remat: dots`` and jitter on bit-equal to eager steps,
   and a step with ``warp_method`` shear and hybrid against the CPU; (c)
   the denoiser at 448^2 x16 resnet34 bf16 with each remat policy, eager
   (3 + 10 steps, a profile of 3) and at K = 16 (2 groups): imgs/s,
   kernels ms a step, peak memory; the jitter on against off; the 640^2
   x4 route with ``remat: dots``; (d) ``main.py profile --steps 8
   --report`` in a subprocess on 15c's JPEG manifest with jitter and
   ``remat: dots``: the report names ``warp_fused_kernel`` and
   ``noise_blend_f32_kernel`` with 8 launches each, its categories sum
   to its busy time within 1%, the trace directory is removed; (e) the
   deep-fake pair at 448^2 in swap mode with jitter and ``remat: dots``
   at K = 8 (2 groups) beside 12c's rate.
17. the eight other encoder families and the auto warp route below
   384^2: (a) a 64^2 fp32 denoiser step on the GPU against the CPU (1e-4
   relative) for vgg11 (conv biases, no BN), vgg16_bn, densenet121,
   se_resnext50_32x4d, mobilenet_v2, xception, inceptionv4,
   inceptionresnetv2 and dpn68b; (b) the denoiser at 448^2 x16 bf16
   (configs/denoiser.yml, only ``encoder_name`` changed) with each of
   those but vgg11 (2 warm-up and 5 timed steps, a profile of 3 more:
   imgs/s beside phase 5's resnet34, kernels and idle share a step, peak
   memory, one fused warp and one fp32 noise launch a step), then one eval
   forward at 448^2 x16 bf16 of each of the other 20 names; every name's
   parameter count as the CPU tests pin it; (c) a reference .ckpt of a
   densenet121 pair in swap mode and of a dpn68b pair in denoise mode,
   each imported, its 448^2 x16 swap batch bit-equal to the .ckpt's
   weights loaded straight, exported (every tensor the .ckpt's) and
   imported again bit-equal; (d) ``hybrid`` (auto at 256^2) against the
   two-pass kernels at 256^2 x16 and ``shear`` (auto at 100^2) against
   ``gather`` at 100^2 x16: ms, launches, the outputs' difference. Since
   the auto route is the JAX package's, the 64^2 paths of phases 10c,
   12b, 12e, 13a and 16b warp by ``hybrid`` and launch no pass kernel.
18. EfficientNet-b0..b7 with stochastic depth, and the patchified U-Net:
   (a) 64^2 fp32 denoiser steps on the GPU against the CPU (1e-4
   relative): efficientnet-b0 with the same drop masks given to both,
   resnet18 with ``patchify_stem: 2``; (b) at 64^2 x2 efficientnet-b0,
   fp32, ``remat: dots``, the masks drawn from each trainer's generator,
   under ``cudnn.deterministic``: 2 replays of a K = 3 graph bit-equal to
   6 eager steps for the denoiser, the balancer and the deep-fake swap
   pair (12b's check); (c) the denoiser at 448^2 x16 bf16 with
   efficientnet-b0, b4 and b7 and resnet34 with ``patchify_stem: 2`` (3 +
   10 steps, a profile of 3 with cuDNN's layout conversions counted, peak
   memory, one fused warp and one fp32 noise launch a step), b0 and the
   patchified resnet34 at K = 16, beside phase 5's rate; (d) one eval
   forward at 448^2 x16 bf16 of each of the eight names, their parameter
   counts, and a reference
   .ckpt of an efficientnet-b4 pair in swap mode imported, its swap
   batch bit-equal to its weights loaded straight, exported and imported
   again bit-equal; (e) the balancer at 448^2 x12 with efficientnet-b0 (3
   + 10 steps, one uint8 noise launch a step, a profile); (f) a
   measurement: a 448^2 x8 single-pass frame of 8d's model against its
   batch slot, with cuDNN's default and with ``cudnn.deterministic`` set
   only there, and the batch's time in each.
19. data parallelism (``parallel/``): (a) both noise kernels, by value
   and by device offset, at 448^2 x16 and 45^2 x6 (where a rank's element
   base is not a multiple of 4): a launch on rows ``[lb:]`` at its
   ``element_base`` bit-equal to those rows of the whole launch, Philox
   words too, and within one ulp of the plain version; (b) one rank over
   NCCL in a subprocess started by the ``D3F_*`` launch variables:
   ``fit_denoiser`` at 448^2 x16 resnet34 bf16 from 13b's 256 .npy frames
   through the device cache, 2 epochs of 16 steps, eager and at K = 16
   (one fused warp and one fp32 noise launch a step), its rates beside
   13b's; the same trainer driven 3 + 10 steps and profiled (kernels a
   step, device idle) beside phase 5, its K = 16 graph beside 12c; the
   step's collective census; the host's cost of one all-reduce; 12b's
   64^2 K = 3 graphs of the denoiser (with a restored optimizer's
   recapture) and the swap pair against eager steps inside the group; (c)
   two ranks
   on the one card over gloo, 64^2, a global batch of 4, resnet18, the
   U-Nets in float64, ``cudnn.deterministic``: one denoiser, swap-pair and
   balancer step against the one-process step on the card (the CPU test's
   tolerances), the ranks' states equal, a K-step graph refused under
   gloo, and ``fit_denoiser`` from the cache on both ranks with one
   checkpoint and one event file, by the primary.
20. spatial parallelism (``spatial_parallel: 2``, ``parallel/halo.py``):
   (a) both noise kernels, by value and by device offset, on a rank's
   rows with their row window, at 448^2 x16 over S = 2 and 4 and at 45^2
   x6 over S = 3 (runs that start inside a Philox group): bit-equal to
   those rows of the whole launch, within one ulp of the plain version,
   and timed by graph replay beside one contiguous run; (b) two
   ``--dp-worker spatial`` ranks on the one card over gloo, 64^2, a
   global batch of 2, resnet18, the U-Nets in float64,
   ``cudnn.deterministic``: the denoiser, swap-pair and balancer steps,
   and the denoiser at 32^2 (its deepest stage gathered and replicated),
   against the one-process step on the card at the CPU test's
   tolerances (the swap pair's with its loss in the ranks' row shares),
   the ranks' states equal; the denoiser under ``remat: dots`` and
   ``full`` bit-equal to it without; the census of one step;
   ``fit_denoiser`` for 4 steps from 64^2 .npy frames through the host
   loader; (c) phase 5's denoiser (448^2 x16, resnet34, bf16, phase 5's
   seed) over the two ranks: the first forward in fp32 and bf16 against
   one process's, and beside it the same forward with a broken
   exchange, the first step's loss against one process's, 3 warm-up and
   5 timed steps (imgs/s), each rank's peak memory beside phase 5's,
   kernels and idle a step (rank 0's profile), halo exchanges
   a step and the host's cost of one; (d) only with ``--spatial-cards``,
   in place of the phases: four ranks, a card each, over NCCL: the 64^2
   float64 steps at data 1 x spatial 4 (the denoiser) and data 2 x
   spatial 2 (the denoiser, the swap pair) against the one-process step
   on card 0, a K = 2 graph of the data 2 x spatial 2 denoiser
   bit-equal to two eager steps, and 20c's full-width denoiser and its
   checks at both layouts, eager and as K = 16 graphs, then 21c's
   efficientnet-b0 and patchified resnet34 at data 1 x spatial 4, eager
   and as K = 16 graphs (halos and SE sums captured; cuDNN's autotuning
   off, as in 21c);
21. spatial parallelism for the nine other encoder families and the
   patchified U-Net: (a) the noise kernels' row windows at the shapes
   (b) and (c) launch that 20a did not check (64^2 x2 over S = 2),
   bit-equal and within one ulp; (b) two ``--dp-worker
   spatial_families`` ranks on the one card over gloo, 64^2, a global
   batch of 2, float64 U-Nets, ``cudnn.deterministic``: a denoiser step
   of vgg11_bn, densenet121, se_resnext50_32x4d, efficientnet-b0 (drop
   on), mobilenet_v2, xception, inceptionv4, inceptionresnetv2, dpn68
   and resnet18 with ``patchify_stem: 2``, and b0's swap pair and
   balancer, each held against the one-process step on the card at the
   CPU test's tolerances (the swap pair's with its loss in row shares) by
   the rank that computed that step before it joined the group, both
   ranks' states bit-equal (digests); the census of a b0 step with its
   SE sums; (c)
   efficientnet-b0 and resnet34 with ``patchify_stem: 2`` at 448^2 x16
   bf16 over the two ranks: the fp32 first forward against one
   process's and with a broken exchange, the first loss, 3 + 5 steps
   (imgs/s), rank 0's kernels and idle a step, halos and SE sums a
   step, each rank's peak memory beside 18c's one process; cuDNN's
   autotuning off there and in the one process held against them (b0's
   first step at a rank's shapes would autotune for over a minute, and
   the two ranks' steps are host-bound).

Every profile of the script is a ``utils/profiling.py`` trace read by its
``analyze_trace``. It prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Every launch count is the count from the
path that runs the kernel, reset to 0 just before the path and read just
after it: ``launches`` from the kernel's first path, ``launches_by_path``
from each path that runs it. Without a GPU it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import faulthandler
import gc
import hashlib
import http.client
import json
import math
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
# int32 outside the tensor cores: 64 of an SM's 128 lanes a clock, so half
# the fp32 rate (the data sheet lists no int32 figure).
INT32_OPS_PER_S = 33.5e12
# fp32 operations one resample pass needs per output element: two residual
# taps (hat weight: 5 operations each, multiply-add: 2 each) and one
# band-matrix column (source position and its floor: 4; two taps of hat
# weight, bf16 rounding, product and sum: 8 each).
OPS_PER_PASS_ELEMENT = 34
# Operations of one noise-blend element, each counted once (a
# transcendental as one): int32, Philox4x32-10's 10 rounds of 2 low and 2
# high multiplies, 4 xors and 2 key adds per group of 4 (25) and the shift
# of the uniform (1); fp32, the uniform's convert, multiply and add (3),
# Box-Muller's log, two products, sqrt, cos and sin per pair (4 an element)
# and the blend's two products and sum (3), plus the uint8 kernel's
# subtract and divide (2).
NOISE_INT_OPS = 26
NOISE_FP_OPS = {"fused_normalise_noise_blend": 12, "fused_noise_blend": 10}
REPO = "denoising_diffusion_deep_fake_tpu"
CSRC = "denoising_diffusion_deep_fake_tpu_torch/ops/cuda/csrc"
KERNELS = {  # wrapper: (source, TPU kernel, device functions in a profile)
    "affine_warp_fused": ("warp.cu", "ops/pallas/warp_fused.py:140",
                          "warp_fused_kernel"),
    "warp_axis_pass": ("warp.cu", "ops/pallas/warp_kernel.py:126",
                       "warp_rows_kernel", "warp_cols_kernel"),
    "fused_normalise_noise_blend": ("noise.cu",
                                    "ops/pallas/noise_kernel.py:128",
                                    "normalise_noise_blend_u8_kernel"),
    "fused_noise_blend": ("noise.cu", "ops/pallas/noise_kernel.py:171",
                          "noise_blend_f32_kernel"),
}
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
HALF = ((0.5,) * 3, (0.5,) * 3)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, n_int_ops: float = 0.0
          ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / FP32_OPS_PER_S + n_int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Kernel vs plain version; the tolerance is 0 (bit equality)."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_err = float(diff.max())
    share = float((diff > 0).float().mean())
    log(f"  {what}: max|kernel - plain| {max_err:.3e}, differing share "
        f"{share:.3e}")
    check(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    check(max_err == 0.0, f"{what}: kernel disagrees with its plain version")
    return max_err


def compare_ulp(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Noise kernel vs plain version: within one ulp of the plain value
    (CUDA's logf/sincosf against PyTorch's CUDA log/sin/cos)."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) \
        - want.abs()
    max_err = float(diff.max())
    share = float((diff > 0).float().mean())
    log(f"  {what}: max|kernel - plain| {max_err:.3e}, differing share "
        f"{share:.3e}, max in ulps {float((diff / ulp).max()):.2f}")
    check(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    check(bool((diff <= ulp).all()), f"{what}: kernel more than one ulp "
          "from its plain version")
    return max_err


def noise_stats(eps: torch.Tensor, what: str) -> None:
    """Ratio-1 output = the noise itself: moments, bound, correlation."""
    mean, var = float(eps.mean()), float(eps.var())
    peak = float(eps.abs().max())
    corr = float(torch.corrcoef(eps[:2].reshape(2, -1))[0, 1])
    log(f"  {what} noise: mean {mean:.2e}, var - 1 {var - 1:.2e}, max|e| "
        f"{peak:.4f}, corr(sample 0, sample 1) {corr:.2e}")
    check(abs(mean) < 0.005 and abs(var - 1) < 0.005 and peak <= 5.9
          and abs(corr) < 0.01, f"{what}: noise statistics out of range")


def noise_checks(dev) -> dict:
    """Phase 3, noise kernels: uint8 448^2 x 12 (the balancer) and fp32
    448^2 x 16 (the denoiser's noise stage)."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass \
        import graph_ms
    from denoising_diffusion_deep_fake_tpu_torch.ops.noise import blend_noise

    rng = np.random.default_rng(SEED + 3)
    results = {}
    seed, offset = 12345, 7

    # uint8: both mean/std pairs, per-sample ratios across [0, 1].
    b, h, w, c = 12, 448, 448, 3
    n = b * h * w * c
    u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, c),
                                       np.uint8)).to(dev)
    words = nk.philox_words((n + 3) // 4, seed=seed, offset=offset,
                            device=dev)
    check(torch.equal(words, nk.philox_words_plain(
        (n + 3) // 4, seed=seed, offset=offset, device=dev)),
        "Philox words differ from the plain version")
    log(f"  Philox words of {(n + 3) // 4} groups: bit-equal")
    ratios = torch.linspace(0, 1, b, device=dev)
    errs = []
    for mean, std in (HALF, IMAGENET):
        norm = nk.noise_constants(mean, std, c)
        got = nk.fused_normalise_noise_blend(u8, ratios, mean, std,
                                             seed=seed, offset=offset)
        want = nk.fused_normalise_noise_blend_plain(u8, ratios, norm,
                                                    seed=seed, offset=offset)
        errs.append(compare_ulp(got, want, f"u8 448^2 x12 mean={mean}"))
        zero = nk.fused_normalise_noise_blend(
            u8, torch.zeros(b, device=dev), mean, std, seed=seed)
        m255 = torch.tensor(norm[:c], device=dev)
        s255 = torch.tensor(norm[c:], device=dev)
        check(torch.equal(zero, (u8.float() - m255) / s255),
              "ratio 0 is not exactly the normalisation")
    ones = torch.ones(b, device=dev)
    eps = nk.fused_normalise_noise_blend(u8, ones, *HALF, seed=seed,
                                         offset=offset)
    noise_stats(eps, "u8 448^2 x12")
    check(torch.equal(eps, nk.fused_normalise_noise_blend(
        u8, ones, *HALF, seed=seed, offset=offset)), "not deterministic")
    other = nk.fused_normalise_noise_blend(u8, ones, *HALF, seed=seed,
                                           offset=offset + 1)
    check(float((other != eps).float().mean()) > 0.99,
          "another offset gives the same noise")
    # Timed into a preallocated output by CUDA-graph replay (the launch
    # alone: the wrapper's checks take about as long on the host as the
    # kernel on the card); the launch loop, which includes that host time,
    # and the wrapper (allocation included) beside it.
    norm = nk.noise_constants(*HALF, c)
    out = torch.empty(u8.shape, dtype=torch.float32, device=dev)

    def launch_u8():
        nk.launch_blend(u8, out, ones, norm, seed=seed, offset=offset)

    ms = graph_ms(launch_u8)
    loop_ms = time_ms(launch_u8, 50)
    wrapper_ms = time_ms(lambda: nk.fused_normalise_noise_blend(
        u8, ones, *HALF, seed=seed, offset=offset), 50)
    plain_ms = time_ms(lambda: nk.fused_normalise_noise_blend_plain(
        u8, ones, norm, seed=seed, offset=offset), 3, warmup=1)
    bound_ms, bound_by = bound(
        n * (1 + 4) + 4 * b, n * NOISE_FP_OPS["fused_normalise_noise_blend"],
        n * NOISE_INT_OPS)
    log(f"  u8 448^2 x12: kernel {ms:.4f} ms by graph replay (launch loop, "
        f"host-inclusive, {loop_ms:.4f} ms; wrapper {wrapper_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}), {bound_ms / ms:.0%} of it")
    results["fused_normalise_noise_blend"] = dict(
        max_abs_err=max(errs), ms=ms, launch_loop_ms=loop_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # fp32: the denoiser's noise stage after the warp.
    b = 16
    n = b * h * w * c
    x = torch.randn((b, h, w, c), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    ratios = torch.rand(b, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    got = nk.fused_noise_blend(x, ratios, seed=seed, offset=offset)
    err = compare_ulp(got, nk.fused_noise_blend_plain(
        x, ratios, seed=seed, offset=offset), "f32 448^2 x16")
    check(torch.equal(nk.fused_noise_blend(x, torch.zeros(b, device=dev),
                                           seed=seed), x),
          "ratio 0 is not the identity")
    zeros, ones = torch.zeros_like(x), torch.ones(b, device=dev)
    eps = nk.fused_noise_blend(zeros, ones, seed=seed, offset=offset)
    noise_stats(eps, "f32 448^2 x16")
    check(torch.equal(eps, nk.fused_noise_blend(zeros, ones, seed=seed,
                                                offset=offset)),
          "not deterministic")
    out = torch.empty_like(x)

    def launch_f32():
        nk.launch_blend(x, out, ratios, None, seed=seed, offset=offset)

    ms = graph_ms(launch_f32)
    loop_ms = time_ms(launch_f32, 50)
    wrapper_ms = time_ms(lambda: nk.fused_noise_blend(
        x, ratios, seed=seed, offset=offset), 50)
    plain_ms = time_ms(lambda: nk.fused_noise_blend_plain(
        x, ratios, seed=seed, offset=offset), 3, warmup=1)
    # The stage it replaces on the denoiser path: torch.randn, then
    # blend_noise (PyTorch elementwise launches).
    gen = torch.Generator(device=dev).manual_seed(8)
    r4 = ratios.reshape(b, 1, 1, 1)
    before_ms = time_ms(lambda: blend_noise(
        x, torch.randn(x.shape, generator=gen, device=dev), r4), 50)
    bound_ms, bound_by = bound(n * (4 + 4) + 4 * b,
                               n * NOISE_FP_OPS["fused_noise_blend"],
                               n * NOISE_INT_OPS)
    log(f"  f32 448^2 x16: kernel {ms:.4f} ms by graph replay (launch loop, "
        f"host-inclusive, {loop_ms:.4f} ms; wrapper {wrapper_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}), {bound_ms / ms:.0%} of it; the PyTorch stage it "
        f"replaces (torch.randn + blend_noise) {before_ms:.4f} ms")
    results["fused_noise_blend"] = dict(max_abs_err=err, ms=ms,
                                        launch_loop_ms=loop_ms,
                                        plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)
    return results


def random_params(b: int, seed: int, device) -> dict:
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return sample_affine_params(b, AffineAugmentConfig.random_affine(),
                                generator=gen, device=device)


def shift_scale_rotate_params(b: int, seed: int, device) -> dict:
    """The deep-fake trainer's draws (ShiftScaleRotate, p = 0.7) from a
    CPU generator, with both warped and unwarped samples."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)

    params = sample_affine_params(
        b, AffineAugmentConfig.shift_scale_rotate(),
        generator=torch.Generator().manual_seed(seed))
    check(0 < int(params["apply"].sum()) < b,
          "the ShiftScaleRotate draws are not mixed")
    return {k: v.to(device) for k, v in params.items()}


def kernel_checks(dev) -> dict:
    """Phase 3: each kernel against its plain version at the path shapes."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        _inverse_affine_coeffs)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        warp_fused as wf, warp_kernel as wk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass \
        import graph_ms, route_cases

    rng = np.random.default_rng(SEED)
    results = {}

    # Fused warp, uint8 fold, 448^2 x 16: the main path's call, with both
    # stat sets, then the corners of random_affine's ranges (sources off
    # the edge, so the zero border is exercised).
    b, h, w, c = 16, 448, 448, 3
    u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, c),
                                       np.uint8)).to(dev)
    corners = torch.tensor([(15.0, 1.2, 0.2, 0.2), (-15.0, 0.8, -0.2, -0.2),
                            (15.0, 0.8, -0.2, 0.2), (-15.0, 1.2, 0.2, -0.2)],
                           device=dev).repeat(b // 4, 1).T
    extreme = dict(angle=corners[0], scale=corners[1], tx=corners[2],
                   ty=corners[3], apply=torch.ones(b, dtype=torch.bool,
                                                   device=dev))
    coeffs = _inverse_affine_coeffs(random_params(b, 1, dev), h, w)
    errs = []
    corner_coeffs = _inverse_affine_coeffs(extreme, h, w)
    ssr_coeffs = _inverse_affine_coeffs(shift_scale_rotate_params(b, 0, dev),
                                        h, w)
    for what, cf, (mean, std) in (("random params", coeffs, HALF),
                                  ("random params", coeffs, IMAGENET),
                                  ("range corners", corner_coeffs, IMAGENET),
                                  ("ShiftScaleRotate, some unwarped",
                                   ssr_coeffs, IMAGENET)):
        got = wf.affine_warp_fused_coeffs(u8, cf, mean=mean, std=std)
        want = wf.affine_warp_fused_plain(
            u8, cf, wf.norm_constants(mean, std, c))
        errs.append(compare(got, want,
                            f"fused 448^2 x16 {what}, mean={mean}"))
    norm = wf.norm_constants(*HALF, c)
    alpha_x, shift_x, alpha_y, shift_y = wk.shear_factors(coeffs, h, w)
    bx, rx = wk.pass_scalars(alpha_x, shift_x, w)
    by, ry = wk.pass_scalars(alpha_y, shift_y, h)
    ax, ay = alpha_x.contiguous(), alpha_y.contiguous()
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    # The one launch, into a preallocated output, so the host's launch rate
    # stays below the kernel's; the wrapper (scalars, allocation) beside it.
    ms = time_ms(lambda: wf.launch_fused(u8, out, ax, bx, rx, ay, by, ry,
                                         norm), 50)
    wrapper_ms = time_ms(lambda: wf.affine_warp_fused_coeffs(
        u8, coeffs, mean=0.5, std=0.5), 50)
    plain_ms = time_ms(lambda: wf.affine_warp_fused_plain(u8, coeffs, norm),
                       3, warmup=1)
    n = b * h * w * c
    bound_ms, bound_by = bound(n * (1 + 4), 2 * n * OPS_PER_PASS_ELEMENT)
    log(f"  fused 448^2 x16: kernel {ms:.4f} ms (wrapper incl. scalar prep "
        f"{wrapper_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by})")

    # The i420 upload's route: fp32 RGB in [0, 255] from the unpack of the
    # same batch, normalised in the kernel (__fdiv_rn), bit-equal to the
    # plain version's true division; timed by graph replay (4 bytes in and
    # 4 out an element).
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        i420_to_rgb, rgb_to_i420)

    rgb = i420_to_rgb(rgb_to_i420(u8))
    for what, cf, (mean, std) in (("random params", coeffs, HALF),
                                  ("random params", coeffs, IMAGENET),
                                  ("range corners", corner_coeffs, IMAGENET)):
        got = wf.affine_warp_fused_coeffs(rgb, cf, mean=mean, std=std)
        want = wf.affine_warp_fused_plain(
            rgb, cf, wf.norm_constants(mean, std, c))
        errs.append(compare(got, want, f"fused 448^2 x16 fp32 input (i420 "
                            f"unpacked) + norm, {what}, mean={mean}"))
    f32_ms = graph_ms(lambda: wf.launch_fused(rgb, out, ax, bx, rx, ay, by,
                                              ry, norm))
    f32_plain_ms = time_ms(lambda: wf.affine_warp_fused_plain(
        rgb, coeffs, norm), 3, warmup=1)
    f32_bound_ms, f32_bound_by = bound(n * (4 + 4),
                                       2 * n * OPS_PER_PASS_ELEMENT)
    log(f"  fused 448^2 x16, fp32 input + norm (graph-timed): kernel "
        f"{f32_ms:.4f} ms, plain {f32_plain_ms:.3f} ms, bound "
        f"{f32_bound_ms * 1e3:.2f} us ({f32_bound_by}), "
        f"{f32_bound_ms / f32_ms:.0%} of it")
    results["affine_warp_fused"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, f32_norm=dict(ms=f32_ms, plain_ms=f32_plain_ms,
                                         bound_ms=f32_bound_ms,
                                         bound_by=f32_bound_by))

    # Axis pass: both kernels on both layouts of the two-pass route (the
    # x-pass, NHWC source -> planar; the y-pass, planar -> NHWC) at 448^2 x
    # 16 and at the route's own 640^2 x 4, each bit-equal to the plain
    # version. Each pass alone, through the kernel its layout picks, into a
    # preallocated output: by CUDA-graph replay (the kernels back to back;
    # the wrapper's checks take longer on the host than a pass on the
    # card), and by the launch loop earlier PRs timed.
    errs, passes = [], {}
    shapes = route_cases(dev)
    for shape in shapes:
        for case in shape["passes"]:
            src, dst, scalars = case["src"], case["dst"], case["scalars"]
            key = f"{case['what']} {shape['key']}"
            for kernel in wk.PASS_KERNELS:
                dst.fill_(math.nan)
                wk.launch_pass(src, dst, *scalars, kernel=kernel)
                errs.append(compare(dst, case["want"],
                                    f"{key}, {kernel} kernel"))
            passes[key] = graph_ms(lambda: wk.launch_pass(src, dst, *scalars))
            loop_ms = time_ms(lambda: wk.launch_pass(src, dst, *scalars), 50)
            n = shape["elements"]
            bound_ms, bound_by = bound(n * (4 + 4), n * OPS_PER_PASS_ELEMENT)
            log(f"  {key} alone ({wk.pass_kernel(src.stride())} kernel): "
                f"{passes[key]:.4f} ms (launch loop {loop_ms:.4f} ms), bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}), "
                f"{bound_ms / passes[key]:.0%} of it")

    # The two-pass route through its wrapper: random params at both shapes
    # and the corners of random_affine's ranges at 640^2 x 4.
    x, x640 = shapes[0]["x"], shapes[1]["x"]
    c640 = shapes[1]["coeffs"]
    corner640 = _inverse_affine_coeffs(
        {k: v[:4] for k, v in extreme.items()}, 640, 640)
    ssr640 = _inverse_affine_coeffs(shift_scale_rotate_params(4, 0, dev),
                                    640, 640)
    plain640 = wk.affine_warp_twopass_plain(x640, c640)
    for what, xs, cf, want in (
            ("448^2 x16 random params", x, shapes[0]["coeffs"],
             wk.affine_warp_twopass_plain(x, shapes[0]["coeffs"])),
            ("640^2 x4 random params", x640, c640, plain640),
            ("640^2 x4 range corners", x640, corner640,
             wk.affine_warp_twopass_plain(x640, corner640)),
            ("640^2 x4 ShiftScaleRotate, some unwarped", x640, ssr640,
             wk.affine_warp_twopass_plain(x640, ssr640))):
        errs.append(compare(wk.affine_warp_twopass_coeffs(xs, cf), want,
                            f"two-pass {what}"))
    # The whole two-pass warp at 640^2 x 4: its two launches into
    # preallocated tensors, then the wrapper (scalars, allocation).
    first, second = shapes[1]["passes"]
    (pax, pbx, prx), (pay, pby, pry) = first["scalars"], second["scalars"]
    t640 = first["dst"]                       # planar, as (B, H, C, W)
    o640 = second["dst"].permute(0, 3, 1, 2)  # NHWC

    def twopass():
        wk.launch_pass(first["src"], t640, pax, pbx, prx)
        wk.launch_pass(t640.permute(0, 3, 2, 1), second["dst"], pay, pby,
                       pry)

    ms = graph_ms(twopass)
    errs.append(compare(o640, plain640, "two-pass 640^2 x4, timed launches"))
    wrapper_ms = time_ms(lambda: wk.affine_warp_twopass_coeffs(x640, c640),
                         50)
    plain_ms = time_ms(lambda: wk.affine_warp_twopass_plain(x640, c640), 3,
                       warmup=1)
    n = shapes[1]["elements"]
    bound_ms, bound_by = bound(2 * n * (4 + 4), 2 * n * OPS_PER_PASS_ELEMENT)
    log(f"  two-pass 640^2 x4, both passes: kernels {ms:.4f} ms (wrapper "
        f"incl. scalar prep {wrapper_ms:.4f} ms), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / ms:.0%} "
        "of it")
    results["warp_axis_pass"] = dict(max_abs_err=max(errs), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, passes_ms=passes)

    # Recorded only (auto keeps the JAX routing): the fused warp at 640^2 x
    # 4, fp32 in, bit-equal to the two-pass warp, and uint8 with the
    # normalise folded in, as the route would call it.
    f640 = torch.empty_like(o640)
    fused_args = (pax, pbx, prx, pay, pby, pry)
    wf.launch_fused(x640, f640, *fused_args, None)
    compare(f640, plain640, "fused 640^2 x4 fp32 (recorded only)")
    fused_ms = graph_ms(lambda: wf.launch_fused(x640, f640, *fused_args,
                                                None))
    u640 = torch.from_numpy(rng.integers(0, 256, (4, 640, 640, c),
                                         np.uint8)).to(dev)
    wf.launch_fused(u640, f640, *fused_args, norm)
    compare(f640, wf.affine_warp_fused_plain(u640, c640, norm),
            "fused 640^2 x4 uint8 (recorded only)")
    fused_u8_ms = graph_ms(lambda: wf.launch_fused(u640, f640, *fused_args,
                                                   norm))
    log(f"  fused 640^2 x4 (recorded only, graph-timed): fp32 in "
        f"{fused_ms:.4f} ms, uint8 in {fused_u8_ms:.4f} ms, against the "
        f"two-pass kernels' {ms:.4f} ms")
    return results


def make_trainer(device, *, encoder: str, batch: int, size: int,
                 dtype: str, warp_method: str = "auto", **overrides):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)

    # The values of configs/denoiser.yml (the GPU machine may lack PyYAML),
    # at the 448^2 image size of configs/denoise.yml:23.
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path="synthetic", batch_size=batch,
        learning_rate=0.02, max_epochs=100, cosine_scheduler_max_epoch=100,
        encoder_name=encoder, noise_exponential_sampling_lambda=5,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), compute_dtype=dtype,
        image_size=size, warp_method=warp_method, seed=SEED, **overrides))
    return DenoiserTrainer(cfg, steps_per_epoch=1000, image_size=size,
                           device=device)


def small_reference(dev, upload_format: str = "rgb",
                    encoder: str = "resnet18",
                    warp_method: str = "pallas_fused", **overrides) -> None:
    """Phase 4 (11b with ``upload_format="i420"``, 14a with a Bottleneck
    ``encoder``, 16b with ``warp_method`` shear and hybrid, 18a with
    EfficientNet's stochastic depth or ``patchify_stem`` in
    ``overrides``): a 64^2 fp32 step on the GPU against the CPU plain
    path, an encoder that drops blocks given the same masks on both."""
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        drop_keep_probs)
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        unpack_upload)

    rng = np.random.default_rng(SEED + 1)
    b, s = 2, 64
    u8 = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8))
    if upload_format == "i420":
        from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
            rgb_to_i420)

        u8 = rgb_to_i420(u8)
    check(unpack_upload(u8, upload_format).shape == (b, s, s, 3),
          f"the {upload_format} batch does not unpack to {s}^2")
    params = sample_affine_params(b, AffineAugmentConfig.random_affine(),
                                  generator=torch.Generator().manual_seed(5))
    ratios = torch.from_numpy(rng.uniform(0, 0.5, b).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((b, s, s, 3)).astype(
        np.float32))
    keep = np.asarray(drop_keep_probs(encoder))
    masks = (torch.from_numpy(rng.random((len(keep), b)) < keep[:, None])
             if len(keep) else None)
    losses = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        trainer = make_trainer(device, encoder=encoder, batch=b, size=s,
                               dtype="float32", warp_method=warp_method,
                               upload_format=upload_format, **overrides)
        state = trainer.init_state(seed=7)
        on = torch.device(device)
        m = trainer.train_step(
            state, u8, affine_params={k: v.to(on) for k, v in params.items()},
            ratios=ratios.to(on), noise=noise.to(on),
            drop_masks=None if masks is None else masks.to(on))
        losses[name] = float(m["loss"])
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    extra = "".join(f" {k}={v}" for k, v in overrides.items())
    if masks is not None:
        extra += (f" drop masks {tuple(masks.shape)} "
                  f"({int((~masks).sum())} blocks x samples dropped)")
    log(f"  64^2 fp32 {encoder}{extra} {upload_format} {warp_method} step "
        f"loss: "
        f"cuda {losses['cuda']:.7f}, cpu {losses['cpu']:.7f}, relative "
        f"difference {rel:.2e} (limit 1e-4: "
        "cuDNN and the CPU sum convolutions in other orders)")
    check(math.isfinite(losses["cuda"]) and rel < 1e-4,
          "the GPU step disagrees with the CPU reference")


def single_path(trainer, *, size: int, batch: int, state=None) -> dict:
    """One model's trainer (denoiser or balancer) as a path for ``drive``,
    on ``state`` or a new one."""
    if state is None:
        state = trainer.init_state(seed=SEED)
    return dict(
        trainer=trainer, state=state, size=size, batch=batch, images=batch,
        step=lambda u8: {"loss": trainer.train_step(state, u8)["loss"]},
        probes=lambda: [next(state.model.parameters())])


def drive(dev, launches, card: str, run: dict, *, warmup: int, steps: int,
          per_step: dict, after_warmup=None) -> dict:
    """Phases 5 to 8: train steps through the entry points, counted.

    ``run`` is a path (``single_path``, ``deep_fake_path``): ``step`` takes
    one uint8 batch of ``batch`` rows and returns the step's losses,
    ``images`` is the number of images a step trains on, and ``probes``
    gives tensors that the steps must change; ``wire``, when given, turns
    each RGB batch into the upload format before the steps (i420 packing).
    ``per_step`` holds the launches each kernel wrapper must make a
    step."""
    size, batch = run["size"], run["batch"]
    rng = np.random.default_rng(SEED)
    wire = run.get("wire", lambda u8: u8)
    batches = [wire(torch.from_numpy(rng.integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev))
        for _ in range(min(warmup + steps, 8))]
    before = [p.detach().clone() for p in run["probes"]()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launches.clear()
    losses = []
    for i in range(warmup):
        losses.append(run["step"](batches[i]))
    torch.cuda.synchronize()
    if after_warmup is not None:
        after_warmup()
    # One event per step boundary on the device's timeline: per-step
    # times without a host synchronisation between steps.
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(warmup, warmup + steps):
        losses.append(run["step"](batches[i % len(batches)]))
        events[i - warmup + 1].record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = dict(launches)
    step_times = sorted(a.elapsed_time(b)
                        for a, b in zip(events, events[1:]))

    losses = {k: [float(m[k]) for m in losses] for k in losses[0]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    images = run["images"]
    for key, values in losses.items():
        log(f"  {size}^2 x{batch} {run['trainer'].cfg.encoder_name} "
            f"{run['trainer'].cfg.compute_dtype}: {key} "
            f"{[round(v, 5) for v in values]}")
    log(f"  {size}^2 x{batch}: {step_ms:.3f} ms/step (host clock, mean of "
        f"{steps}), {images / step_ms * 1e3:.1f} imgs/s ({images} images a "
        f"step); per-step device timeline median "
        f"{step_times[len(step_times) // 2]:.3f} ms, min "
        f"{step_times[0]:.3f}, max {step_times[-1]:.3f}; peak memory "
        f"{peak_gb:.2f} GB [{card}]")
    log(f"  launches: {counts}")
    check(all(math.isfinite(v) for vs in losses.values() for v in vs),
          "non-finite loss")
    n_steps = warmup + steps
    for kernel in KERNELS:
        want = per_step.get(kernel, 0) * n_steps
        check(counts.get(kernel, 0) == want,
              f"{kernel} launched {counts.get(kernel, 0)} times in "
              f"{n_steps} steps, not {want}")
    check(all(not torch.equal(b, p.detach())
              for b, p in zip(before, run["probes"]())),
          "params did not change")
    return dict(run, counts=counts, step_ms=step_ms, peak_gb=peak_gb,
                device_ms=step_times[len(step_times) // 2])


def device_report(report: dict | None) -> dict:
    """The card's plane of a ``utils/profiling.py`` report ({} when the
    profiler saw no device activity)."""
    if not report or not report["planes"]:
        return {}
    return report[report["planes"][0]]


def profile_steps(run: dict, dev, path: Path | None) -> dict:
    """Device time by kernel over 3 more steps of a path, from a
    ``utils/profiling.py`` trace and its report; returns the port's
    kernels' time per step by device function, and records the card's
    busy time a step (the union of its kernels, copies and memsets) in
    ``run["busy_ms"]`` (0 when the profiler saw none)."""
    from denoising_diffusion_deep_fake_tpu_torch.utils.profiling import (
        analyze_trace_dir, trace)

    size = run["size"]
    u8 = run.get("wire", lambda x: x)(torch.randint(
        0, 256, (run["batch"], size, size, 3), dtype=torch.uint8,
        device=dev))
    run["step"](u8)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device=dev):
            t0 = time.perf_counter()
            for _ in range(3):
                run["step"](u8)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        report = analyze_trace_dir(tmp, nsteps=3)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=2))
    plane = device_report(report)
    busy_ms = plane.get("ops_busy_ms_per_step", 0.0)
    port_ms = {fn: plane.get("port_kernels", {}).get(fn, {}).get(
                   "ms_per_step", 0.0)
               for fn in sorted({f for k in KERNELS.values() for f in k[2:]})}
    run["busy_ms"] = busy_ms
    run["plane"] = plane
    run["categories"] = plane.get("category_ms_per_step", {})
    if busy_ms > 0:
        share = busy_ms / run["step_ms"]
        log(f"  profile of 3 steps ({window_ms / 3:.3f} "
            f"ms/step under the profiler): card busy {busy_ms:.3f} ms per "
            f"step, {share:.1%} of the unprofiled {run['step_ms']:.3f} ms "
            f"step (device idle {1 - share:.1%})")
        for fn, ms in port_ms.items():
            log(f"    {fn}: {ms:.4f} ms per step ({ms / busy_ms:.2%} of "
                "device time)")
        log("    by category, ms a step: " + ", ".join(
            f"{k} {v:.3f}" for k, v in run["categories"].items()))
        for name, ms in list(plane["top_ops_ms_per_step"].items())[:12]:
            log(f"    {ms:8.3f}  {name[:100]}")
    else:
        log("  profiler recorded no device time: busy share not measured "
            f"(events by category: {report['events_by_category']})")
    return port_ms


def make_balancer(device, **overrides):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        BalanceTrainer)

    # The values of configs/balance.yml at the 448^2 image size of
    # configs/denoise.yml:23.
    cfg = config_from_dict(BalanceConfig, dict(dict(
        data_path="synthetic", batch_size=12, learning_rate=0.01,
        max_epochs=200, encoder_name="resnet34", ratio_of_noise=0.7,
        number_of_classes=10, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
        compute_dtype="bfloat16", image_size=448, seed=SEED), **overrides))
    return BalanceTrainer(cfg, steps_per_epoch=1000,
                          image_size=cfg.image_size, device=device)


def score_and_write(run: dict, dev, launches) -> None:
    """Phase 7, after the train steps: score 50 images, bin them, write
    the balanced manifest and read it back. Launches accumulate on the
    train steps' counts."""
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        read_image_manifest_with_classes)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        compute_difficulty_index)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        write_balanced_manifest)

    trainer, state = run["trainer"], run["state"]
    n, bs, size = 50, run["batch"], run["size"]
    data = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, 256, (n, size, size, 3), np.uint8)).to(dev)
    batches = [(data[i:i + bs], np.arange(i, min(i + bs, n)))
               for i in range(0, n, bs)]
    before = launches.get("fused_normalise_noise_blend", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indices, losses = trainer.score_dataset(state, batches, epoch=0)
    score_ms = (time.perf_counter() - t0) * 1e3
    scored = launches.get("fused_normalise_noise_blend", 0) - before
    classes = compute_difficulty_index(losses, trainer.cfg.number_of_classes)
    log(f"  scored {n} images in {len(batches)} batches (last {n % bs} "
        f"padded to {bs}): {score_ms:.3f} ms ({n / score_ms * 1e3:.1f} "
        f"imgs/s), losses {losses.min():.5f}..{losses.max():.5f}, class "
        f"counts {np.bincount(classes, minlength=10).tolist()}, noise "
        f"kernel launches {scored}")
    check(scored == len(batches) == 5, f"scoring launched the noise kernel "
          f"{scored} times for {len(batches)} batches")
    check(losses.shape == (n,) and np.isfinite(losses).all(),
          "scores are not 50 finite losses")
    check(np.array_equal(indices, np.arange(n)), "scoring lost the order")
    check(classes.min() >= 0 and classes.max() < 10, "class out of range")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / "images" / f"{i:05d}.png" for i in range(n)]
        manifest = Path(tmp) / "balanced.txt"
        write_balanced_manifest(
            types.SimpleNamespace(output_image_list_path=manifest),
            types.SimpleNamespace(paths=paths), indices, classes)
        got_paths, got_classes = read_image_manifest_with_classes(manifest)
    check(got_paths == paths and got_classes == classes.tolist(),
          "the balanced manifest does not read back")
    log(f"  balanced manifest: {n} lines written and read back")


# The values of configs/denoise.yml and configs/swap.yml (the GPU machine
# may lack PyYAML), at their 448^2 image size.
DENOISE_YML = dict(
    mode="denoise", batch_size=16, learning_rate=0.01, adam_b1=0.5,
    adam_b2=0.999, max_epochs=50, cosine_scheduler_max_epoch=50,
    encoder_name="resnet34", noise_exponential_sampling_lambda=3,
    data_path_a="synthetic/a", data_path_b="synthetic/b",
    mean_a=(0.5, 0.5, 0.5), std_a=(0.5, 0.5, 0.5), mean_b=(0.5, 0.5, 0.5),
    std_b=(0.5, 0.5, 0.5), image_size=448, compute_dtype="bfloat16",
    seed=SEED)
SWAP_YML = dict(
    mode="swap", batch_size=16, learning_rate=0.01, adam_b1=0.5,
    adam_b2=0.999, max_epochs=200, cosine_scheduler_max_epoch=200,
    noise_exponential_sampling_lambda=8, ema_beta=0.9999,
    ema_update_every=1)
SWAP_KEYS = ("loss_swap/train_a", "loss_swap/train_b", "swap_difference/a",
             "swap_difference/b")


def make_deep_fake(device, cfg: dict | None = None, **overrides):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
        DeepFakeTrainer)

    cfg = config_from_dict(DeepFakeConfig, dict(cfg or DENOISE_YML,
                                                **overrides))
    return DeepFakeTrainer(cfg, steps_per_epoch=1000,
                           image_size=cfg.image_size, device=device)


def deep_fake_reference(dev) -> None:
    """Phase 8a: a 64^2 fp32 swap step on the GPU against the CPU plain
    path, the shadows apart from their models. The shadows' ``ema_step``
    lies so far past the warm-up that the decay is ``ema_beta``: a's
    post-step params, whose tiny gradients' signs (and so Adam's +-lr
    steps) may differ between the devices, reach fake_b damped by
    ``1 - ema_beta``."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        create_model_state)

    rng = np.random.default_rng(SEED + 5)
    b, s = 2, 64
    draws = {name: dict(
        u8=torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8)),
        params=shift_scale_rotate_params(b, 3, "cpu"),
        ratios=torch.from_numpy(rng.uniform(0, 0.5, b).astype(np.float32)),
        noise=torch.from_numpy(rng.standard_normal((b, s, s, 3)).astype(
            np.float32))) for name in ("a", "b")}
    results = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        on = torch.device(device)
        trainer = make_deep_fake(
            device, dict(DENOISE_YML, **SWAP_YML), batch_size=b,
            encoder_name="resnet18", compute_dtype="float32", image_size=s,
            warp_method="pallas_fused")
        states = trainer.init_states(seed=7)
        for i, state in enumerate(states.values()):
            apart = create_model_state(trainer.cfg, trainer.dtype, on,
                                       seed=20 + i)
            state.ema_model.load_state_dict(apart.model.state_dict())
            state.ema_step = 10 ** 7

        def per(key, move):
            return {n: move(d[key]) for n, d in draws.items()}

        m = trainer.train_step(
            states, draws["a"]["u8"], draws["b"]["u8"],
            affine_params=per("params", lambda p: {
                k: v.to(on) for k, v in p.items()}),
            ratios=per("ratios", lambda t: t.to(on)),
            noise=per("noise", lambda t: t.to(on)))
        results[name] = {k: float(m[k]) for k in SWAP_KEYS}
    for key in SWAP_KEYS:
        got, want = results["cuda"][key], results["cpu"][key]
        rel = abs(got - want) / abs(want)
        log(f"  64^2 fp32 swap step {key}: cuda {got:.7f}, cpu {want:.7f}, "
            f"relative difference {rel:.2e} (limit 1e-4: cuDNN and the CPU "
            "sum convolutions in other orders)")
        check(math.isfinite(got) and rel < 1e-4,
              f"the GPU swap step's {key} disagrees with the CPU reference")


def deep_fake_path(trainer, states: dict, *, probes) -> dict:
    """The two-identity trainer as a path for ``drive``: each uint8 batch
    holds both identities' images, a's first."""
    batch = trainer.cfg.batch_size

    def step(u8):
        m = trainer.train_step(states, u8[:batch], u8[batch:])
        return {k: v for k, v in m.items() if k != "lr"}

    return dict(trainer=trainer, state=states, size=trainer.image_size,
                batch=2 * batch, images=2 * batch, step=step, probes=probes)


def online_probes(states: dict):
    return lambda: [next(s.model.parameters()) for s in states.values()]


def deep_fake_flip(run: dict, dev):
    """Phase 8c: configs/swap.yml overlaid on 8b's config, shadows
    attached as copies, then one swap step whose decay-0 updates copy b
    before its update and a after its. Returns the swap trainer."""
    import dataclasses

    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, overlay_config)
    from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
        DeepFakeTrainer)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        shadow_tensors)

    cfg = overlay_config(DeepFakeConfig,
                         dataclasses.asdict(run["trainer"].cfg), SWAP_YML)
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1000,
                              image_size=cfg.image_size, device=dev)
    states = trainer.ensure_ema(run["state"])
    for name, state in states.items():
        check(state.ema_step == 0 and all(
            torch.equal(e, p) for e, p in zip(shadow_tensors(state.ema_model),
                                              shadow_tensors(state.model))),
            f"the shadow of {name} is not a copy of its model")
        check(all(e.stride() == p.stride() for e, p in zip(
            state.ema_model.parameters(), state.model.parameters())),
            f"the shadow of {name} has another layout than its model "
            "(channels_last on the GPU)")
    b_before = [t.clone() for t in shadow_tensors(states["b"].model)]
    u8 = torch.randint(0, 256, (2, cfg.batch_size, cfg.image_size,
                                cfg.image_size, 3), dtype=torch.uint8,
                       device=dev)
    trainer.train_step(states, u8[0], u8[1])
    torch.cuda.synchronize()
    check(all(torch.equal(e, p) for e, p in zip(
        shadow_tensors(states["b"].ema_model), b_before)),
        "ema_b is not b's pre-step copy")
    check(all(torch.equal(e, p) for e, p in zip(
        shadow_tensors(states["a"].ema_model),
        shadow_tensors(states["a"].model))),
        "ema_a is not a's post-step copy")
    check(not all(torch.equal(e, p) for e, p in zip(
        b_before, shadow_tensors(states["b"].model))), "b did not move")
    log(f"  mode {cfg.mode}, lr {cfg.learning_rate}, lambda "
        f"{cfg.noise_exponential_sampling_lambda}, ema_beta {cfg.ema_beta}, "
        f"cosine {cfg.cosine_t_max}: shadows attached as bit-equal copies "
        "(ema_step 0); after one step ema_b equals b's pre-step and ema_a "
        "a's post-step weights and BN buffers, bit for bit")
    return trainer


def deep_fake_swap(trainer, states: dict, dev, launches, card: str) -> dict:
    """Phase 8d: swap steps past the EMA warm-up; the shadows must move
    and stay off their models."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        augment_batch)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        shadow_tensors)

    for state in states.values():
        state.ema_step = trainer.ema_cfg.update_after_step + 1
    log(f"  ema_step set to {trainer.ema_cfg.update_after_step + 1} on both "
        "states (a run past its EMA warm-up): the timed steps blend with "
        "decay > 0")
    shadows = {}

    def snapshot():
        for name, state in states.items():
            shadows[name] = [t.clone()
                             for t in shadow_tensors(state.ema_model)]

    run = drive(dev, launches, card,
                deep_fake_path(trainer, states,
                               probes=online_probes(states)),
                warmup=3, steps=20, after_warmup=snapshot,
                per_step={"affine_warp_fused": 2, "fused_noise_blend": 2})
    for name, state in states.items():
        now = shadow_tensors(state.ema_model)
        n_params = len(list(state.ema_model.parameters()))
        for what, sl in (("weights", slice(0, n_params)),
                         ("BN buffers", slice(n_params, None))):
            check(not any(torch.equal(a, b) for a, b in zip(
                shadows[name][sl], now[sl])),
                f"a {what} tensor of {name}'s shadow did not move")
            check(not all(torch.equal(a, b) for a, b in zip(
                now[sl], shadow_tensors(state.model)[sl])),
                f"the {what} of {name}'s shadow equal its model's")
    log("  both shadows' weights and BN buffers moved in every tensor "
        "during the timed steps and differ from their models'")
    # Recorded only: the two pieces the swap step adds to two updates. The
    # EMA blend must read the shadow and the model and write the shadow
    # (12 bytes a value); it makes one more pass through a scaled copy of
    # the model, which it allocates.
    state = states["a"]
    n_values = sum(t.numel() for t in shadow_tensors(state.ema_model))
    ema_ms = time_ms(lambda: state.update_ema(trainer.ema_cfg), 10)
    ema_bound, _ = bound(12 * n_values, 3 * n_values)
    u8 = torch.randint(0, 256, (trainer.cfg.batch_size, run["size"],
                                run["size"], 3), dtype=torch.uint8,
                       device=dev)
    real = augment_batch(u8, trainer.cfg.mean_a, trainer.cfg.std_a,
                         trainer.aug)
    fake_ms = time_ms(lambda: trainer._ema_forward(state, real), 10)
    log(f"  one EMA update of a model ({n_values} values): {ema_ms:.4f} ms "
        f"(bound {ema_bound:.4f} ms, bytes); one shadow forward at "
        f"{run['size']}^2 x{trainer.cfg.batch_size}: {fake_ms:.3f} ms "
        f"(device time, mean of 10) [{card}]")
    size = trainer.image_size
    x = torch.rand((4, size, size, 3), device=dev) * 2 - 1
    for use_ema in (False, True):
        out = trainer.make_predict_fake(use_ema=use_ema)(states["a"], x)
        torch.cuda.synchronize()
        check(out.shape == x.shape and out.dtype == torch.float32
              and torch.isfinite(out).all().item(),
              f"predict_fake (use_ema={use_ema}) is not finite")
    log(f"  predict_fake through model and shadow: {tuple(x.shape)} fp32 "
        "finite")
    return run


def u8_compare(got: torch.Tensor, want: torch.Tensor, what: str, *,
               quiet: bool = False) -> float:
    """uint8 frames within 1 LSB (a float on an integer boundary may
    truncate either way); returns the share of differing values."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    share = float((diff > 0).float().mean())
    if not quiet:
        log(f"  {what}: max |difference| {int(diff.max())} LSB, differing "
            f"share {share:.3e}")
    check(int(diff.max()) <= 1, f"{what}: more than 1 LSB apart")
    return share


def serving_checkpoint(trainer, states: dict, path: Path) -> None:
    """Phase 9a: save 8d's states, load each identity's model and shadow
    back, bit for bit, in channels_last on the card."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = states["a"].step
    CheckpointManager(path).save(step, states,
                                 dataclasses.asdict(trainer.cfg))
    save_s = time.perf_counter() - t0
    n_bytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    loads = []
    for name, state in states.items():
        for use_ema, module in ((False, state.model),
                                (True, state.ema_model)):
            t0 = time.perf_counter()
            model = load_swap_model(path, name, use_ema=use_ema)
            loads.append(time.perf_counter() - t0)
            got, want = model.model.state_dict(), module.state_dict()
            check(got.keys() == want.keys() and all(
                torch.equal(got[k], want[k]) for k in want),
                f"{name} (use_ema={use_ema}) does not load back bit-equal")
            weight = model.model.encoder.conv1.weight
            check(weight.is_contiguous(memory_format=torch.channels_last)
                  and not model.model.training,
                f"{name}'s swap model is not in eval mode and channels_last")
    log(f"  step {step}: saved both identities ({n_bytes / 1e6:.1f} MB: "
        f"models, shadows, Adam, counters) in {save_s:.2f} s; loaded a and "
        f"b, model and shadow, each bit-equal to the saved tensors, "
        f"{min(loads):.2f}-{max(loads):.2f} s a load")


def serving_reference(dev, path: Path) -> None:
    """Phase 9b: a 64^2 fp32 resnet18 pair's pipeline, GPU against CPU."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        normalise_batch)
    from denoising_diffusion_deep_fake_tpu_torch.ops.sampler import (
        swap_refine)

    trainer = make_deep_fake("cpu", dict(DENOISE_YML, **SWAP_YML),
                             batch_size=2, encoder_name="resnet18",
                             compute_dtype="float32", image_size=64,
                             mean_a=IMAGENET[0], std_a=IMAGENET[1])
    CheckpointManager(path).save(1, trainer.init_states(seed=11),
                                 dataclasses.asdict(trainer.cfg))
    rng = np.random.default_rng(SEED + 9)
    frames = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3),
                                           np.uint8))
    noise = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(
        np.float32))
    single, refined = {}, {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        model = load_swap_model(path, "a", device=device)
        single[name] = make_device_pipeline(model)(frames.to(device),
                                                   0).cpu()
        x = normalise_batch(frames.to(device), model.mean, model.std)
        refined[name] = swap_refine(model.predict, x, steps=3, seed=SEED,
                                    offset=0, noise=noise.to(device)).cpu()
    u8_compare(single["gpu"], single["cpu"],
               "64^2 fp32 single-pass uint8, GPU vs CPU")
    err = float((refined["gpu"] - refined["cpu"]).abs().max()
                / refined["cpu"].abs().max())
    log(f"  64^2 fp32 DDIM 3 steps, injected noise: max |GPU - CPU| "
        f"{err:.2e} of the largest magnitude (limit 1e-4)")
    check(math.isfinite(err) and err < 1e-4,
          "the GPU DDIM refinement disagrees with the CPU reference")


def time_pipeline(pipe, frames, launches, *, warmup: int, batches: int,
                  first_idx: int = 0) -> dict:
    """Drive ``pipe`` on device-resident frames, counted from 0: per-batch
    device times (CUDA events) and frames/s on the host clock."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    outs = [pipe(frames, first_idx + i) for i in range(warmup)]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(batches + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(batches):
        outs.append(pipe(frames, first_idx + warmup + i))
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / batches
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return dict(outs=outs, counts=dict(launches), host_ms=host_ms,
                times=times, n=warmup + batches,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def report_pipeline(what: str, run: dict, b: int, size: int,
                    card: str, transfer: str = "rgb") -> None:
    t = run["times"]
    log(f"  {what}: {run['host_ms']:.3f} ms a batch of {b} (host clock, "
        f"mean of {len(t)}), {b / run['host_ms'] * 1e3:.1f} frames/s; "
        f"per-batch device timeline median {t[len(t) // 2]:.3f} ms, min "
        f"{t[0]:.3f}, max {t[-1]:.3f}; peak memory {run['peak_gb']:.2f} GB "
        f"[{card}]")
    log(f"  launches: {run['counts']}")
    shape = ((b, size * 3 // 2, size) if transfer == "i420"
             else (b, size, size, 3))
    for out in run["outs"]:
        check(out.dtype == torch.uint8 and out.shape == shape
              and float(out.float().std()) > 0,
              f"{what}: the output is not varied uint8 frames")


def serving_single(path: Path, dev, launches, card: str, *,
                   size: int = 448, batch: int = 16) -> dict:
    """Phase 9c: the single-pass pipeline at 448^2 x 16; returns it as a
    path for ``profile_steps``."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)

    pipe = make_device_pipeline(load_swap_model(path, "a"))
    frames = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev)
    run = time_pipeline(pipe, frames, launches, warmup=3, batches=20)
    report_pipeline(f"{size}^2 x{batch} single-pass swap (uint8 on the card "
                    "both ways)", run, batch, size, card)
    check(not any(run["counts"].values()),
          "the single-pass pipeline launched a noise kernel")
    check(torch.equal(run["outs"][0], run["outs"][-1]),
          "the single-pass pipeline is not deterministic")
    return dict(step=lambda u8: pipe(u8, 0), size=size, batch=batch,
                step_ms=run["host_ms"])


def serving_ddim(path: Path, dev, launches, card: str, *, size: int = 448,
                 batch: int = 8, steps: int = 10) -> tuple[dict, dict]:
    """Phase 9d: the DDIM pipeline at 448^2 x 8, 10 steps, through the
    shadow of a. Returns the path's launch counts, and the pipeline as a
    path for ``profile_steps``."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        normalise_batch)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)

    model = load_swap_model(path, "a", use_ema=True)
    pipe = make_device_pipeline(model, sampler_steps=steps, seed=SEED)
    frames = torch.from_numpy(np.random.default_rng(SEED + 11).integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev)
    run = time_pipeline(pipe, frames, launches, warmup=2, batches=24)
    report_pipeline(f"{size}^2 x{batch} DDIM, {steps} steps ({steps + 1} "
                    "forwards)", run, batch, size, card)
    counts = run["counts"]
    check(counts == {"fused_noise_blend": run["n"]},
          f"the DDIM pipeline launched {counts} in {run['n']} batches, not "
          "one fp32 noise blend a batch")
    # Outside the counted run: determinism, and the pipeline's own first
    # U-Net input (x_init) against the plain blend of the same stream.
    check(torch.equal(pipe(frames, 0), run["outs"][0]),
          "the same batch index gave other frames")
    check(not torch.equal(pipe(frames, 1), run["outs"][0]),
          "another batch index gave the same frames")
    inputs = []
    forward = model.predict

    def recorded(z):
        inputs.append(z.clone())
        return forward(z)

    model.predict = recorded
    pipe(frames, 5)
    del model.predict
    x = normalise_batch(frames, model.mean, model.std)
    r0 = torch.full((batch,), 0.7, device=dev)
    compare_ulp(inputs[0], nk.fused_noise_blend_plain(x, r0, seed=SEED,
                                                      offset=5),
                f"{size}^2 x{batch} DDIM x_init (kernel) vs the plain blend")
    log(f"  the same batch index gives the same frames, another index "
        f"other frames; {len(inputs)} forwards a batch")
    check(len(inputs) == steps + 1,
          f"a {steps}-step DDIM batch did not run {steps + 1} forwards")
    return counts, dict(step=lambda u8: pipe(u8, 0), size=size,
                        batch=batch, step_ms=run["host_ms"])


def wire_shape(frames: np.ndarray, fmt: str) -> str:
    """The ``X-Shape`` header of a frame stack: ``N,H,W,3``, or ``N,H,W``
    for packed i420 frames."""
    if fmt == "i420":
        n, h15, w = frames.shape
        return f"{n},{h15 * 2 // 3},{w}"
    return ",".join(str(d) for d in frames.shape)


def post_raw(port: int, frames: np.ndarray, shape_hdr: str | None = None,
             fmt: str = "rgb"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/swap_raw", body=frames.tobytes(),
                     headers={"X-Shape": shape_hdr or wire_shape(frames, fmt),
                              "X-Format": fmt})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("X-Shape")
    finally:
        conn.close()


def get_json(port: int, route: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", route)
        resp = conn.getresponse()
        check(resp.status == 200, f"GET {route} answered {resp.status}")
        return json.loads(resp.read())
    finally:
        conn.close()


def serving_http(path: Path, dev, launches, card: str, *, size: int = 448,
                 batch: int = 8, clients: int = 4, requests: int = 75,
                 transfer: str = "rgb") -> float:
    """Phase 9e (and 11d with ``transfer="i420"``): SwapEngine +
    SwapServer answering ``clients`` closed-loop clients, each posting
    ``requests`` timed ``/v1/swap_raw`` requests of 1-3 frames in the
    engine's wire format after 2 untimed ones. Returns the served
    frames/s.

    cuDNN's bf16 convolutions do not promise a frame the same low bits in
    every slot of a batch, so each reply is held against the device batch
    that carried it: the batch's frames bit-equal to the request's, the
    reply bit-equal to the batch's output there, and that output within 1
    LSB of the pipeline run directly on the same batch. Each request's
    frames carry its number in their first three bytes, which finds them
    there. How far a reply lies from the pipeline on its frames alone
    (padded from slot 0) is printed."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        pack_rgb_batch_to_i420_np)
    from denoising_diffusion_deep_fake_tpu_torch.serving import SwapEngine
    from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
        SwapServer)

    engine = SwapEngine(path, "a", height=size, width=size,
                        batch_size=batch, transfer=transfer)
    warm_s = engine.warmup()
    ran = []                       # (frames, output, batch index), on card
    pipeline = engine._dispatchers[0].pipeline

    def recorded(frames, batch_idx):
        out = pipeline(frames, batch_idx)
        ran.append((frames.clone(), out, batch_idx))
        return out

    engine._dispatchers[0].pipeline = recorded
    rng = np.random.default_rng(SEED + 12)
    stacks = [rng.integers(0, 256, (int(rng.integers(1, 4)), size, size, 3),
                           np.uint8) for _ in range(24)]
    if transfer == "i420":
        stacks = [pack_rgb_batch_to_i420_np(f) for f in stacks]
    sent = []                      # request number -> its frames

    def stamp(frames):
        """The first three bytes of each frame: request number, slot."""
        return frames.reshape(len(frames), -1)[:, :3]

    def stamped(k):
        frames = stacks[k].copy()
        r = len(sent)
        stamp(frames)[:] = [[r & 255, r >> 8, j + 1]
                            for j in range(len(frames))]
        sent.append(frames)
        return frames

    server = SwapServer(engine, host="127.0.0.1", port=0)
    server.start()

    def traffic(n: int):
        """Each client posts ``n`` stamped stacks; returns the wall seconds
        and, per request, (request number, latency ms, reply)."""
        plan = [[stamped(k) for k in row]
                for row in rng.integers(0, len(stacks), (clients, n))]
        done = [[] for _ in range(clients)]

        def client(c):
            for frames in plan[c]:
                lo, hi, _ = stamp(frames)[0]
                t0 = time.perf_counter()
                reply = post_raw(server.port, frames, fmt=transfer)
                done[c].append((int(lo) | int(hi) << 8,
                                (time.perf_counter() - t0) * 1e3, reply))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a client hung")
        return wall_s, [r for d in done for r in d]

    try:
        _, warm = traffic(2)
        before = engine.stats()
        launches.clear()
        wall_s, timed = traffic(requests)
        counts = dict(launches)
        stats = get_json(server.port, "/v1/stats")
        # The device-batch times of the timed window alone: the engine's
        # rolling window also holds the warm-up batches.
        n_batches = stats["batches"] - before["batches"]
        with engine._stats_lock:
            batch_ms = sorted(engine._stats.recent_batch_ms[-n_batches:])
        n_frames = sum(sent[r].shape[0] for r, _, _ in timed)
        lat = sorted(ms for _, ms, _ in timed)

        def pct(xs, q):
            return float(np.percentile(xs, q))

        log(f"  engine ({transfer} wire) warm-up {warm_s:.2f} s, then "
            f"{clients} x 2 untimed requests; timed: {clients} clients x "
            f"{requests} requests, {n_frames} frames in "
            f"{wall_s * 1e3:.1f} ms: {n_frames / wall_s:.1f} frames/s "
            f"served over HTTP, {n_batches} device batches, occupancy "
            f"{n_frames / (n_batches * batch):.4f}; device batch "
            f"(dispatch to fetch) p50 {pct(batch_ms, 50):.3f} ms, p99 "
            f"{pct(batch_ms, 99):.3f} ms, max {batch_ms[-1]:.3f} ms; request "
            f"latency p50 {pct(lat, 50):.1f} ms, p90 {pct(lat, 90):.1f} ms, "
            f"p99 {pct(lat, 99):.1f} ms, max {lat[-1]:.1f} ms; "
            f"{stacks[0][0].nbytes} bytes a frame each way [{card}]")
        log(f"  launches: {counts}")
        check(not any(counts.values()), "the engine launched a noise kernel")
        check(stats["errors"] == 0 and stats["shed_requests"] == 0
              and stats["frames"] - before["frames"] == n_frames
              and len(batch_ms) == n_batches
              and stats["transfer"] == transfer,
              f"engine stats off: {stats}")
        check(all(k in stats for k in ("batch_occupancy",
                                       "p50_device_batch_ms",
                                       "p99_device_batch_ms")),
              "/v1/stats lacks occupancy or latency percentiles")

        # Each device batch against the pipeline run directly on it.
        direct = make_device_pipeline(engine.model, transfer=transfer)
        shares = [u8_compare(out, direct(frames, idx), "an engine batch "
                             "against the pipeline on the same batch",
                             quiet=True) for frames, out, idx in ran]
        log(f"  {len(ran)} device batches of the engine: each within 1 LSB "
            f"of the pipeline run directly on the same batch; differing "
            f"share {min(shares):.3e}-{max(shares):.3e}")
        # Each reply found in its batch by the stamps, bit for bit.
        host = [(f.cpu().numpy(), o.cpu().numpy()) for f, o, _ in ran]
        slot = {}
        for b, (frames, _) in enumerate(host):
            for s, (lo, hi, j) in enumerate(stamp(frames)):
                if j:
                    slot[(int(lo) | int(hi) << 8, int(j) - 1)] = (b, s)
        alone_max, alone_n, alone_of = 0, 0, 0
        for r, _, (status, body, shape) in warm + timed:
            check(status == 200, f"/v1/swap_raw answered {status}")
            check(shape == wire_shape(sent[r], transfer),
                  f"a reply's X-Shape is {shape}")
            got = np.frombuffer(body, np.uint8).reshape(sent[r].shape)
            for j in range(len(got)):
                b, s = slot[(r, j)]
                check(np.array_equal(host[b][0][s], sent[r][j])
                      and np.array_equal(host[b][1][s], got[j]),
                      "an HTTP reply is not the output of its device batch")
            padded = torch.zeros((batch,) + engine.wire_frame_shape,
                                 dtype=torch.uint8, device=dev)
            padded[:len(got)] = torch.from_numpy(sent[r]).to(dev)
            diff = (torch.from_numpy(got.copy()).to(dev).to(torch.int16)
                    - direct(padded, 0)[:len(got)].to(torch.int16)).abs()
            alone_max = max(alone_max, int(diff.max()))
            alone_n += int((diff > 0).sum())
            alone_of += diff.numel()
        log(f"  all {len(warm) + len(timed)} replies bit-equal to their "
            f"device batch's output; against the pipeline on their frames "
            f"alone (padded from slot 0): max |difference| {alone_max} LSB, "
            f"differing share {alone_n / alone_of:.3e} (cuDNN's bf16 "
            f"convolutions by batch slot; reported, not checked)")
        health = get_json(server.port, "/healthz")
        check(health["status"] == "ok" and health["frame_shape"] == [
            size, size, 3] and health["transfer"] == transfer
            and health["formats"] == ["rgb", "i420"],
            f"/healthz answered {health}")
        bad = (f"1,{size},{size + 1}" if transfer == "i420"
               else f"1,{size},{size + 1},3")
        status, body, _ = post_raw(server.port, stacks[0], bad, transfer)
        check(status == 400, f"a bad X-Shape answered {status}")
        log(f"  /healthz ok (formats {health['formats']}), /v1/stats ok, "
            f"bad X-Shape -> {status}")
        return n_frames / wall_s
    finally:
        server.shutdown()


# ------------------------------------------------ phase 10: training from disk


def _crc_byte(n: int) -> int:
    for _ in range(8):
        n = (n >> 1) ^ (0x82F63B78 * (n & 1))
    return n


# CRC-32C from its polynomial: an implementation apart from the port's.
_CRC_TABLE = [_crc_byte(n) for n in range(256)]


def _masked_crc(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _proto_fields(buf: bytes):
    """``(field number, value)`` of a protobuf message: an int for a
    varint, bytes otherwise."""
    i = 0

    def varint():
        nonlocal i
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    while i < len(buf):
        key = varint()
        kind = key & 7
        if kind == 0:
            yield key >> 3, varint()
        elif kind == 2:
            n = varint()
            yield key >> 3, buf[i:i + n]
            i += n
        else:
            width = 8 if kind == 1 else 4
            yield key >> 3, buf[i:i + width]
            i += width


def read_event_file(log_dir: Path) -> list:
    """``(step, tag, simple_value or None for an image)`` of every summary
    value in the one event file under ``log_dir``; every record's length
    and payload CRC checked."""
    files = list(log_dir.glob("events.out.tfevents.*"))
    check(len(files) == 1, f"{log_dir}: {len(files)} event files")
    data, rows, i = files[0].read_bytes(), [], 0
    while i < len(data):
        header = data[i:i + 8]
        n = int.from_bytes(header, "little")
        payload = data[i + 12:i + 12 + n]
        check(int.from_bytes(data[i + 8:i + 12], "little")
              == _masked_crc(header)
              and int.from_bytes(data[i + 12 + n:i + 16 + n], "little")
              == _masked_crc(payload), f"{files[0]}: a record's CRC fails")
        i += 16 + n
        event = dict(_proto_fields(payload))
        for _, value in _proto_fields(event.get(5, b"")):
            fields = dict(_proto_fields(value))
            simple = (struct.unpack("<f", fields[2])[0] if 2 in fields
                      else None)
            rows.append((event.get(2, 0), fields[1].decode(), simple))
    return rows


def write_frames(root: Path, n: int, size: int, seed: int) -> Path:
    """``n`` uint8 RGB frames as ``.npy`` files and their manifest."""
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    paths = []
    for i in range(n):
        paths.append(root / f"{i:05d}.npy")
        np.save(paths[-1], rng.integers(0, 256, (size, size, 3), np.uint8))
    write_image_manifest(root / "images.txt", paths)
    return root / "images.txt"


def fit_counted(fit, launches, *args, **kwargs):
    """A runner's call with the launch counts from 0, and the counts."""
    torch.cuda.synchronize()
    launches.clear()
    out = fit(*args, verbose=False, decode_fn=np.load, **kwargs)
    torch.cuda.synchronize()
    return out, dict(launches)


def check_launches(counts: dict, want: dict, what: str) -> None:
    log(f"  launches: {counts}")
    for kernel in KERNELS:
        check(counts.get(kernel, 0) == want.get(kernel, 0),
              f"{what}: {kernel} launched {counts.get(kernel, 0)} times, "
              f"not {want.get(kernel, 0)}")


def state_tensors(state) -> dict:
    """Every tensor of a ModelState: weights and BN buffers, the shadow's,
    Adam's moments and steps."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.has_ema:
        out.update({f"ema.{k}": v
                    for k, v in state.ema_model.state_dict().items()})
    for i, per in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in per.items()})
    return out


def states_differ(got, want) -> list:
    """Names of the tensors and counters where two states (or identity
    dicts of them) differ by a bit; ``[]`` when they are equal."""
    got = got if isinstance(got, dict) else {"state": got}
    want = want if isinstance(want, dict) else {"state": want}
    bad = []
    for name in want:
        g, w = got[name], want[name]
        if (g.step, g.ema_step, g.has_ema) != (w.step, w.ema_step,
                                               w.has_ema):
            bad.append(f"{name}.counters")
        gt, wt = state_tensors(g), state_tensors(w)
        if gt.keys() != wt.keys():
            bad.append(f"{name}: other tensors")
            continue
        bad += [f"{name}.{k}" for k in wt if not (
            gt[k].device == wt[k].device and torch.equal(gt[k], wt[k]))]
    return bad


def tree_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def loop_denoiser(root: Path, data: Path, dev, launches, card: str,
                  step_ms: float) -> tuple[dict, dict]:
    """Phase 10b: fit_denoiser at configs/denoiser.yml's width, 2 epochs of
    3 steps; the event file, the restore, epoch 2's rate. Returns the
    launch counts and the checkpoint figures."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict, config_to_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(data), batch_size=16, learning_rate=0.02,
        max_epochs=2, cosine_scheduler_max_epoch=100,
        encoder_name="resnet34", noise_exponential_sampling_lambda=5,
        compute_dtype="bfloat16", image_size=448, seed=SEED,
        log_dir=str(root / "runs"), checkpoint_dir=str(root / "denoiser")))
    marks, events = {}, {}

    def mark(step, state, metrics):
        events[step] = torch.cuda.Event(enable_timing=True)
        events[step].record()
        if step in (3, 6):   # the ends of epochs 1 and 2
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()

    (state, trainer, ctx), counts = fit_counted(
        fit_denoiser, launches, cfg, step_callback=mark)
    check(ctx.global_step == state.step == 6 and ctx.epoch == 1,
          f"fit_denoiser ran {ctx.global_step} steps, not 6")
    check_launches(counts, {"affine_warp_fused": 6, "fused_noise_blend": 6},
                   "fit_denoiser")
    loop_ms = (marks[6] - marks[3]) / 3 * 1e3
    steps_ms = [events[s - 1].elapsed_time(events[s]) for s in (4, 5, 6)]
    log(f"  fit_denoiser 448^2 x16, 2 epochs of 3 steps: epoch 2 "
        f"{loop_ms:.3f} ms a step, {16 / loop_ms * 1e3:.1f} imgs/s through "
        f"the loop (loader, upload, step, metric worker; host clock from "
        f"the synchronised end of epoch 1); its steps on the device "
        f"timeline {', '.join(f'{t:.3f}' for t in steps_ms)} ms (the first "
        f"across the epoch boundary); phase 5's step alone {step_ms:.3f} "
        f"ms, {16 / step_ms * 1e3:.1f} imgs/s [{card}]")
    rows = read_event_file(root / "runs" / "denoiser")
    losses = [(s, v) for s, t, v in rows if t == "loss"]
    check([s for s, _ in losses] == list(range(6))
          and all(math.isfinite(v) for _, v in losses),
          f"the event file's loss rows are {losses}")
    log(f"  event file: {len(rows)} values, every record's CRC checked; "
        f"loss rows {[round(v, 5) for _, v in losses]}; tags "
        f"{sorted({t for _, t, _ in rows})}")

    manager = CheckpointManager(cfg.checkpoint_dir)
    check(manager.all_steps() == [6], f"checkpoints {manager.all_steps()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generator = torch.Generator(device=dev)
    restored, meta = manager.restore(lambda: trainer.init_state(SEED + 1),
                                     generator=generator)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = states_differ(restored, state)
    check(not bad, f"the restored denoiser differs: {bad[:5]}")
    check(torch.equal(generator.get_state(), trainer.generator.get_state())
          and meta["extra"]["global_step"] == 6,
          "the restored generator or counters differ")
    fused = [v for k, v in state_tensors(restored).items()
             if k.startswith("adam.") and k.endswith(".step")]
    check(all(v.device.type == "cuda" for v in fused),
          "the fused Adam's steps did not come back to the card")
    # The save's figures: blocking, and the non-blocking call's return.
    again = CheckpointManager(root / "resave")
    hparams = config_to_dict(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again.save(6, state, hparams)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again.save(7, state, hparams, block=False)
    snapshot_s = time.perf_counter() - t0
    again.wait_until_finished()
    n_bytes = tree_bytes(again.step_dir(6))
    log(f"  final checkpoint restored bit-equal (weights, BN buffers, "
        f"Adam moments and steps on the card, counters, generator) in "
        f"{restore_s:.3f} s; a blocking save {save_s:.3f} s, "
        f"{n_bytes / 1e6:.1f} MB; a non-blocking save returns after "
        f"{snapshot_s:.3f} s (the host snapshot) [{card}]")
    return counts, dict(denoiser_mb=n_bytes / 1e6, save_s=save_s,
                        snapshot_s=snapshot_s, restore_s=restore_s,
                        loop_imgs_s=16 / loop_ms * 1e3)


def deep_fake_cfg(data: dict, root: Path, name: str, **overrides):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, config_from_dict)

    return config_from_dict(DeepFakeConfig, dict(
        DENOISE_YML, data_path_a=str(data["a"]), data_path_b=str(data["b"]),
        log_dir=str(root / name / "runs"),
        checkpoint_dir=str(root / name / "ckpt"), **overrides))


def loop_deep_fake(root: Path, data: dict, dev, launches,
                   card: str) -> tuple[dict, Path, float]:
    """Phase 10c: fit_deep_fake in denoise mode for 1 epoch, then resumed
    to epoch 2. Returns the launch counts, the checkpoint directory and
    the size of its first checkpoint in MB."""
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)

    cfg = deep_fake_cfg(data, root, "denoise", max_epochs=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (states, _, ctx), counts = fit_counted(fit_deep_fake, launches, cfg)
    first_s = time.perf_counter() - t0
    check(ctx.global_step == 3 and all(s.step == 3 for s in states.values()),
          f"fit_deep_fake ran {ctx.global_step} steps, not 3")
    check_launches(counts, {"affine_warp_fused": 6, "fused_noise_blend": 6},
                   "fit_deep_fake")
    n_bytes = tree_bytes(Path(cfg.checkpoint_dir))
    starts = []
    cfg2 = deep_fake_cfg(data, root, "denoise", max_epochs=2)
    (states, _, ctx), resumed = fit_counted(
        fit_deep_fake, launches, cfg2, resume_from=cfg.checkpoint_dir,
        step_callback=lambda step, *_: starts.append(step))
    check(starts == [4, 5, 6] and ctx.global_step == 6
          and ctx.epoch == 1 and all(s.step == 6 for s in states.values()),
          f"the resume ran steps {starts}, ending at {ctx.global_step} in "
          f"epoch {ctx.epoch}")
    check_launches(resumed, {"affine_warp_fused": 6,
                             "fused_noise_blend": 6}, "the resume")
    log(f"  fit_deep_fake 448^2, 16 per identity, denoise mode: 1 epoch (3 "
        f"steps) in {first_s:.2f} s with its final save of {n_bytes / 1e6:.1f}"
        f" MB; resumed at global_step 3, epoch 1, ran steps 4-6 [{card}]")
    return {"new": counts, "resume": resumed}, Path(cfg.checkpoint_dir), \
        n_bytes / 1e6


def resume_equivalence(root: Path, dev, launches) -> dict:
    """Phase 10c, small: 64^2 resnet18 fp32, 2 epochs against 1 epoch and a
    resume, under cudnn.deterministic: every tensor bit-equal."""
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)

    data = {n: write_frames(root / f"small_{n}", 8, 64, SEED + 30 + i)
            for i, n in enumerate("ab")}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        small = dict(batch_size=4, encoder_name="resnet18",
                     compute_dtype="float32", image_size=64, max_epochs=2)
        whole_cfg = deep_fake_cfg(data, root, "small_whole", **small)
        (whole, whole_trainer, _), counts = fit_counted(
            fit_deep_fake, launches, whole_cfg)
        cfg = deep_fake_cfg(data, root, "small_resumed", **small)
        fit_counted(fit_deep_fake, launches, cfg, max_steps=2)
        (resumed, trainer, ctx), _ = fit_counted(
            fit_deep_fake, launches, cfg, resume_from=cfg.checkpoint_dir)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    check_launches(counts, {"fused_noise_blend": 8}, "the 64^2 run")
    bad = states_differ(resumed, whole)
    if bad:
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for name in whole
                  for k, b in state_tensors(whole[name]).items()
                  for a in [state_tensors(resumed[name])[k]]
                  if a.is_floating_point())
        log(f"  {len(bad)} tensors differ, the largest by {rel:.3e} of its "
            "tensor's magnitude")
    check(ctx.global_step == 4 and not bad,
          f"1 epoch + resume differs from 2 epochs: {bad[:5]}")
    check(torch.equal(trainer.generator.get_state(),
                      whole_trainer.generator.get_state()),
          "the resumed generator differs")
    log("  64^2 resnet18 fp32, cudnn.deterministic: 2 epochs of 2 steps "
        "against 1 epoch + resume: every weight, BN buffer, Adam moment and "
        "step, counter and the generator bit-equal")
    return counts


def loop_modify(root: Path, data: dict, source: Path, dev, launches,
                card: str) -> dict:
    """Phase 10d: modify to swap mode from 10c's checkpoint, 1 epoch;
    load_swap_model from its final checkpoint answers one batch."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, overlay_config)
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        shadow_tensors)

    meta = CheckpointManager(source).read_meta()
    cfg = overlay_config(DeepFakeConfig, meta["hparams"], dict(
        SWAP_YML, checkpoint_dir=str(root / "swap" / "ckpt"),
        log_dir=str(root / "swap" / "runs")))
    b_before = CheckpointManager(source).restore_partial(
        "b", ["model"], device=dev)["model"]
    at_flip = []

    def first_step(step, states, metrics):
        if step != 1:
            return
        a, b = states["a"], states["b"]
        at_flip.append(
            all(s.step == 1 and s.ema_step == 1 for s in states.values())
            and all(float(p["step"]) == 1 for s in states.values()
                    for p in s.optimizer.state_dict()["state"].values())
            and all(torch.equal(e, b_before[k]) for k, e in
                    b.ema_model.state_dict().items())
            and all(torch.equal(e, p) for e, p in zip(
                shadow_tensors(a.ema_model), shadow_tensors(a.model))))

    (states, _, ctx), counts = fit_counted(
        fit_deep_fake, launches, cfg, modify_from=str(source), max_steps=3,
        step_callback=first_step)
    check(at_flip == [True], "after the flip's first step: not a fresh Adam"
          " at step 1, or ema_b not b's checkpoint weights, or ema_a not a's"
          " post-step weights")
    check(ctx.global_step == 3 and cfg.mode == "swap",
          f"modify ran {ctx.global_step} steps in mode {cfg.mode}")
    check_launches(counts, {"affine_warp_fused": 6, "fused_noise_blend": 6},
                   "modify")
    model = load_swap_model(cfg.checkpoint_dir, "a", use_ema=True)
    frames = torch.from_numpy(np.load(Path(data["b"]).parent / "00000.npy")
                              )[None].to(dev).expand(16, -1, -1, -1)
    out = make_device_pipeline(model)(frames, 0)
    torch.cuda.synchronize()
    check(out.dtype == torch.uint8 and out.shape == frames.shape,
          "the swap model from the modify checkpoint did not answer")
    log(f"  modify -> swap (configs/swap.yml overlaid): fresh Adam at step "
        f"0, shadows copies of the models at the flip (ema_b the "
        f"checkpoint's b, ema_a a's post-step), 3 steps; load_swap_model "
        f"(shadow of a) from its final checkpoint answered a batch of "
        f"{tuple(out.shape)} uint8 [{card}]")
    return counts


def loop_balance(root: Path, data: Path, dev, launches, card: str) -> dict:
    """Phase 10e: fit_balance at configs/balance.yml's width, 448^2, batch
    12, 1 epoch over identity a's 48 frames."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        read_image_manifest, read_image_manifest_with_classes)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        HISTOGRAM_TAG, fit_balance)

    out = root / "balanced.txt"
    cfg = config_from_dict(BalanceConfig, dict(
        data_path=str(data), output_image_list_path=str(out), batch_size=12,
        learning_rate=0.01, max_epochs=1, encoder_name="resnet34",
        ratio_of_noise=0.7, number_of_classes=10, compute_dtype="bfloat16",
        image_size=448, seed=SEED, log_dir=str(root / "runs"),
        checkpoint_dir=str(root / "balance")))
    (state, _, ctx), counts = fit_counted(fit_balance, launches, cfg)
    check(ctx.global_step == state.step == 4,
          f"fit_balance ran {ctx.global_step} steps, not 4")
    check_launches(counts, {"fused_normalise_noise_blend": 8},
                   "fit_balance (4 steps, 4 scoring batches)")
    paths, classes = read_image_manifest_with_classes(out)
    check(paths == read_image_manifest(data) and classes is not None
          and len(classes) == 48 and min(classes) >= 0
          and max(classes) <= 9, "the balanced manifest does not read back")
    rows = read_event_file(root / "runs" / "balance")
    check((4, HISTOGRAM_TAG, None) in rows,
          f"no {HISTOGRAM_TAG} image at step 4 in the event file")
    log(f"  fit_balance 448^2 x12: 4 steps, 48 images scored; manifest of "
        f"{len(classes)} lines, class counts "
        f"{np.bincount(classes, minlength=10).tolist()}; the histogram "
        f"image in the event file [{card}]")
    return counts


def training_from_disk(dev, launches, card: str, step_ms: float,
                       root: Path) -> tuple[dict, dict, float]:
    """Phase 10: the runners from .npy datasets written under ``root``.
    Returns the launch counts by path, the datasets' manifests (phase 11
    trains from them too) and 10b's loop rate."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    t0 = time.perf_counter()
    data = {n: write_frames(root / n, 48, 448, SEED + 20 + i)
            for i, n in enumerate("ab")}
    log(f"[10a] datasets: 2 identities x 48 uint8 448^2 frames as .npy "
        f"({tree_bytes(root) / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.2f} s")
    log("[10b] fit_denoiser: 448^2, batch 16, 2 epochs")
    denoiser, figures = loop_denoiser(root, data["a"], dev, launches,
                                      card, step_ms)
    log("[10c] fit_deep_fake: new, then resume")
    deep_fake, source, pair_mb = loop_deep_fake(root, data, dev,
                                                launches, card)
    small = resume_equivalence(root, dev, launches)
    log("[10d] modify to swap mode")
    modify = loop_modify(root, data, source, dev, launches, card)
    log("[10e] fit_balance: 448^2, batch 12, 1 epoch")
    balance = loop_balance(root, data["a"], dev, launches, card)
    log(f"[10f] checkpoints: denoiser {figures['denoiser_mb']:.1f} MB, saved "
        f"in {figures['save_s']:.3f} s (non-blocking call returns after "
        f"{figures['snapshot_s']:.3f} s), restored in "
        f"{figures['restore_s']:.3f} s; a denoise-mode pair "
        f"{pair_mb:.1f} MB; phase 10 peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"{time.perf_counter() - start:.1f} s [{card}]")
    return ({"fit_denoiser_448": denoiser,
             "fit_deep_fake_new_448": deep_fake["new"],
             "fit_deep_fake_resume_448": deep_fake["resume"],
             "fit_deep_fake_64": small,
             "fit_deep_fake_modify_448": modify,
             "fit_balance_448": balance}, data, figures["loop_imgs_s"])


# ------------------------------------- phase 11: the i420 wire and video


def i420_ops(dev, card: str) -> None:
    """Phase 11a: the i420 ops at 448^2 x 16 on the card against the CPU,
    the host pack and unpack against cv2's converters (bit for bit where
    cv2 imports; they are the JAX package's) with the device's within 1
    LSB of the pack and 2 of the unpack (the CPU test's tolerances), or,
    where cv2 does not import, bit-equal to the device's; and their
    times."""
    from denoising_diffusion_deep_fake_tpu_torch.data.codec import (
        cv2_or_none)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        i420_to_rgb, pack_rgb_batch_to_i420_np, rgb_to_i420,
        unpack_i420_batch_to_rgb_np)

    host = np.random.default_rng(SEED + 30).integers(
        0, 256, (16, 448, 448, 3), np.uint8)
    u8 = torch.from_numpy(host).to(dev)
    packed = rgb_to_i420(u8)
    cpu_packed = rgb_to_i420(torch.from_numpy(host))
    u8_compare(packed.cpu(), cpu_packed, "448^2 x16 rgb_to_i420, card vs CPU")
    err = float((i420_to_rgb(packed).cpu() - i420_to_rgb(cpu_packed)).abs()
                .max())
    log(f"  448^2 x16 i420_to_rgb, card vs CPU: max |difference| {err:.3e} "
        "(limit 1e-3)")
    check(err <= 1e-3, "i420_to_rgb on the card disagrees with the CPU")
    host_packed = pack_rgb_batch_to_i420_np(host)
    host_back = unpack_i420_batch_to_rgb_np(host_packed)
    device_back = torch.round(i420_to_rgb(torch.from_numpy(
        host_packed).to(dev))).to(torch.uint8).cpu()
    back_lsb = int((device_back.to(torch.int16)
                    - torch.from_numpy(host_back).to(torch.int16)).abs()
                   .max())
    cv2 = cv2_or_none()
    if cv2 is None:
        check(np.array_equal(host_packed, packed.cpu().numpy())
              and back_lsb == 0, "without cv2 the host pack or unpack is "
              "not the device's")
        log("  no cv2: the host pack and unpack are the device functions "
            "on CPU tensors, bit for bit")
    else:
        check(all(np.array_equal(host_packed[i], cv2.cvtColor(
            host[i], cv2.COLOR_RGB2YUV_I420)) for i in range(len(host)))
            and all(np.array_equal(host_back[i], cv2.cvtColor(
                host_packed[i], cv2.COLOR_YUV2RGB_I420))
                for i in range(len(host))),
            "the host pack or unpack is not cv2's")
        u8_compare(packed.cpu(), torch.from_numpy(host_packed),
                   f"device pack vs the host's (cv2 {cv2.__version__})")
        log(f"  device unpack vs the host's (cv2): max |difference| "
            f"{back_lsb} LSB (limit 2)")
        check(back_lsb <= 2, "the device unpack is more than 2 LSB from "
              "cv2's")
    t0 = time.perf_counter()
    for _ in range(5):
        pack_rgb_batch_to_i420_np(host)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    pack_ms = time_ms(lambda: rgb_to_i420(u8), 20)
    unpack_ms = time_ms(lambda: i420_to_rgb(packed), 20)
    log(f"  a batch of 16 448^2 frames: {host.nbytes} bytes RGB, "
        f"{host_packed.nbytes} i420; host pack {host_ms:.3f} ms (mean of "
        f"5, torch.get_num_threads() {torch.get_num_threads()}), device "
        f"pack {pack_ms:.3f} ms, device unpack {unpack_ms:.3f} ms (device "
        f"time, mean of 20) [{card}]")


def balancer_reference(dev) -> None:
    """Phase 11b: a 64^2 fp32 i420 balancer step on the GPU against the
    CPU plain path, with the noise injected."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        rgb_to_i420)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        BalanceTrainer)

    rng = np.random.default_rng(SEED + 31)
    b, s = 2, 64
    packed = rgb_to_i420(torch.from_numpy(rng.integers(
        0, 256, (b, s, s, 3), np.uint8)))
    noise = torch.from_numpy(rng.standard_normal((b, s, s, 3)).astype(
        np.float32))
    losses = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        cfg = config_from_dict(BalanceConfig, dict(
            data_path="synthetic", batch_size=b, encoder_name="resnet18",
            compute_dtype="float32", image_size=s, upload_format="i420",
            seed=SEED))
        trainer = BalanceTrainer(cfg, steps_per_epoch=1000, image_size=s,
                                 device=device)
        m = trainer.train_step(trainer.init_state(seed=7), packed,
                               noise=noise.to(device))
        losses[name] = float(m["loss"])
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"  64^2 fp32 i420 balancer step loss: cuda {losses['cuda']:.7f}, "
        f"cpu {losses['cpu']:.7f}, relative difference {rel:.2e} (limit "
        "1e-4)")
    check(math.isfinite(losses["cuda"]) and rel < 1e-4,
          "the GPU i420 balancer step disagrees with the CPU reference")


def rate_line(what: str, run: dict, rgb_run: dict) -> None:
    images = run["images"]
    log(f"  {what}: i420 {images / run['step_ms'] * 1e3:.1f} imgs/s beside "
        f"the rgb upload's {images / rgb_run['step_ms'] * 1e3:.1f} in this "
        "run")


def loop_denoiser_i420(root: Path, data: Path, dev, launches, card: str,
                       loop_rate: float) -> dict:
    """Phase 11b: fit_denoiser with i420 uploads from phase 10a's frames,
    1 epoch of 3 steps (the prefetch thread packs each batch)."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(data), batch_size=16, learning_rate=0.02,
        max_epochs=1, cosine_scheduler_max_epoch=100,
        encoder_name="resnet34", noise_exponential_sampling_lambda=5,
        compute_dtype="bfloat16", image_size=448, seed=SEED,
        upload_format="i420", log_dir=str(root / "runs_i420"),
        checkpoint_dir=str(root / "denoiser_i420")))
    marks, events = {}, {}

    def mark(step, state, metrics):
        events[step] = torch.cuda.Event(enable_timing=True)
        events[step].record()
        if step in (1, 3):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()

    (state, _, ctx), counts = fit_counted(fit_denoiser, launches, cfg,
                                          step_callback=mark)
    check(ctx.global_step == state.step == 3,
          f"fit_denoiser (i420) ran {ctx.global_step} steps, not 3")
    check_launches(counts, {"affine_warp_fused": 3, "fused_noise_blend": 3},
                   "fit_denoiser (i420)")
    loop_ms = (marks[3] - marks[1]) / 2 * 1e3
    log(f"  fit_denoiser 448^2 x16, i420 uploads, 1 epoch of 3 steps: steps "
        f"2-3 {loop_ms:.3f} ms a step, {16 / loop_ms * 1e3:.1f} imgs/s "
        f"through the loop (host clock between synchronised step ends); "
        f"steps 2-3 on the device timeline "
        f"{events[1].elapsed_time(events[2]):.3f}, "
        f"{events[2].elapsed_time(events[3]):.3f} ms; 10b's rgb epoch 2 "
        f"{loop_rate:.1f} imgs/s [{card}]")
    return counts


def i420_training(dev, launches, card: str, rgb_runs: dict, root: Path,
                  data: Path, loop_rate: float) -> dict:
    """Phase 11b: the three trainers with i420 uploads at full width, the
    small GPU-vs-CPU references, and fit_denoiser. Returns the launch
    counts by path."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        rgb_to_i420)

    run = single_path(make_trainer(dev, encoder="resnet34", batch=16,
                                   size=448, dtype="bfloat16",
                                   upload_format="i420"),
                      size=448, batch=16)
    run = drive(dev, launches, card, dict(run, wire=rgb_to_i420),
                warmup=3, steps=20,
                per_step={"affine_warp_fused": 1, "fused_noise_blend": 1})
    rate_line("denoiser 448^2 x16", run, rgb_runs["denoiser"])
    profile_steps(run, dev, None)
    paths = {"denoiser_i420_448": run["counts"]}

    trainer = make_deep_fake(dev, upload_format="i420")
    states = trainer.init_states(seed=SEED)
    df = drive(dev, launches, card,
               dict(deep_fake_path(trainer, states,
                                   probes=online_probes(states)),
                    wire=rgb_to_i420), warmup=2, steps=5,
               per_step={"affine_warp_fused": 2, "fused_noise_blend": 2})
    rate_line("deep-fake denoise mode 448^2, 16 per identity", df,
              rgb_runs["deep_fake"])
    paths["deep_fake_denoise_i420_448"] = df["counts"]
    del trainer, states, df

    bal = drive(dev, launches, card,
                dict(single_path(make_balancer(dev, upload_format="i420"),
                                 size=448, batch=12), wire=rgb_to_i420),
                warmup=3, steps=10, per_step={"fused_noise_blend": 1})
    rate_line("balancer 448^2 x12", bal, rgb_runs["balancer"])
    paths["balancer_i420_448"] = bal["counts"]
    del bal

    small_reference(dev, upload_format="i420")
    balancer_reference(dev)
    paths["fit_denoiser_i420_448"] = loop_denoiser_i420(
        root, data, dev, launches, card, loop_rate)
    return paths


def transfer_times(dev, card: str, size: int = 448) -> None:
    """Phase 11c: one batch of 16 448^2 frames up (from pinned memory, as
    the engine uploads) and back (``.cpu()``, as it fetches), RGB and
    i420, by CUDA events."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        pack_rgb_batch_to_i420_np)

    rgb = np.random.default_rng(SEED + 32).integers(
        0, 256, (16, size, size, 3), np.uint8)
    for fmt, host in (("rgb", rgb), ("i420", pack_rgb_batch_to_i420_np(rgb))):
        pinned = torch.from_numpy(host).pin_memory()
        on_card = pinned.to(dev)
        up_ms = time_ms(lambda: pinned.to(dev, non_blocking=True), 10)
        down_ms = time_ms(lambda: on_card.cpu(), 10)
        log(f"  {fmt}: {host.nbytes} bytes a batch; upload {up_ms:.3f} ms "
            f"({host.nbytes / up_ms / 1e6:.2f} GB/s), fetch {down_ms:.3f} "
            f"ms ({host.nbytes / down_ms / 1e6:.2f} GB/s) (device time, "
            f"mean of 10) [{card}]")


def i420_pipeline(path: Path, small: Path, dev, launches, card: str,
                  rgb_rates: dict, size: int = 448) -> dict:
    """Phase 11c: the i420 pipeline, single-pass at 448^2 x 16 and DDIM at
    448^2 x 8 with 10 steps, timed as 9c and 9d; the transfers; a 64^2
    fp32 pair on the card against the CPU. Returns DDIM's launch counts."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        rgb_to_i420)

    pipe = make_device_pipeline(load_swap_model(path, "a"), transfer="i420")
    frames = rgb_to_i420(torch.from_numpy(np.random.default_rng(
        SEED + 10).integers(0, 256, (16, size, size, 3), np.uint8)).to(dev))
    run = time_pipeline(pipe, frames, launches, warmup=3, batches=20)
    report_pipeline(f"{size}^2 x16 single-pass swap, i420 on the card both "
                    "ways", run, 16, size, card, transfer="i420")
    check(not any(run["counts"].values()),
          "the i420 single-pass pipeline launched a noise kernel")
    check(torch.equal(run["outs"][0], run["outs"][-1]),
          "the i420 single-pass pipeline is not deterministic")
    log(f"  single-pass: i420 {16 / run['host_ms'] * 1e3:.1f} frames/s "
        f"beside 9c's rgb {rgb_rates['single']:.1f}")

    ddim = make_device_pipeline(load_swap_model(path, "a", use_ema=True),
                                sampler_steps=10, transfer="i420", seed=SEED)
    frames8 = rgb_to_i420(torch.from_numpy(np.random.default_rng(
        SEED + 11).integers(0, 256, (8, size, size, 3), np.uint8)).to(dev))
    run = time_pipeline(ddim, frames8, launches, warmup=2, batches=24)
    report_pipeline(f"{size}^2 x8 DDIM, 10 steps, i420", run, 8, size, card,
                    transfer="i420")
    counts = run["counts"]
    check(counts == {"fused_noise_blend": run["n"]},
          f"the i420 DDIM pipeline launched {counts} in {run['n']} batches, "
          "not one fp32 noise blend a batch")
    log(f"  DDIM: i420 {8 / run['host_ms'] * 1e3:.1f} frames/s beside 9d's "
        f"rgb {rgb_rates['ddim']:.1f}")
    transfer_times(dev, card, size)

    packed = rgb_to_i420(torch.from_numpy(np.random.default_rng(
        SEED + 9).integers(0, 256, (4, 64, 64, 3), np.uint8)))
    outs = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        model = load_swap_model(small, "a", device=device)
        outs[name] = make_device_pipeline(model, transfer="i420")(
            packed.to(device), 0).cpu()
    u8_compare(outs["gpu"], outs["cpu"],
               "64^2 fp32 single-pass i420, GPU vs CPU")
    return counts


def mixed_formats(path: Path, dev, card: str, size: int = 448,
                  batch: int = 8) -> None:
    """Phase 11d: an i420 client on an rgb engine and an rgb client on an
    i420 engine. Each reply is the server's host conversion of the output
    of the device batch that carried it, bit for bit, and that batch within
    1 LSB of the pipeline run directly on it."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        pack_rgb_batch_to_i420_np, unpack_i420_batch_to_rgb_np)
    from denoising_diffusion_deep_fake_tpu_torch.serving import SwapEngine
    from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
        SwapServer)

    rgb = np.random.default_rng(SEED + 13).integers(
        0, 256, (2, size, size, 3), np.uint8)
    for engine_fmt, client_fmt in (("rgb", "i420"), ("i420", "rgb")):
        engine = SwapEngine(path, "a", height=size, width=size,
                            batch_size=batch, transfer=engine_fmt)
        engine.warmup()
        ran = []
        pipeline = engine._dispatchers[0].pipeline

        def recorded(frames, batch_idx, pipeline=pipeline, ran=ran):
            out = pipeline(frames, batch_idx)
            ran.append((frames.clone(), out))
            return out

        engine._dispatchers[0].pipeline = recorded
        server = SwapServer(engine, host="127.0.0.1", port=0)
        server.start()
        try:
            frames = (pack_rgb_batch_to_i420_np(rgb) if client_fmt == "i420"
                      else rgb)
            status, body, shape = post_raw(server.port, frames,
                                           fmt=client_fmt)
            check(status == 200 and shape == wire_shape(frames, client_fmt)
                  and len(ran) == 1,
                  f"a {client_fmt} client on a {engine_fmt} engine got "
                  f"{status} in {len(ran)} batches")
            got = np.frombuffer(body, np.uint8).reshape(frames.shape)
            batch_in, out = ran[0]
            wire = (unpack_i420_batch_to_rgb_np(frames) if engine_fmt == "rgb"
                    else pack_rgb_batch_to_i420_np(frames))
            check(np.array_equal(batch_in[:2].cpu().numpy(), wire),
                  "the engine batch does not hold the converted frames")
            host = out[:2].cpu().numpy()
            want = (pack_rgb_batch_to_i420_np(host) if engine_fmt == "rgb"
                    else unpack_i420_batch_to_rgb_np(host))
            check(np.array_equal(got, want), f"a {client_fmt} reply from a "
                  f"{engine_fmt} engine is not its batch's output, converted")
            share = u8_compare(out, make_device_pipeline(
                engine.model, transfer=engine_fmt)(batch_in, 0), "",
                quiet=True)
            log(f"  {client_fmt} client, {engine_fmt} engine: 200, X-Shape "
                f"{shape}; the reply is the host conversion of its batch's "
                f"output, bit for bit; the batch against the pipeline on it: "
                f"differing share {share:.3e} (1 LSB at most)")
        finally:
            server.shutdown()


def render_check(path: Path, dev, launches, card: str,
                 size: int = 448) -> dict:
    """Phase 11e: render_fake_video from 60 uint8 448^2 BGR frames into
    ``write_frame``, rgb single-pass, i420 single-pass and rgb DDIM at 10
    steps, batch 8 (the tail of 4 padded to 8). Returns DDIM's launch
    counts."""
    from denoising_diffusion_deep_fake_tpu_torch.data import video
    from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
        unpack_i420_batch_to_rgb_np)

    frames = list(np.random.default_rng(SEED + 40).integers(
        0, 256, (60, size, size, 3), np.uint8))
    build = video.make_device_pipeline
    counts = {}
    for transfer, steps in (("rgb", 0), ("i420", 0), ("rgb", 10)):
        ran, direct = [], []

        def recording(model, **kw):
            pipe = build(model, **kw)
            direct.append(pipe)

            def recorded(batch, batch_idx):
                out = pipe(batch, batch_idx)
                ran.append((batch.clone(), out, batch_idx))
                return out

            return recorded

        written, stats = [], {}
        video.make_device_pipeline = recording
        try:
            torch.cuda.synchronize()
            launches.clear()
            video.render_fake_video(
                None, path, "a", width=size, height=size, batch_size=8,
                sampler_steps=steps, transfer=transfer, progress=False,
                stats_out=stats, device=dev, frames=iter(frames),
                write_frame=written.append)
            torch.cuda.synchronize()
            run_counts = counts[steps] = dict(launches)
        finally:
            video.make_device_pipeline = build
        what = f"render {transfer}" + (f" DDIM {steps} steps" if steps
                                       else " single-pass")
        check(len(written) == 60 and stats["frames"] == 60
              and stats["batches"] == len(ran) == 8,
              f"{what}: {len(written)} frames in {len(ran)} batches")
        want_counts = {"fused_noise_blend": 8} if steps else {}
        check(run_counts == want_counts,
              f"{what} launched {run_counts}, not {want_counts}")
        fakes = [o.cpu().numpy() for _, o, _ in ran]
        if transfer == "i420":
            fakes = [unpack_i420_batch_to_rgb_np(f) for f in fakes]
        for k, frame in enumerate(written):
            b, slot = divmod(k, 8)
            check(frame.shape == (size, 2 * size, 3)
                  and frame.dtype == np.uint8
                  and np.array_equal(frame[:, :size], frames[k])
                  and np.array_equal(frame[:, size:],
                                     fakes[b][slot][..., ::-1]),
                  f"{what}: frame {k} is not its real frame beside its "
                  "batch's fake")
        tail = ran[-1][0]
        check(all(torch.equal(tail[j], tail[3]) for j in range(4, 8)),
              f"{what}: the tail is not padded with its last frame")
        shares = [u8_compare(out, direct[0](batch, idx), "", quiet=True)
                  for batch, out, idx in ran]
        log(f"  {what}: 60 frames of {size}x{2 * size} in 8 batches, each "
            f"fake half "
            f"bit-equal to its batch's output (each batch within 1 LSB of "
            f"the pipeline on it, differing share "
            f"{min(shares):.3e}-{max(shares):.3e}); launches {run_counts}; "
            f"first batch {stats['first_batch_s'] * 1e3:.1f} ms, steady "
            f"{stats['steady_batch_s'] * 1e3:.3f} ms a batch, steady_fps "
            f"{stats['steady_fps']:.1f}, delivered_fps "
            f"{stats['delivered_fps']:.1f} [{card}]")
    return counts[10]


# ------------------------------------------------ phase 12: K-step graphs


def device_offsets(dev, card: str) -> dict:
    """Phase 12a: both noise kernels' device-offset launch (the form a
    train step's CUDA graph replays, reading its offset from the group's
    table) against the by-value launch at offsets below and above 2^32:
    the same Philox words and outputs, bit for bit; both forms timed by
    graph replay. Returns the device-offset form's times."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass \
        import graph_ms

    rng = np.random.default_rng(SEED + 40)
    cases = {
        "fused_normalise_noise_blend": (torch.from_numpy(rng.integers(
            0, 256, (12, 448, 448, 3), np.uint8)).to(dev),
            nk.noise_constants(*HALF, 3)),
        "fused_noise_blend": (torch.from_numpy(rng.standard_normal(
            (16, 448, 448, 3)).astype(np.float32)).to(dev), None)}
    ratios = {name: torch.from_numpy(rng.uniform(0, 1, x.shape[0]).astype(
        np.float32)).to(dev) for name, (x, _) in cases.items()}
    offsets = (3, 2 ** 32 + 7, 3 * 2 ** 40 + 11)
    for offset in offsets:
        at = torch.tensor(offset, dtype=torch.int64, device=dev)
        check(torch.equal(
            nk.philox_words(1 << 16, seed=SEED, offset=offset, device=dev),
            nk.philox_words(1 << 16, seed=SEED, offset=at, device=dev)),
            f"the Philox words at offset {offset} differ between the forms")
        for name, (x, norm) in cases.items():
            by_value, on_device = (torch.empty(x.shape, dtype=torch.float32,
                                               device=dev) for _ in "ab")
            nk.launch_blend(x, by_value, ratios[name], norm, seed=SEED,
                            offset=offset)
            nk.launch_blend(x, on_device, ratios[name], norm, seed=SEED,
                            offset=at)
            check(torch.equal(by_value, on_device),
                  f"{name}: the device-offset launch at {offset} differs "
                  "from the by-value launch")
    times = {}
    for name, (x, norm) in cases.items():
        out = torch.empty(x.shape, dtype=torch.float32, device=dev)
        at = torch.tensor(offsets[1], dtype=torch.int64, device=dev)
        value_ms = graph_ms(lambda: nk.launch_blend(
            x, out, ratios[name], norm, seed=SEED, offset=offsets[1]))
        times[name] = graph_ms(lambda: nk.launch_blend(
            x, out, ratios[name], norm, seed=SEED, offset=at))
        log(f"  {name} {tuple(x.shape)}: device-offset form "
            f"{times[name]:.4f} ms, by-value form {value_ms:.4f} ms (graph "
            f"replay) [{card}]")
    log(f"  both kernels: Philox words of 65536 groups and whole outputs "
        f"bit-equal between the forms at offsets {list(offsets)}")
    return times


def _k_flat(group: list) -> list:
    """A group's batches in the K-step call's order (grouped by position)."""
    return [x for pos in zip(*group) for x in pos]


def _small_trainers(dev) -> dict:
    """Phase 12b's cases: 64^2 x2 resnet18 fp32 trainers (the hybrid warp,
    JAX's route at 64^2, plain PyTorch) with an epoch a step, so that the cosine learning rate changes
    every step; each ``(make, init, batches a step, launches a step)``."""
    small = dict(batch_size=2, encoder_name="resnet18",
                 compute_dtype="float32", image_size=64)

    def epoch_a_step(trainer):
        trainer.steps_per_epoch = 1
        return trainer

    return {
        "denoiser": (lambda: epoch_a_step(make_trainer(
            dev, encoder="resnet18", batch=2, size=64, dtype="float32")),
            lambda t: t.init_state(seed=SEED), 1,
            {"fused_noise_blend": 1}),
        "balancer": (lambda: make_balancer(dev, **small),
                     lambda t: t.init_state(seed=SEED), 1,
                     {"fused_normalise_noise_blend": 1}),
        "deep_fake_denoise": (lambda: epoch_a_step(make_deep_fake(
            dev, **small)), lambda t: t.init_states(seed=SEED), 2,
            {"fused_noise_blend": 2}),
        # ema_update_after_step 2: the decay is 0 for ema_step 0-3 and
        # above 0 from 4, so the second group crosses the warm-up.
        "deep_fake_swap": (lambda: epoch_a_step(make_deep_fake(
            dev, dict(DENOISE_YML, **SWAP_YML), ema_update_after_step=2,
            **small)), lambda t: t.init_states(seed=SEED), 2,
            {"fused_noise_blend": 2}),
    }


def _run_eager(trainer, states, group: list) -> list:
    return [trainer.train_step(states, *b) for b in group]


def _check_same(what: str, trainer, states, eager_trainer, eager_states,
                groups: list, eager: list) -> None:
    """Graph against eager: every tensor and counter, the losses step by
    step, the generator."""
    bad = states_differ(states, eager_states)
    check(not bad, f"{what}: the graph's states differ from eager: {bad[:5]}")
    first = 0
    for group in groups:
        k = len(next(iter(group.values())))
        for key, values in group.items():
            got = [float(v) for v in values]
            want = [float(m[key]) for m in eager[first:first + k]]
            check(got == want, f"{what}: {key} {got} against eager {want}")
        first += k
    check(first == len(eager), f"{what}: {first} steps against "
          f"{len(eager)} eager")
    if trainer.generator is not None:
        check(torch.equal(trainer.generator.get_state(),
                          eager_trainer.generator.get_state()),
              f"{what}: the generator's state differs from eager")


def graph_against_eager(dev, launches, names=None) -> dict:
    """Phase 12b: at 64^2 x2, resnet18, fp32, under cudnn.deterministic, 2
    replays of a K = 3 graph against 6 eager steps from equal states: every
    weight, BN buffer, Adam moment and step (on the card), shadow, loss,
    host counter and the generator bit-equal; the graph's launches 3 x a
    step's a replay. Then a replaced optimizer (a restore through
    ``load_state_dict``) and the denoise -> swap flip (a mode change and
    new shadows) must each capture a new graph, which again matches eager.
    ``names`` picks some of the cases (all when None). Returns the launch
    counts of the two replays by path."""
    import io

    from denoising_diffusion_deep_fake_tpu_torch.training.optim import (
        bind_device_lr)

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    rng = np.random.default_rng(SEED + 41)
    counts = {}
    try:
        for what, (make, init, n_args, per_step) in _small_trainers(
                dev).items():
            if names is not None and what not in names:
                continue
            eager_t, graph_t = make(), make()
            eager_s, graph_s = init(eager_t), init(graph_t)
            steps = [[torch.from_numpy(rng.integers(
                0, 256, (2, 64, 64, 3), np.uint8)).to(dev)
                for _ in range(n_args)] for _ in range(9)]
            eager = _run_eager(eager_t, eager_s, steps[:6])
            step = graph_t.make_super_step(3)
            torch.cuda.synchronize()
            launches.clear()
            groups = [step(graph_s, *_k_flat(steps[i:i + 3]))
                      for i in (0, 3)]
            torch.cuda.synchronize()
            counts[f"graph_{what}_64"] = dict(launches)
            check_launches(counts[f"graph_{what}_64"],
                           {k: 6 * v for k, v in per_step.items()},
                           f"12b {what}")
            check(step.captures == 1, f"{what}: {step.captures} captures")
            _check_same(what, graph_t, graph_s, eager_t, eager_s, groups,
                        eager)
            if what == "denoiser":
                # A restore replaces Adam's state and learning rates.
                for t, st in ((eager_t, eager_s), (graph_t, graph_s)):
                    buf = io.BytesIO()
                    torch.save(st.optimizer.state_dict(), buf)
                    buf.seek(0)
                    st.optimizer.load_state_dict(torch.load(
                        buf, weights_only=True, map_location="cpu"))
                    bind_device_lr(st.optimizer)
                change = "a restored optimizer"
            elif what == "deep_fake_denoise":
                for t, st in ((eager_t, eager_s), (graph_t, graph_s)):
                    t.cfg.mode = "swap"
                    t.ensure_ema(st)
                change = "the flip to swap mode (new shadows)"
            else:
                log(f"  {what}: 2 replays of K = 3 bit-equal to 6 eager "
                    "steps (weights, BN buffers, Adam moments and steps, "
                    "shadows, losses, counters, generator); launches "
                    f"{counts[f'graph_{what}_64']}")
                continue
            eager += _run_eager(eager_t, eager_s, steps[6:])
            groups.append(step(graph_s, *_k_flat(steps[6:])))
            check(step.captures == 2,
                  f"{what}: {change} did not capture a new graph")
            _check_same(what, graph_t, graph_s, eager_t, eager_s, groups,
                        eager)
            log(f"  {what}: 2 replays of K = 3 bit-equal to 6 eager steps "
                "(weights, BN buffers, Adam moments and steps, shadows, "
                "losses, counters, generator); launches "
                f"{counts[f'graph_{what}_64']}; after {change} a new graph "
                "was captured and a third group matched 3 more eager steps")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return counts


def graph_rate(dev, launches, card: str, what: str, trainer, states,
               n_args: int, k: int, eager: dict, per_step: dict,
               groups: int = 2, phase: str = "12c") -> dict:
    """Phase 12c (16c, 16e), one path at full width: one K-step graph
    captured (the first call: warm-up step, capture, first replay),
    ``groups`` timed replays, then one group under the profiler; rates
    beside the eager phase's. Returns the launch counts of the timed
    groups, the ms and imgs/s a step, the kernels' ms a step and the peak
    memory."""
    from denoising_diffusion_deep_fake_tpu_torch.utils.profiling import (
        analyze_trace_dir, trace)

    size, batch = trainer.image_size, trainer.cfg.batch_size
    rng = np.random.default_rng(SEED + 42)
    flat = _k_flat([[torch.from_numpy(rng.integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev)
        for _ in range(n_args)] for _ in range(k)])
    step = trainer.make_super_step(k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(states, *flat)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches.clear()
    losses = []
    events = [torch.cuda.Event(enable_timing=True) for _ in range(groups + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for g in range(groups):
        losses.append(step(states, *flat))
        events[g + 1].record()
    torch.cuda.synchronize()
    group_ms = (time.perf_counter() - t0) / groups * 1e3
    counts = dict(launches)
    device_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(step.captures == 1, f"{what}: {step.captures} captures")
    check_launches(counts, {key: groups * k * v
                            for key, v in per_step.items()}, f"{phase} {what}")
    values = [float(v) for m in losses for key, vs in m.items()
              if key != "lr" for v in vs]
    check(all(math.isfinite(v) for v in values), f"{what}: non-finite loss")
    # The idle share within one profiled group: its kernels' time against
    # the device timeline from the group's first launch to its last end.
    ends = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device=dev):
            ends[0].record()
            step(states, *flat)
            ends[1].record()
        busy_ms = device_report(analyze_trace_dir(tmp)).get(
            "ops_busy_ms_per_step", 0.0)
    span_ms = ends[0].elapsed_time(ends[1])
    images = batch * n_args
    step_ms = group_ms / k
    idle = (f"device idle {1 - busy_ms / span_ms:.1%}" if busy_ms > 0
            else "the profiler recorded no device time: idle not measured")
    busy_ms /= k
    log(f"  {what}, K = {k}: {step_ms:.3f} ms a step (host clock, mean of "
        f"{groups} groups), {images / step_ms * 1e3:.1f} imgs/s, beside the "
        f"eager phase's {eager['step_ms']:.3f} ms, "
        f"{images / eager['step_ms'] * 1e3:.1f} imgs/s; a group on the "
        f"device timeline {', '.join(f'{t:.3f}' for t in device_ms)} ms; "
        f"first call (warm-up step, capture, first replay) {first_s:.3f} s; "
        f"profile of one group ({span_ms:.3f} ms on the device timeline "
        f"under the profiler): kernels {busy_ms:.3f} ms a step, {idle}; "
        f"peak memory "
        f"{peak_gb:.2f} GB (eager phase {eager['peak_gb']:.2f} GB); "
        f"launches {counts} [{card}]")
    return dict(counts=counts, step_ms=step_ms,
                imgs_s=images / step_ms * 1e3, busy_ms=busy_ms,
                peak_gb=peak_gb)


def graph_full_width(dev, launches, card: str, runs: dict) -> dict:
    """Phase 12c: the paths of phases 5-8 at full width with their
    configs' K (``configs/denoiser.yml``'s 16, ``configs/swap.yml``'s 8),
    each going on from its eager phase's trainer and states (8b's states
    carry 8c's shadows, which denoise mode leaves alone; 8d's are past the
    EMA warm-up). Returns the launch counts by path."""
    fused = {"affine_warp_fused": 1, "fused_noise_blend": 1}
    paths = (
        ("graph_denoiser_448", "denoiser 448^2 x16", "denoiser", 1, 16,
         fused),
        ("graph_twopass_640", "two-pass route 640^2 x4", "twopass", 1, 16,
         {"warp_axis_pass": 2, "fused_noise_blend": 1}),
        ("graph_balancer_448", "balancer 448^2 x12", "balancer", 1, 16,
         {"fused_normalise_noise_blend": 1}),
        ("graph_deep_fake_denoise_448", "deep-fake denoise 448^2, 16 per "
         "identity", "denoise", 2, 8, {k: 2 * v for k, v in fused.items()}),
        ("graph_deep_fake_swap_448", "deep-fake swap 448^2, 16 per identity",
         "swap", 2, 8, {k: 2 * v for k, v in fused.items()}))
    counts, rates = {}, {}
    for path, what, run, n_args, k, per_step in paths:
        t0 = time.perf_counter()
        out = graph_rate(dev, launches, card, what, runs[run]["trainer"],
                         runs[run]["state"], n_args, k, runs[run], per_step)
        counts[path], rates[path] = out["counts"], out["imgs_s"]
        log(f"    ({time.perf_counter() - t0:.1f} s)")
    return counts, rates


def graph_from_disk(root: Path, data: dict, dev, launches,
                    card: str) -> dict:
    """Phase 12d and 12e: the runners with ``steps_per_call``. (d)
    fit_denoiser at 448^2 x16 from 10a's frames with K = 2: 3 steps an
    epoch, so a group and a tail single, for 2 epochs; one event row a
    step. (e) At 64^2 (as 10c), a grouped fit_deep_fake resumed from its
    checkpoint against the uninterrupted grouped run, bit for bit: the
    resumed run captures its graph on the restored optimizer state.
    Returns the launch counts by path."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake, fit_denoiser)

    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(data["a"]), batch_size=16,
        learning_rate=0.02, max_epochs=2, cosine_scheduler_max_epoch=100,
        encoder_name="resnet34", noise_exponential_sampling_lambda=5,
        compute_dtype="bfloat16", image_size=448, seed=SEED,
        steps_per_call=2, log_images=False,
        log_dir=str(root / "graph_runs"),
        checkpoint_dir=str(root / "graph_denoiser")))
    calls = []
    t0 = time.perf_counter()
    (state, _, ctx), counts = fit_counted(
        fit_denoiser, launches, cfg,
        step_callback=lambda step, _, m: calls.append(
            (step, tuple(torch.atleast_1d(m["loss"]).shape))))
    run_s = time.perf_counter() - t0
    check(calls == [(2, (2,)), (3, (1,)), (5, (2,)), (6, (1,))]
          and state.step == 6, f"fit_denoiser K = 2 dispatched {calls}")
    check_launches(counts, {"affine_warp_fused": 6, "fused_noise_blend": 6},
                   "12d fit_denoiser")
    rows = read_event_file(root / "graph_runs" / "denoiser")
    for tag in ("loss", "lr"):
        steps = [s for s, t, v in rows if t == tag]
        check(steps == list(range(6)), f"12d: the {tag} rows are at {steps}")
    losses = [v for s, t, v in rows if t == "loss"]
    check(all(math.isfinite(v) for v in losses), f"12d: losses {losses}")
    log(f"  12d fit_denoiser 448^2 x16, steps_per_call 2, 2 epochs of 3 "
        f"steps in {run_s:.2f} s: callbacks at {[c[0] for c in calls]} (a "
        f"group, then the tail single), one event row a step, losses "
        f"{[round(v, 5) for v in losses]} [{card}]")

    small = {n: write_frames(root / f"graph_small_{n}", 8, 64,
                             SEED + 30 + i) for i, n in enumerate("ab")}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        args = dict(batch_size=2, encoder_name="resnet18",
                    compute_dtype="float32", image_size=64, max_epochs=2,
                    steps_per_call=2, log_images=False)
        whole_cfg = deep_fake_cfg(small, root, "graph_whole", **args)
        (whole, whole_t, _), small_counts = fit_counted(
            fit_deep_fake, launches, whole_cfg)
        cfg = deep_fake_cfg(small, root, "graph_resumed", **args)
        fit_counted(fit_deep_fake, launches, cfg, max_steps=4)
        (resumed, resumed_t, ctx), _ = fit_counted(
            fit_deep_fake, launches, cfg, resume_from=cfg.checkpoint_dir)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    check_launches(small_counts, {"fused_noise_blend": 16},
                   "12e the 64^2 grouped run")
    bad = states_differ(resumed, whole)
    check(ctx.global_step == 8 and not bad,
          f"12e: 1 epoch + resume differs from 2 epochs: {bad[:5]}")
    check(torch.equal(resumed_t.generator.get_state(),
                      whole_t.generator.get_state()),
          "12e: the resumed generator differs")
    log("  12e 64^2 resnet18 fp32, steps_per_call 2, cudnn.deterministic: "
        "2 epochs of 4 steps (2 groups each) against 1 epoch + resume: "
        "every weight, BN buffer, Adam moment and step, counter and the "
        "generator bit-equal")
    return {"graph_fit_denoiser_448": counts,
            "graph_fit_deep_fake_64": small_counts}


# ----------------------------------------- phase 13: data on the device


class CacheProbe:
    """Phase 13's instruments, installed for the phase and taken out after
    it: the host loader's batch loads and ``device_prefetch`` calls
    counted, the K-step graphs captured counted, the caches the runners
    make kept, the balancer's scoring passes and the garbage collector's
    passes timed, and each epoch's boundary marked on the host clock (from
    the end of ``_drive_epoch`` to the next epoch's first step arguments
    in hand)."""

    def __init__(self):
        self.stack = contextlib.ExitStack()
        self.reset()

    def reset(self) -> None:
        self.loads = self.prefetches = self.captures = 0
        self.caches, self.scores, self.marks, self.gc_ms = [], [], [], []

    def patch(self, obj, name: str, value) -> None:
        old = getattr(obj, name)
        setattr(obj, name, value)
        self.stack.callback(setattr, obj, name, old)

    def __enter__(self) -> "CacheProbe":
        from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
            ImageLoader)
        from denoising_diffusion_deep_fake_tpu_torch.training import (
            multi_step, runners)
        from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
            BalanceTrainer)

        probe = self
        load, prefetch = ImageLoader._load_batch, runners.device_prefetch
        drive = runners._drive_epoch

        def counted_load(loader, indices):
            probe.loads += 1
            return load(loader, indices)

        def counted_prefetch(*args, **kwargs):
            probe.prefetches += 1
            return prefetch(*args, **kwargs)

        class Graph(multi_step._Graph):
            def __init__(self, *args, **kwargs):
                probe.captures += 1
                super().__init__(*args, **kwargs)

        class Cache(runners.DeviceDatasetCache):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.rss_gb = rss_gb()
                probe.caches.append(self)

        def mark(kind: str) -> None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            probe.marks.append((kind, time.perf_counter(), event))

        def marked(batches):
            for i, item in enumerate(batches):
                if i == 0:
                    mark("first")
                yield item

        def marked_drive(ctx, states, generator, batches, steps, **kwargs):
            done = drive(ctx, states, generator, marked(batches), steps,
                         **kwargs)
            mark("end")
            return done

        def timed(name):
            score = getattr(BalanceTrainer, name)

            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = score(*args, **kwargs)
                torch.cuda.synchronize()
                probe.scores.append((name, (time.perf_counter() - t0) * 1e3))
                return out

            return run

        def on_gc(phase, info):
            if phase == "start":
                probe.gc_start = time.perf_counter()
            else:
                probe.gc_ms.append((time.perf_counter() - probe.gc_start)
                                   * 1e3)

        gc.callbacks.append(on_gc)
        self.stack.callback(gc.callbacks.remove, on_gc)
        self.patch(ImageLoader, "_load_batch", counted_load)
        self.patch(runners, "device_prefetch", counted_prefetch)
        self.patch(runners, "_drive_epoch", marked_drive)
        self.patch(runners, "DeviceDatasetCache", Cache)
        self.patch(multi_step, "_Graph", Graph)
        for name in ("score_dataset", "score_dataset_from_cache"):
            self.patch(BalanceTrainer, name, timed(name))
        return self

    def __exit__(self, *exc) -> None:
        self.stack.close()

    def boundaries_ms(self) -> tuple[list, list]:
        """Each epoch boundary, from the end of an epoch's last call to the
        next epoch's first step arguments in hand (for the cache the
        order's copy, for the host loader its threads' start and the first
        batch's load and upload; for the balancer the scoring pass too):
        on the host clock, and on the device timeline (events recorded at
        both ends: the time the card idled, since a group's launch
        returns before the card has run it). Read after a synchronise."""
        ends = [m[1:] for m in self.marks if m[0] == "end"]
        firsts = [m[1:] for m in self.marks if m[0] == "first"][1:]
        return ([(b - a) * 1e3 for (a, _), (b, _) in zip(ends, firsts)],
                [a.elapsed_time(b) for (_, a), (_, b) in zip(ends, firsts)])

    def score_ms(self) -> list:
        """Each scoring pass's ms, the cache's form where it ran."""
        cached = [ms for name, ms in self.scores
                  if name == "score_dataset_from_cache"]
        return cached or [ms for _, ms in self.scores]


def rss_gb() -> float:
    """This process's resident host memory now, GB."""
    status = Path("/proc/self/status").read_text()
    return int(status.split("VmRSS:")[1].split()[0]) * 1024 / 1e9


def event_rows(cfg, workload: str) -> list:
    return sorted(read_event_file(Path(cfg.log_dir) / workload),
                  key=lambda row: (row[0], row[1]))


def cached_pair(probe, launches, what: str, fit, make_cfg, workload: str,
                k: int, want: dict, **kwargs) -> dict:
    """One runner from the host loader and from the cache: every tensor
    and counter, the generator and every event row bit-equal; the launches
    ``want``; with K > 1, one graph captured across the run's epochs; no
    host batch load and no upload thread in the cached run. Returns the
    cached run's ``(result, cfg)`` and its launch counts."""
    runs = {}
    for cache in ("host", "device"):
        cfg = make_cfg(cache)
        probe.reset()
        out, counts = fit_counted(fit, launches, cfg, **kwargs)
        check_launches(counts, want, f"13a {what} ({cache})")
        check(probe.captures == (1 if k > 1 else 0),
              f"13a {what} ({cache}): {probe.captures} graphs captured")
        if cache == "device":
            n_caches = len(out[0]) if isinstance(out[0], dict) else 1
            check(probe.loads == probe.prefetches == 0
                  and len(probe.caches) == n_caches,
                  f"13a {what}: {probe.loads} host batch loads, "
                  f"{probe.prefetches} device_prefetch calls, "
                  f"{len(probe.caches)} caches in the cached run")
        runs[cache] = out, cfg, counts
    (dev_out, dev_cfg, dev_counts), (host_out, host_cfg, _) = (
        runs["device"], runs["host"])
    bad = states_differ(dev_out[0], host_out[0])
    check(not bad, f"13a {what}: the cached run differs: {bad[:5]}")
    if host_out[1].generator is not None:
        check(torch.equal(dev_out[1].generator.get_state(),
                          host_out[1].generator.get_state()),
              f"13a {what}: the cached run's generator differs")
    rows = event_rows(dev_cfg, workload)
    check(rows == event_rows(host_cfg, workload) and rows,
          f"13a {what}: the event rows differ from the host run's")
    log(f"  13a {what}, K = {k}: cached run bit-equal to the host run "
        f"(weights, BN buffers, Adam moments and steps, counters, "
        f"generator, {len(rows)} event rows); "
        f"{probe.captures} graph captured; launches {dev_counts}")
    return {"out": dev_out, "cfg": dev_cfg, "counts": dev_counts,
            "host_cfg": host_cfg}


def cached_against_host(root: Path, dev, launches, probe) -> dict:
    """Phase 13a: at 64^2 x2, resnet18, fp32, under cudnn.deterministic,
    each runner from the cache against the host loader: fit_denoiser at K
    = 1 and K = 3 (8 frames, 4 steps an epoch: a group and the tail single),
    fit_deep_fake in swap mode at K = 2 and a resume of the cached run,
    fit_balance (9 frames; 4 steps an epoch, 5 scoring batches, the tail
    padded) with the manifests equal. Returns the launch counts by
    path."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_balance, fit_deep_fake, fit_denoiser)

    frames = {n: write_frames(root / f"cache_small_{n}", 8, 64,
                              SEED + 50 + i) for i, n in enumerate("ab")}
    nine = write_frames(root / "cache_small_nine", 9, 64, SEED + 52)
    small = dict(batch_size=2, encoder_name="resnet18",
                 compute_dtype="float32", image_size=64, max_epochs=2,
                 log_images=False)
    hybrid = {"fused_noise_blend": 1}  # 64^2: the hybrid warp, no kernel
    swap_small = dict(SWAP_YML, **small, steps_per_call=2,
                      ema_update_after_step=1)
    counts = {}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for k in (1, 3):
            run = cached_pair(
                probe, launches, "fit_denoiser", fit_denoiser,
                lambda cache: config_from_dict(DenoiserConfig, dict(
                    small, input_image_list_path=str(frames["a"]),
                    steps_per_call=k, data_cache=cache, seed=SEED,
                    log_dir=str(root / f"c_den_{k}_{cache}" / "runs"),
                    checkpoint_dir=str(root / f"c_den_{k}_{cache}" / "ck"))),
                "denoiser", k, {n: 8 * v for n, v in hybrid.items()})
            counts[f"cache_fit_denoiser_64_k{k}"] = run["counts"]
        swap = cached_pair(
            probe, launches, "fit_deep_fake swap", fit_deep_fake,
            lambda cache: deep_fake_cfg(
                frames, root, f"c_swap_{cache}", **swap_small,
                data_cache=cache),
            "deep_fake", 2, {n: 16 * v for n, v in hybrid.items()})
        counts["cache_graph_fit_deep_fake_swap_64"] = swap["counts"]
        cfg = deep_fake_cfg(frames, root, "c_swap_resumed", **swap_small,
                            data_cache="device")
        fit_counted(fit_deep_fake, launches, cfg, max_steps=4)
        (resumed, trainer, ctx), _ = fit_counted(
            fit_deep_fake, launches, cfg, resume_from=cfg.checkpoint_dir)
        bad = states_differ(resumed, swap["out"][0])
        check(ctx.global_step == 8 and not bad
              and torch.equal(trainer.generator.get_state(),
                              swap["out"][1].generator.get_state()),
              f"13a: the cached resume differs from the whole run: "
              f"{bad[:5]}")
        log("  13a cached fit_deep_fake swap, K = 2: 1 epoch + resume "
            "bit-equal to 2 epochs, generator included")
        balance = cached_pair(
            probe, launches, "fit_balance", fit_balance,
            lambda cache: config_from_dict(BalanceConfig, dict(
                small, data_path=str(nine), data_cache=cache,
                number_of_classes=4, seed=SEED,
                output_image_list_path=str(root / f"c_bal_{cache}.txt"),
                log_dir=str(root / f"c_bal_{cache}" / "runs"),
                checkpoint_dir=str(root / f"c_bal_{cache}" / "ck"))),
            "balance", 1, {"fused_normalise_noise_blend": 8 + 10})
        check(Path(balance["cfg"].output_image_list_path).read_text()
              == Path(balance["host_cfg"].output_image_list_path)
              .read_text(), "13a: the balanced manifests differ")
        log("  13a fit_balance: scoring from the cache gave the host "
            "scoring's manifest (9 images, 5 batches a pass, the tail "
            "padded)")
        counts["cache_fit_balance_64"] = balance["counts"]
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return counts


def timed_fit(probe, launches, fit, cfg, *, spe: int, images: int,
              decode_fn=np.load, marks=None, **kwargs) -> dict:
    """A runner's call with the phase's instruments: the card synchronised
    after the calls that end on ``marks`` (the ends of epochs 1 and 3 by
    default; the host runs ahead of the card everywhere else), the rate
    over epochs 2-3 on the host clock, the boundaries, the scoring passes,
    the launch counts and the host loads. ``images`` a step."""
    ends = {}
    marks = marks or (spe, 3 * spe)

    def at_epoch_end(step, states, metrics):
        if step in marks:
            torch.cuda.synchronize()
            ends[step] = time.perf_counter()

    probe.reset()
    torch.cuda.synchronize()
    launches.clear()
    out = fit(cfg, verbose=False, decode_fn=decode_fn,
              step_callback=at_epoch_end, **kwargs)
    torch.cuda.synchronize()
    rate = (2 * spe * images / (ends[3 * spe] - ends[spe])
            if 3 * spe in ends else None)
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    host_ms, idle_ms = probe.boundaries_ms()
    return {"out": out, "counts": dict(launches), "imgs_s": rate,
            "boundary_ms": host_ms, "idle_ms": idle_ms,
            "score_ms": probe.score_ms(),
            "loads": probe.loads, "prefetches": probe.prefetches,
            "captures": probe.captures, "caches": list(probe.caches),
            "ends": ends, "gc_ms": list(probe.gc_ms)}


def fmt(values) -> str:
    return ", ".join(f"{v:.3f}" for v in values)


def cached_full_width(root: Path, dev, launches, probe, card: str) -> dict:
    """Phase 13b and 13c: at full width from 256 .npy frames of 448^2, 3
    epochs each, host loader against cache: fit_denoiser x16 (16 steps an
    epoch) eager and at K = 16; fit_deep_fake in denoise mode, 16 per
    identity, from the first and last 128 frames (8 steps an epoch), K =
    8; fit_balance x12 (21 steps an epoch, 22 scoring batches). Each
    run's imgs/s over epochs 2-3 on the host clock, its epoch boundaries,
    the scoring passes; the cached runs load no host batch and start no
    upload thread (13c). Returns the launch counts by path."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        read_image_manifest, write_image_manifest)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_balance, fit_deep_fake, fit_denoiser)

    t0 = time.perf_counter()
    data = write_frames(root / "cache_256", 256, 448, SEED + 60)
    paths = read_image_manifest(data)
    halves = {}
    for name, part in (("a", paths[:128]), ("b", paths[128:])):
        halves[name] = root / f"cache_128_{name}.txt"
        write_image_manifest(halves[name], part)
    log(f"  256 uint8 448^2 frames as .npy in {time.perf_counter() - t0:.2f}"
        f" s; identities a and b their halves")
    fused = {"affine_warp_fused": 1, "fused_noise_blend": 1}
    counts, figures = {}, {}

    def report(what, run, per_step, steps, k):
        check_launches(run["counts"], {n: steps * v
                                       for n, v in per_step.items()},
                       f"13b {what}")
        check(run["captures"] == (1 if k > 1 else 0),
              f"13b {what}: {run['captures']} graphs captured")
        cached = bool(run["caches"])
        if cached:
            check(run["loads"] == run["prefetches"] == 0,
                  f"13c {what}: {run['loads']} host batch loads and "
                  f"{run['prefetches']} device_prefetch calls in a cached "
                  "run")
        else:
            check(run["loads"] > 0 and run["prefetches"] > 0,
                  f"13c {what}: the host run loaded nothing")
        log(f"  {what}: {run['imgs_s']:.1f} imgs/s over epochs 2-3 (host "
            f"clock between the synchronised ends of epochs 1 and 3); epoch "
            f"boundaries {fmt(run['boundary_ms'])} ms on the host clock, "
            f"the card idle {fmt(run['idle_ms'])} ms of them; host batch "
            f"loads {run['loads']}, device_prefetch calls "
            f"{run['prefetches']}; "
            f"{len(run['gc_ms'])} garbage collections, the longest "
            f"{max(run['gc_ms'], default=0):.3f} ms; launches "
            f"{run['counts']} [{card}]")

    for cache in ("host", "device"):
        for k in (1, 16):
            cfg = config_from_dict(DenoiserConfig, dict(
                input_image_list_path=str(data), batch_size=16,
                learning_rate=0.02, max_epochs=3,
                cosine_scheduler_max_epoch=100, encoder_name="resnet34",
                noise_exponential_sampling_lambda=5,
                compute_dtype="bfloat16", image_size=448, seed=SEED,
                steps_per_call=k, data_cache=cache, log_images=False,
                log_dir=str(root / f"c13b_{cache}_{k}" / "runs"),
                checkpoint_dir=str(root / f"c13b_{cache}_{k}" / "ck")))
            run = timed_fit(probe, launches, fit_denoiser, cfg, spe=16,
                            images=16)
            report(f"fit_denoiser 448^2 x16, {cache}, K = {k}", run, fused,
                   48, k)
            figures[f"denoiser_{cache}_{k}"] = run
            if cache == "device":
                counts[f"cache_{'graph_' if k > 1 else ''}fit_denoiser_448"
                       ] = run["counts"]
    for cache in ("host", "device"):
        cfg = deep_fake_cfg(halves, root, f"c13b_pair_{cache}",
                            max_epochs=3, steps_per_call=8,
                            data_cache=cache, log_images=False)
        run = timed_fit(probe, launches, fit_deep_fake, cfg, spe=8,
                        images=32)
        report(f"fit_deep_fake denoise 448^2, 16 per identity, {cache}, "
               f"K = 8", run, {n: 2 * v for n, v in fused.items()}, 24, 8)
        figures[f"pair_{cache}"] = run
        if cache == "device":
            counts["cache_graph_fit_deep_fake_448"] = run["counts"]
    for cache in ("host", "device"):
        cfg = config_from_dict(BalanceConfig, dict(
            data_path=str(data), batch_size=12, learning_rate=0.01,
            max_epochs=3, encoder_name="resnet34", ratio_of_noise=0.7,
            number_of_classes=10, compute_dtype="bfloat16", image_size=448,
            seed=SEED, data_cache=cache, log_images=False,
            output_image_list_path=str(root / f"c13b_bal_{cache}.txt"),
            log_dir=str(root / f"c13b_bal_{cache}" / "runs"),
            checkpoint_dir=str(root / f"c13b_bal_{cache}" / "ck")))
        run = timed_fit(probe, launches, fit_balance, cfg, spe=21,
                        images=12)
        report(f"fit_balance 448^2 x12, {cache}, K = 1 (boundaries hold "
               f"the scoring pass)", run,
               {"fused_normalise_noise_blend": 1}, 63 + 66, 1)
        log(f"    scoring 256 images (22 batches, the last 4 padded to "
            f"12): {fmt(run['score_ms'])} ms a pass [{card}]")
        figures[f"balance_{cache}"] = run
        if cache == "device":
            counts["cache_fit_balance_448"] = run["counts"]
    return counts, figures


def h2d_copies(trace: Path) -> tuple:
    """The host-to-device copies in a chrome trace of ``torch.profiler``,
    from its ``utils/profiling.py`` report: their count, their bytes where
    the trace gives them, the count of kernels the trace holds (none: the
    profiler saw no device activity) and the count of its events by
    category."""
    from denoising_diffusion_deep_fake_tpu_torch.utils.profiling import (
        analyze_trace)

    report = analyze_trace(trace, nsteps=1)
    cats = report["events_by_category"]
    copies = device_report(report).get("memcpy", {}).get(
        "HtoD", {"count": 0, "bytes": 0})
    return copies["count"], copies["bytes"], cats.get("kernel", 0), cats


class CopiesSent(TorchDispatchMode):
    """Counts the host-to-device copies this thread sends (``copy_`` and
    ``to`` from a CPU tensor into a CUDA one) and their bytes, whatever
    the profiler records."""

    def __init__(self):
        super().__init__()
        self.count = self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        if func in (aten.copy_.default, aten._to_copy.default):
            src, dst = ((args[1], args[0]) if func is aten.copy_.default
                        else (args[0], out))
            if src.device.type == "cpu" and dst.device.type == "cuda":
                self.count += 1
                self.bytes += src.nbytes
        return out


def profiled_cached_epoch(root: Path, data: Path, dev, launches, probe,
                          card: str, k: int) -> None:
    """Phase 13c: a cached fit_denoiser at 448^2 x16 (16 steps an epoch,
    2 epochs) at ``k`` under ``torch.profiler`` from the synchronised end
    of epoch 1 to that of epoch 2: the boundary (the order's copy) and
    epoch 2's 16 steps. Its host-to-device copies by count and bytes."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)
    from denoising_diffusion_deep_fake_tpu_torch.utils.profiling import (
        TRACE_SUFFIX, trace)

    traces = root / f"c13c_{k}_trace"
    tracing = trace(traces, device=dev)
    sent = CopiesSent()

    def window(step, states, metrics):
        torch.cuda.synchronize()
        if step == 16:
            tracing.__enter__()
            sent.__enter__()
        elif step == 32:
            sent.__exit__(None, None, None)
            tracing.__exit__(None, None, None)

    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(data), batch_size=16, learning_rate=0.02,
        max_epochs=2, encoder_name="resnet34", compute_dtype="bfloat16",
        image_size=448, seed=SEED, steps_per_call=k, data_cache="device",
        log_images=False, log_dir=str(root / f"c13c_{k}" / "runs"),
        checkpoint_dir=str(root / f"c13c_{k}" / "ck")))
    probe.reset()
    fit_counted(fit_denoiser, launches, cfg, step_callback=window)
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    n, n_bytes, n_kernels, cats = h2d_copies(
        next(traces.glob(f"*{TRACE_SUFFIX}")))
    shutil.rmtree(traces)
    check(probe.loads == probe.prefetches == 0,
          f"13c: {probe.loads} host batch loads in the profiled run")
    check(sent.bytes < 1 << 20 and (n_bytes is None or n_bytes < 1 << 20),
          f"13c: a cached epoch copied {sent.bytes} bytes to the card "
          f"({n_bytes} in the trace)")
    size = "bytes not in the trace" if n_bytes is None else f"{n_bytes} B"
    traced = (f"the trace: {n} host-to-device copies, {size}, beside "
              f"{n_kernels} kernels" if n_kernels else
              "the profiler recorded no device activity in the window "
              f"(its events by category: {cats})")
    log(f"  13c one profiled cached epoch (its boundary and 16 steps of "
        f"448^2 x16, K = {k}): sent {sent.count} host-to-device copies "
        f"of {sent.bytes} B in all; {traced} (a host batch is "
        f"{16 * 448 * 448 * 3} B) [{card}]")


def dataset_at_jax_sizing(root: Path, dev, launches, probe,
                          card: str, n: int = 10_000,
                          size: int = 448) -> dict:
    """Phase 13d: 10,000 frames of 448^2 (6.02 GB), each made from its
    manifest index by a numpy ``decode_fn`` (no disk, no cv2): the cache's
    decode and upload times, its bytes, the device's and the host's peak
    memory, then fit_denoiser x16 at K = 16 for 32 steps from it. Returns
    the launch counts."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    base = np.random.default_rng(SEED + 70).integers(
        0, 256, (size, size, 3), np.uint8)

    def decode(path: str) -> np.ndarray:
        return base + np.uint8(int(Path(path).stem) % 256)

    manifest = root / "cache_10k.txt"
    write_image_manifest(manifest, [f"virtual/{i:05d}.npy" for i in range(n)])
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(manifest), batch_size=16,
        learning_rate=0.02, max_epochs=1, encoder_name="resnet34",
        compute_dtype="bfloat16", image_size=size, seed=SEED,
        steps_per_call=16, data_cache="device", log_images=False,
        log_dir=str(root / "c13d" / "runs"),
        checkpoint_dir=str(root / "c13d" / "ck")))
    rss_before = rss_gb()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = timed_fit(probe, launches, fit_denoiser, cfg, spe=16, images=16,
                    decode_fn=decode, marks=(16, 32), max_steps=32)
    (cache,) = run["caches"]
    group_ms = (run["ends"][32] - run["ends"][16]) * 1e3
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    check(cache.n_images == n and cache.dataset.shape == (n, size, size, 3)
          and run["out"][0].step == 32,
          f"13d: {cache.n_images} images, {run['out'][0].step} steps")
    check(run["loads"] == 0 and run["captures"] == 1,
          f"13d: {run['loads']} host loads, {run['captures']} captures")
    check_launches(run["counts"], {"affine_warp_fused": 32,
                                   "fused_noise_blend": 32}, "13d")
    row = torch.from_numpy(decode(f"virtual/{n - 1:05d}.npy")).to(dev)
    check(torch.equal(cache.dataset[n - 1], row),
          "13d: the last frame on the card is not its decode")
    log(f"  13d {n} frames of {size}^2 from a numpy decode_fn: "
        f"{cache.nbytes / 1e9:.2f} GB, decoded in {cache.decode_s:.2f} s, "
        f"uploaded in {cache.upload_s:.2f} s "
        f"({cache.nbytes / cache.upload_s / 1e9:.2f} GB/s); the second "
        f"group of K = 16 {group_ms / 16:.3f} ms a step "
        f"({16 * 16 / group_ms * 1e3:.1f} imgs/s); the whole call "
        f"{time.perf_counter() - t0:.2f} s; device peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; host resident "
        f"memory {rss_before:.2f} GB before the call, {cache.rss_gb:.2f} GB "
        f"once the cache was made, {rss_gb():.2f} GB after, the process's "
        f"peak {peak_gb:.2f} GB [{card}]")
    return run["counts"]


def data_on_the_device(root: Path, dev, launches, card: str) -> dict:
    """Phase 13: 13a the cached runners against the host loader's, bit for
    bit at 64^2; 13b their rates at full width; 13c a cached epoch's
    host-to-device copies; 13d the dataset at JAX's sizing. Returns the
    launch counts by path."""
    with CacheProbe() as probe:
        t0 = time.perf_counter()
        log("[13a] the cache against the host loader: 64^2 fp32, "
            "cudnn.deterministic")
        counts = cached_against_host(root, dev, launches, probe)
        log(f"    ({time.perf_counter() - t0:.1f} s)")
        log("[13b] full width from 256 frames of 448^2: host against cache")
        full, figures = cached_full_width(root, dev, launches, probe, card)
        counts.update(full)
        log(f"    ({time.perf_counter() - t0:.1f} s)")
        log("[13c] a profiled cached epoch's host-to-device copies")
        profiled_cached_epoch(root, root / "cache_256" / "images.txt", dev,
                              launches, probe, card, 16)
        log(f"    ({time.perf_counter() - t0:.1f} s)")
        log("[13d] 10,000 frames of 448^2 on the card")
        counts["cache_graph_fit_denoiser_10k"] = dataset_at_jax_sizing(
            root, dev, launches, probe, card)
        log(f"  phase 13 took {time.perf_counter() - t0:.1f} s [{card}]")
    return counts, {k: v["imgs_s"] for k, v in figures.items()}


# ------------------------- phase 14: the resnet family, checkpoints in and out

FAMILY_STEPPED = ("resnet50", "resnext50_32x4d", "wide_resnet50_2")
FAMILY_FORWARD = ("resnet101", "resnet152", "resnext101_32x8d",
                  "wide_resnet101_2")
# Each name's U-Net parameter count, as tests/test_torch_port_resnet_family.py
# pins it against the JAX package's models.
PARAM_COUNTS = {
    "resnet34": 24_436_659,
    "resnet50": 32_521_395,
    "resnet101": 51_513_523,
    "resnet152": 67_157_171,
    "resnext50_32x4d": 31_993_267,
    "resnext101_32x8d": 95_755_699,
    "wide_resnet50_2": 75_847_603,
    "wide_resnet101_2": 133_851_059,
    # The other families (tests/test_torch_port_encoder_families.py holds
    # them to tests/test_models.py's pins or JAX's jax.eval_shape).
    "vgg11": 18_254_323, "vgg11_bn": 18_259_827, "vgg13": 18_438_835,
    "vgg13_bn": 18_444_723, "vgg16": 23_748_531, "vgg16_bn": 23_756_979,
    "vgg19": 29_058_227, "vgg19_bn": 29_069_235,
    "densenet121": 13_607_923, "densenet161": 38_738_611,
    "densenet169": 21_202_931, "densenet201": 28_580_851,
    "se_resnet50": 35_052_387, "se_resnet101": 56_291_235,
    "se_resnet152": 73_786_211, "se_resnext50_32x4d": 34_524_259,
    "se_resnext101_32x4d": 55_919_779, "senet154": 122_071_779,
    "mobilenet_v2": 6_629_235, "xception": 28_769_691,
    "inceptionv4": 48_792_211, "inceptionresnetv2": 62_029_587,
    "dpn68": 16_951_773, "dpn68b": 16_951_773, "dpn92": 46_951_091,
    "dpn98": 71_341_875, "dpn107": 98_785_587, "dpn131": 89_707_635,
    # EfficientNet (tests/test_torch_port_efficientnet.py: the pins of
    # tests/test_models.py for b0, b4, b7, jax.eval_shape for the rest).
    "efficientnet-b0": 5_839_599, "efficientnet-b1": 8_345_235,
    "efficientnet-b2": 9_548_149, "efficientnet-b3": 12_566_427,
    "efficientnet-b4": 19_419_579, "efficientnet-b5": 30_163_619,
    "efficientnet-b6": 42_493_771, "efficientnet-b7": 65_452_099,
}
# The reference's Lightning counters in the hand-built checkpoint.
REF_EPOCH, REF_GLOBAL_STEP = 41, 1234


def held_memory_gb() -> float:
    """Device memory still allocated by earlier phases' tensors, after a
    collection: the base a model's peak is stated above."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def family_full_width(dev, launches, card: str, main_run: dict,
                      stepped=FAMILY_STEPPED, forward=FAMILY_FORWARD,
                      tag: str = "14b") -> dict:
    """Phases 14b and 17b: the denoiser at 448^2 x16 bf16 for each
    ``stepped`` name (2 warm-up and 5 timed steps, a profile of 3 more),
    then one eval forward at 448^2 x16 bf16 of each ``forward`` name; every
    parameter count against ``PARAM_COUNTS``. Returns the launch counts by
    path."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        param_count)

    counts = {}
    rows = [f"resnet34 (phase 5) {16 / main_run['step_ms'] * 1e3:.1f} "
            f"imgs/s"]
    for name in stepped:
        run, row = stepped_full_width(dev, launches, card, name)
        counts[f"family_{name}_448"] = run["counts"]
        rows.append(row)
        del run
        torch.cuda.empty_cache()
    if stepped:
        log(f"  {tag} 448^2 x16 bf16 denoiser: {'; '.join(rows)} [{card}]")

    x = torch.rand((16, 448, 448, 3), device=dev) * 2 - 1
    for name in forward:
        held_gb = held_memory_gb()
        trainer = make_trainer(dev, encoder=name, batch=16, size=448,
                               dtype="bfloat16")
        state = trainer.init_state(seed=SEED)
        n = param_count(state.model)
        check(n == PARAM_COUNTS[name], f"{name} has {n} parameters, not "
              f"{PARAM_COUNTS[name]}")
        denoise = trainer.make_denoise_fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = denoise(state, x)
        check(out.shape == x.shape and torch.isfinite(out).all().item(),
              f"{name}: the eval forward is not finite")
        ms = time_ms(lambda: denoise(state, x), iters=5, warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
        log(f"  {tag} {name}: {n:,} params, eval forward 448^2 x16 bf16 "
            f"{ms:.3f} ms (mean of 5 back to back, {16 / ms * 1e3:.1f} "
            f"imgs/s), peak memory {peak_gb:.2f} GB above the "
            f"{held_gb:.2f} GB held before [{card}]")
        del trainer, state, out
        torch.cuda.empty_cache()
    return counts


def stepped_full_width(dev, launches, card: str, name: str, **overrides
                       ) -> tuple[dict, str]:
    """One name of phases 14b, 17b and 18c: the denoiser at 448^2 x16
    bf16 (``overrides`` on ``make_trainer``'s config), 2 warm-up and 5
    timed steps, one fused warp and one fp32 noise launch a step, a
    profile of 3 more; the parameter count against ``PARAM_COUNTS``
    (unpatchified). Returns the run and its report row."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        param_count)

    held_gb = held_memory_gb()
    trainer = make_trainer(dev, encoder=name, batch=16, size=448,
                           dtype="bfloat16", **overrides)
    run = drive(dev, launches, card, single_path(trainer, size=448,
                                                 batch=16),
                warmup=2, steps=5,
                per_step={"affine_warp_fused": 1, "fused_noise_blend": 1})
    n = param_count(run["state"].model)
    if not overrides:
        check(n == PARAM_COUNTS[name], f"{name} has {n} parameters, not "
              f"{PARAM_COUNTS[name]}")
    profile_steps(run, dev, None)
    run["own_peak_gb"] = run["peak_gb"] - held_gb
    idle = (f"idle {1 - run['busy_ms'] / run['step_ms']:.1%}"
            if run["busy_ms"] > 0 else "idle not measured")
    label = name + "".join(f" {k}={v}" for k, v in overrides.items())
    row = (f"{label} {16 / run['step_ms'] * 1e3:.1f} imgs/s "
           f"({run['step_ms']:.3f} ms a step, kernels "
           f"{run['busy_ms']:.3f} ms, {idle}, peak "
           f"{run['peak_gb'] - held_gb:.2f} GB above the "
           f"{held_gb:.2f} GB held before, {n:,} params)")
    return run, row


def reference_ckpt(path: Path, encoder: str, hparams: dict, *,
                   with_ema: bool) -> dict:
    """A reference Lightning ``.ckpt``, written as the reference's trainer
    saves one: smp keys (the port's U-Net has them) with BN's
    ``num_batches_tracked``, under ``model_{a,b}.`` and, with EMA,
    ``ema_model_{a,b}.ema_model.`` with ema_pytorch's ``initted`` and
    ``step``; ``criterion.*``; the Lightning counters. Every model has
    its own weights and BN statistics. Returns the state_dict."""
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        create_unet, init_unet_)

    names = ["model_a", "model_b"]
    if with_ema:
        names += ["ema_model_a", "ema_model_b"]
    sd = {}
    for i, name in enumerate(names):
        g = torch.Generator().manual_seed(SEED + 40 + i)
        model = init_unet_(create_unet(encoder), g)
        prefix = (f"{name}." if name.startswith("model")
                  else f"{name}.ema_model.")
        for key, value in model.state_dict().items():
            if key.endswith("running_mean"):
                value = torch.randn(value.shape, generator=g) * 0.1
            elif key.endswith("running_var"):
                value = 1 + torch.rand(value.shape, generator=g) * 0.5
            sd[prefix + key] = value
            if key.endswith("running_mean"):
                sd[prefix + key[:-len("running_mean")]
                   + "num_batches_tracked"] = torch.tensor(
                       REF_GLOBAL_STEP, dtype=torch.int64)
        if not name.startswith("model"):
            sd[f"{name}.initted"] = torch.tensor(True)
            sd[f"{name}.step"] = torch.tensor(REF_GLOBAL_STEP)
    sd["criterion.ssim.kernel"] = torch.ones(1, 1, 11, 11) / 121
    torch.save({"state_dict": sd, "hyper_parameters": hparams,
                "epoch": REF_EPOCH, "global_step": REF_GLOBAL_STEP,
                "pytorch-lightning_version": "1.9.0",
                "optimizer_states": [{}], "lr_schedulers": [{}]}, path)
    return sd


def _without(sd: dict, prefix: str) -> dict:
    """``sd``'s keys under ``prefix``, less BN's ``num_batches_tracked``."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


def swap_batch_check(imported: Path, sd: dict, prefix: str, encoder: str,
                     dev, *, use_ema: bool) -> float:
    """One 448^2 x16 single-pass batch from ``load_swap_model`` of the
    import, bit-equal to the same pipeline with the .ckpt's weights
    under ``prefix`` loaded straight into a port U-Net. Returns its ms."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        create_unet)

    swap = load_swap_model(imported, "a", use_ema=use_ema, device=dev)
    frames = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, 256, (16, 448, 448, 3), np.uint8)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = make_device_pipeline(swap)(frames, 0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    straight = create_unet(encoder, dtype=torch.bfloat16)
    straight.load_state_dict(_without(sd, prefix))
    swap.model = straight.to(dev).to(
        memory_format=torch.channels_last).eval().requires_grad_(False)
    want = make_device_pipeline(swap)(frames, 0)
    check(got.shape == frames.shape and got.dtype == torch.uint8
          and torch.equal(got, want),
          f"{encoder}: the imported swap model's batch differs from the "
          f".ckpt's weights loaded straight ({prefix})")
    return ms


def resume_from_import(imported: Path, root: Path, data: dict, dev,
                       launches, card: str, *, k: int) -> tuple:
    """fit_deep_fake resumed from the import for one epoch of 3 steps
    (eager, or with ``steps_per_call`` k = 3: one group captured on the
    imported fresh Adam), in a checkpoint directory of its own. Returns
    (states, checkpoint directory, launch counts)."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DeepFakeConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_deep_fake)

    meta = CheckpointManager(imported).read_meta()
    name = f"import_resume_k{k}"
    cfg = config_from_dict(DeepFakeConfig, dict(
        meta["hparams"], steps_per_call=k, log_images=False,
        log_dir=str(root / name / "runs"),
        checkpoint_dir=str(root / name / "ckpt")))
    calls = []
    t0 = time.perf_counter()
    (states, _, ctx), counts = fit_counted(
        fit_deep_fake, launches, cfg, resume_from=str(imported),
        max_steps=REF_GLOBAL_STEP + 3,
        step_callback=lambda step, _, m: calls.append(
            (step, [float(v) for v in torch.atleast_1d(
                m["loss_swap/train_a"])])))
    run_s = time.perf_counter() - t0
    want_calls = ([REF_GLOBAL_STEP + 3] if k == 3
                  else [REF_GLOBAL_STEP + i for i in (1, 2, 3)])
    check([c[0] for c in calls] == want_calls
          and ctx.epoch == REF_EPOCH + 1
          and ctx.global_step == REF_GLOBAL_STEP + 3,
          f"the resume from the import (K = {k}) ran {calls} in epoch "
          f"{ctx.epoch}")
    check(all(math.isfinite(v) for _, vs in calls for v in vs),
          f"the resume from the import (K = {k}): losses {calls}")
    for ident, state in states.items():
        steps = {float(s["step"]) for s in
                 state.optimizer.state_dict()["state"].values()}
        check(state.step == 3 and state.ema_step == 3 and steps == {3.0},
              f"{ident}: a fresh Adam would have taken 3 steps; the state "
              f"has step {state.step}, Adam steps {steps}")
        check(all(g["fused"] for g in state.optimizer.param_groups),
              f"{ident}: the resumed Adam is not the fused one")
    check_launches(counts, {"affine_warp_fused": 6, "fused_noise_blend": 6},
                   f"the resume from the import (K = {k})")
    log(f"  resumed from the import, K = {k}: steps {want_calls} in epoch "
        f"{ctx.epoch} in {run_s:.2f} s (loader, 3 steps, final save), "
        f"losses a {[round(v, 5) for _, vs in calls for v in vs]} [{card}]")
    return states, Path(cfg.checkpoint_dir), counts


def checkpoints_in_and_out(root: Path, data: dict, dev, launches,
                           card: str) -> dict:
    """Phase 14c: a reference .ckpt of a resnet34 pair in swap mode
    (configs/swap.yml over configs/denoise.yml, data paths at 10a's
    frames) -> import -> the shadow's swap batch -> resume on the card,
    eager and grouped -> export -> import again, bit-equal; then a
    resnet50 .ckpt's import and swap batch. Returns the launch counts."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
        export_reference_checkpoint)
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
        import_reference_checkpoint)

    root.mkdir(parents=True)
    hparams = {k: list(v) if isinstance(v, tuple) else v
               for k, v in dict(DENOISE_YML, **SWAP_YML).items()}
    hparams.update(data_path_a=str(data["a"]), data_path_b=str(data["b"]))
    ckpt = root / "reference.ckpt"
    t0 = time.perf_counter()
    sd = reference_ckpt(ckpt, "resnet34", hparams, with_ema=True)
    log(f"  reference .ckpt: {len(sd)} keys, {ckpt.stat().st_size / 1e6:.1f}"
        f" MB, written in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    imported = import_reference_checkpoint(ckpt, root / "imported").parent
    import_s = time.perf_counter() - t0
    meta = CheckpointManager(imported).read_meta()
    check(meta["step"] == REF_GLOBAL_STEP and meta["hparams"]["mode"] ==
          "swap" and meta["extra"]["epoch"] == REF_EPOCH,
          f"the import's meta: {meta['step']}, {meta['extra']}")
    swap_ms = swap_batch_check(imported, sd, "ema_model_a.ema_model.",
                               "resnet34", dev, use_ema=True)
    log(f"  import: {import_s:.2f} s, {tree_bytes(imported) / 1e6:.1f} MB "
        f"written; the shadow's 448^2 x16 swap batch ({swap_ms:.1f} ms, "
        f"first call) bit-equal to the .ckpt's shadow loaded straight "
        f"[{card}]")

    counts = {}
    for k in (1, 3):
        states, resumed, counts[f"import_resume_448_k{k}"] = \
            resume_from_import(imported, root, data, dev, launches, card,
                               k=k)
    out = root / "exported.ckpt"
    t0 = time.perf_counter()
    info = export_reference_checkpoint(resumed, out)
    export_s = time.perf_counter() - t0
    exported = torch.load(out, map_location="cpu", weights_only=False)
    want_keys = {k for k in sd if not k.startswith("criterion.")}
    check(set(exported["state_dict"]) == want_keys,
          "the exported keys are not the reference's less criterion.*: "
          f"{sorted(set(exported['state_dict']) ^ want_keys)[:6]}")
    check(exported["global_step"] == REF_GLOBAL_STEP + 3
          and exported["epoch"] == REF_EPOCH + 1
          and all(exported["state_dict"][f"ema_model_{i}.step"].item() == 3
                  for i in "ab"), "the exported counters")
    t0 = time.perf_counter()
    again = import_reference_checkpoint(out, root / "again").parent
    reimport_s = time.perf_counter() - t0
    manager = CheckpointManager(again)
    for ident, state in states.items():
        parts = manager.restore_partial(ident, ["model", "ema_model"],
                                        device="cpu")
        for part, module in (("model", state.model),
                             ("ema_model", state.ema_model)):
            want = module.state_dict()
            got = parts[part]
            bad = [key for key in want if not torch.equal(
                got[key], want[key].cpu())]
            check(got.keys() == want.keys() and not bad,
                  f"{ident} {part}: export + import differs from the "
                  f"resumed state at {bad[:4]}")
    log(f"  export of the resumed pair: {info['keys']} tensors, "
        f"{out.stat().st_size / 1e6:.1f} MB in {export_s:.2f} s; imported "
        f"again in {reimport_s:.2f} s, every model and shadow tensor "
        f"bit-equal to the resumed states [{card}]")

    ckpt50 = root / "reference_resnet50.ckpt"
    sd50 = reference_ckpt(ckpt50, "resnet50", dict(
        hparams, mode="denoise", encoder_name="resnet50"), with_ema=False)
    t0 = time.perf_counter()
    imported50 = import_reference_checkpoint(ckpt50,
                                             root / "imported50").parent
    import50_s = time.perf_counter() - t0
    ms50 = swap_batch_check(imported50, sd50, "model_a.", "resnet50", dev,
                            use_ema=False)
    log(f"  resnet50 .ckpt ({ckpt50.stat().st_size / 1e6:.1f} MB, denoise "
        f"mode): imported in {import50_s:.2f} s, "
        f"{tree_bytes(imported50) / 1e6:.1f} MB written; its 448^2 x16 "
        f"swap batch ({ms50:.1f} ms, first call) bit-equal to the .ckpt's "
        f"weights loaded straight [{card}]")
    return counts


def resnet_family_and_checkpoints(root: Path, data: dict, dev, launches,
                                  card: str, main_run: dict) -> dict:
    """Phase 14: 14a the *50 names' 64^2 fp32 steps on the GPU against the
    CPU, 14b their full-width rates and the deeper names' forwards, 14c
    reference checkpoints in and out. Returns the launch counts by path."""
    t0 = time.perf_counter()
    log("[14a] the Bottleneck family's small references: 64^2 fp32 steps, "
        "GPU vs CPU")
    for name in FAMILY_STEPPED:
        small_reference(dev, encoder=name)
    log("[14b] the resnet family at full width: 448^2 x16 bf16")
    counts = family_full_width(dev, launches, card, main_run)
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log("[14c] a reference .ckpt in, resumed on the card, and out again")
    counts.update(checkpoints_in_and_out(root, data, dev, launches, card))
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# ------------------------------------ phase 15: JPEG/PNG, cv2 and without

CODEC_LIBS = ("jpeg", "turbojpeg", "png", "z")
CODEC_HEADERS = ("jpeglib.h", "png.h")


def codec_probe() -> dict:
    """What this machine offers to decode JPEG and PNG: the libraries the
    loader finds, the headers a build could include, g++, cv2 and PIL."""
    import ctypes.util
    import importlib

    def imports(name: str) -> bool:
        try:
            importlib.import_module(name)
        except ImportError:
            return False
        return True

    include_dirs = ["/usr/include", "/usr/local/include"]
    return {
        "libs": {n: ctypes.util.find_library(n) for n in CODEC_LIBS},
        "headers": {h: [d for d in include_dirs if (Path(d) / h).exists()]
                    for h in CODEC_HEADERS},
        "gxx": shutil.which("g++"),
        "cv2": imports("cv2"),
        "PIL": imports("PIL"),
    }


FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "codec"
_ABSENT = object()


@contextlib.contextmanager
def without_cv2():
    """cv2 hidden from the port: ``import cv2`` raises ImportError inside."""
    saved = sys.modules.get("cv2", _ABSENT)
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is _ABSENT:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def implied_decoders(probe: dict) -> tuple[str, str]:
    """The loader's decoder that the probe implies, with cv2 and without:
    the native library where g++ finds libjpeg's and libpng's headers and
    libraries, else cv2; with neither, ``"none"`` (the loader raises)."""
    native = bool(probe["gxx"] and probe["headers"]["jpeglib.h"]
                  and probe["headers"]["png.h"] and probe["libs"]["jpeg"]
                  and probe["libs"]["png"])
    without = "native" if native else "none"
    return ("cv2" if probe["cv2"] and not native else without), without


def fixture_manifest(root: Path) -> Path:
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)

    path = root / "fixtures.txt"
    write_image_manifest(path, sorted(FIXTURES.glob("*.jpg"))
                         + sorted(FIXTURES.glob("*.png")))
    return path


def codec_choice(root: Path, card: str) -> str:
    """15a: the probe, and the decoder the loader chose with cv2 and
    without; each must be the one the probe implies, and a loader with no
    decoder must raise naming what is missing."""
    from denoising_diffusion_deep_fake_tpu_torch.data import native_loader
    from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
        ImageLoader)

    probe = codec_probe()
    log(f"  probe: {json.dumps(probe)} [{card}]")
    want, want_bare = implied_decoders(probe)
    manifest = fixture_manifest(root)
    chosen = ImageLoader(manifest, 1, image_size=32).decoder
    error = ""
    with without_cv2():
        try:
            bare = ImageLoader(manifest, 1, image_size=32).decoder
        except RuntimeError as e:
            bare, error = "none", str(e)
    log(f"  the loader chose {chosen!r} ({want!r} implied), without cv2 "
        f"{bare!r} ({want_bare!r} implied){': ' + error if error else ''}; "
        f"native library: {native_loader.unavailable_reason() or 'built'}")
    check(chosen == want and bare == want_bare,
          "15a: the loader's decoder is not the one the probe implies")
    if bare == "none":
        check("cv2 does not import" in error
              and "there is no native loader" in error,
              f"15a: the loader's error does not name what is missing: "
              f"{error!r}")
    return chosen


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def fixture_decodes(root: Path, card: str) -> None:
    """15b: each committed fixture through the loader's route (cv2 on the
    card machine) against the committed cv2 decode, within the JAX
    package's tolerance for a decoder (max 3, mean below 1.0 LSB); cv2's
    q95 round trip of source.npy."""
    import cv2
    from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
        ImageLoader)

    loader = ImageLoader(fixture_manifest(root), 1, image_size=32)
    for path in sorted(FIXTURES.glob("*.jpg")) + sorted(FIXTURES.glob(
            "*.png")):
        want = np.load(path.with_suffix(".npy"))
        got = loader._decode([str(path)])[0]
        check(got.shape == want.shape, f"15b {path.name}: shape {got.shape}")
        diff = np.abs(got.astype(np.int16) - want)
        top, mean = int(diff.max()), float(diff.mean())
        log(f"  {path.name} {want.shape}: cv2 {cv2.__version__} against the "
            f"committed decode max {top} LSB, mean {mean:.4f}")
        check(top <= 3 and mean < 1.0, f"15b {path.name}: the loader's "
              f"route against the committed decode: max {top}, mean "
              f"{mean:.4f}")
    source = np.load(FIXTURES / "source.npy")
    blob = jpeg_bytes(source[None])[0]
    back = cv2.imdecode(np.frombuffer(blob, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]
    log(f"  cv2 q95 4:2:0 round trip of source.npy: {len(blob)} bytes, "
        f"PSNR {psnr(back, source):.2f} dB [{card}]")


def smooth_frames(dev, n: int, height: int, width: int, seed: int
                  ) -> torch.Tensor:
    """``n`` uint8 RGB frames on the card that compress like face crops:
    noise at four scales, each cubic-upsampled, over a gradient."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ramp = torch.linspace(0, 60, width, device=dev)[None, None, None, :]
    x = 90 + ramp + torch.zeros((n, 3, height, width), device=dev)
    for cells, amp in ((7, 140.0), (28, 50.0), (112, 18.0), (448, 5.0)):
        noise = torch.rand((n, 3, cells, cells * width // height),
                           generator=g, device=dev) - 0.5
        x += amp * torch.nn.functional.interpolate(
            noise, size=(height, width), mode="bicubic", align_corners=False)
    return x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)


def jpeg_bytes(frames) -> list:
    """uint8 RGB frames (NHWC, a tensor or an array) as JPEG files by
    ``cv2.imencode``: quality 95, 4:2:0."""
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, 95,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    host = frames.cpu().numpy() if torch.is_tensor(frames) else frames
    blobs = []
    for frame in host:
        ok, blob = cv2.imencode(".jpg", np.ascontiguousarray(frame[..., ::-1]),
                                params)
        check(ok, "cv2.imencode failed")
        blobs.append(blob.tobytes())
    return blobs


def write_jpegs(root: Path, frames: torch.Tensor, start: int = 0) -> list:
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, blob in enumerate(jpeg_bytes(frames)):
        paths.append(root / f"{start + i:05d}.jpg")
        paths[-1].write_bytes(blob)
    return paths


def jpeg_fits(root: Path, data: Path, ident: dict, launches, probe,
              npy_rates: dict, card: str) -> dict:
    """15c through the loader's cv2 route: fit_denoiser x16 host and
    device, eager and K = 16, 3 epochs each; fit_balance x12 for one
    epoch; the CLI's train new for 3 steps. Returns the launch counts by
    path."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch import main as cli
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_balance, fit_denoiser)

    fused = {"affine_warp_fused": 1, "fused_noise_blend": 1}
    counts = {}
    route, prefix = "cv2", "jpeg_cv2"
    out = root / route
    for cache in ("host", "device"):
        for k in (1, 16):
            cfg = config_from_dict(DenoiserConfig, dict(
                input_image_list_path=str(data), batch_size=16,
                learning_rate=0.02, max_epochs=3,
                cosine_scheduler_max_epoch=100, encoder_name="resnet34",
                noise_exponential_sampling_lambda=5,
                compute_dtype="bfloat16", image_size=448, seed=SEED,
                steps_per_call=k, data_cache=cache, log_images=False,
                log_dir=str(out / f"d_{cache}_{k}" / "runs"),
                checkpoint_dir=str(out / f"d_{cache}_{k}" / "ck")))
            run = timed_fit(probe, launches, fit_denoiser, cfg, spe=16,
                            images=16, decode_fn=None)
            check_launches(run["counts"], {n: 48 * v
                                           for n, v in fused.items()},
                           f"15c fit_denoiser {route} {cache} K = {k}")
            npy = npy_rates.get(f"denoiser_{cache}_{k}")
            counts[f"{prefix}_fit_denoiser_448_{cache}_k{k}"] = run["counts"]
            log(f"  fit_denoiser 448^2 x16 from JPEG through {route}, "
                f"{cache}, K = {k}: {run['imgs_s']:.1f} imgs/s over epochs "
                f"2-3 (13b's .npy run {npy:.1f}) [{card}]")
    cfg = config_from_dict(BalanceConfig, dict(
        data_path=str(data), batch_size=12, learning_rate=0.01,
        max_epochs=1, encoder_name="resnet34", ratio_of_noise=0.7,
        number_of_classes=10, compute_dtype="bfloat16", image_size=448,
        seed=SEED, log_images=False,
        output_image_list_path=str(out / "balanced.txt"),
        log_dir=str(out / "bal" / "runs"),
        checkpoint_dir=str(out / "bal" / "ck")))
    t1 = time.perf_counter()
    run = timed_fit(probe, launches, fit_balance, cfg, spe=22,
                    images=12, decode_fn=None, marks=(22,))
    check_launches(run["counts"], {"fused_normalise_noise_blend":
                                   22 + 22}, f"15c fit_balance {route}")
    counts[f"{prefix}_fit_balance_448"] = run["counts"]
    check(len((out / "balanced.txt").read_text().splitlines()) == 264,
          "15c: the balanced manifest lacks images")
    log(f"  fit_balance 448^2 x12 from JPEG through {route}, 1 epoch (22 "
        f"steps, 264 scored): {time.perf_counter() - t1:.2f} s [{card}]")
    config = out / "deep_fake.yml"
    config.write_text(json.dumps(dict(
        DENOISE_YML, data_path_a=str(ident["a"]),
        data_path_b=str(ident["b"]), max_epochs=1,
        log_dir=str(out / "cli" / "runs"),
        checkpoint_dir=str(out / "cli" / "ck"))))
    launches.clear()
    t1 = time.perf_counter()
    rc = cli.main(["train", "new", "--config_path", str(config),
                   "--max_steps", "3"])
    torch.cuda.synchronize()
    counts[f"{prefix}_cli_train_new_448"] = dict(launches)
    check(rc in (0, None), f"15c: train new through {route} returned {rc}")
    check_launches(counts[f"{prefix}_cli_train_new_448"],
                   {n: 6 * v for n, v in fused.items()},
                   f"15c train new {route}")
    log(f"  the CLI's train new from the JPEG manifests through {route}, 3 "
        f"steps: {time.perf_counter() - t1:.2f} s [{card}]")
    return counts


def jpeg_training(root: Path, dev, launches, probe, card: str,
                  step_ms: float, npy_rates: dict) -> dict:
    """15c: 256 JPEG frames of 448^2 an identity and 8 of 512x384, written
    by cv2; the runners from them with no decode_fn, through the loader's
    cv2 route; the DeviceCache's decode of 1,024 entries and a host batch's
    decode. Returns the launch counts by path."""
    from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
        DeviceDatasetCache)
    from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
        ImageLoader)
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        write_image_manifest)

    t0 = time.perf_counter()
    ident = {}
    for k, name in enumerate(("a", "b")):
        paths = write_jpegs(root / name, smooth_frames(
            dev, 256, 448, 448, SEED + 150 + k))
        ident[name] = root / f"{name}.txt"
        write_image_manifest(ident[name], paths)
    write_jpegs(root / "a", smooth_frames(dev, 8, 384, 512, SEED + 152),
                start=256)
    sizes = [p.stat().st_size for p in (root / "a").glob("*.jpg")]
    data = root / "denoiser.txt"
    write_image_manifest(data, sorted((root / "a").glob("*.jpg")))
    log(f"  512 JPEG frames of 448^2 and 8 of 512x384 written by cv2 "
        f"(q95, 4:2:0) in {time.perf_counter() - t0:.2f} s; identity a's "
        f"files {np.mean(sizes) / 1e3:.1f} kB on average [{card}]")
    chosen = ImageLoader(data, 16, image_size=448).decoder
    check(chosen == "cv2", f"15c: the loader chose {chosen!r}, not cv2")
    counts = jpeg_fits(root, data, ident, launches, probe, npy_rates, card)
    # The dataset on the card from 1,024 JPEG entries, and a host batch's
    # decode beside the step.
    big = root / "a_1024.txt"
    write_image_manifest(big, sorted((root / "a").glob("*.jpg"))[:256] * 4)
    cache = DeviceDatasetCache(ImageLoader(big, 16, image_size=448),
                               device=dev)
    decode_s = cache.decode_s
    del cache
    torch.cuda.empty_cache()
    loader = ImageLoader(data, 16, image_size=448, cache=False)
    batch = np.arange(16)
    loader._decode_batch(batch)
    t1 = time.perf_counter()
    for _ in range(5):
        loader._decode_batch(batch)
    batch_ms = (time.perf_counter() - t1) / 5 * 1e3
    log(f"  decode of 1,024 JPEG entries of 448^2 into the DeviceCache "
        f"through {loader.decoder}: {decode_s:.2f} s; a host batch of 16 "
        f"decoded: {batch_ms:.1f} ms beside phase 5's step {step_ms:.1f} ms "
        f"[{card}]")
    log(f"  phase 15c took {time.perf_counter() - t0:.1f} s")
    return counts


def route_codec():
    """The JPEG route's three host stages, each a function of one frame,
    as the server runs them with cv2: decode (bytes -> BGR), crop and
    resize, encode (RGB -> bytes at q95)."""
    import cv2
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        prepare_frame)

    def decode(blob):
        return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)

    def encode(rgb):
        return cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                            [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    return decode, lambda bgr: prepare_frame(bgr, 448, 448), encode


def serve_route(port: int, ran: list, bodies: list, direct, clients: int,
                per_client: int, raw_rate: float, card: str) -> float:
    """15d: ``clients`` x ``per_client`` POST /v1/swap requests, each reply
    checked against the device batch it rode in (``ran``, the engine's
    recorded batches); the route's host stages timed a frame at a time
    after. Returns frames/s over HTTP."""
    route = "cv2"
    decode, prepare, encode = route_codec()
    ran.clear()
    replies = [[] for _ in range(clients)]

    def post(body: bytes):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/v1/swap", body=body,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def client(c):
        for r in range(per_client):
            k = (c * per_client + r) % len(bodies)
            replies[c].append((k, post(bodies[k])))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_s = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          f"15d {route}: a client hung")
    prepared = [prepare(decode(b)) for b in bodies]
    host = [(f.cpu().numpy(), o.cpu().numpy()) for f, o, _ in ran]
    for batch, out, idx in ran:
        u8_compare(out, direct(batch, idx), f"15d {route}: an engine batch "
                   "against the pipeline on the same batch", quiet=True)
    n = 0
    for row in replies:
        for k, (status, body) in row:
            check(status == 200, f"15d {route}: /v1/swap answered "
                  f"{status}: {body[:300]!r}")
            reply = decode(body)
            check(reply.shape == (448, 448, 3),
                  f"15d {route}: a reply decodes to {reply.shape}")
            slots = [o[s] for f, o in host for s in range(len(f))
                     if np.array_equal(f[s], prepared[k])]
            check(bool(slots), f"15d {route}: a request's frame is in no "
                  "device batch")
            check(any(encode(o) == body for o in slots),
                  f"15d {route}: a reply is not the JPEG of its batch's "
                  "output")
            n += 1
    bgr = decode(bodies[0])
    rgb = prepare(bgr)
    stages = {}
    for name, fn in (("decode", lambda: decode(bodies[0])),
                     ("crop and resize", lambda: prepare(bgr)),
                     ("encode", lambda: encode(rgb))):
        fn()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        stages[name] = (time.perf_counter() - t0) / 10 * 1e3
    rate = n / wall_s
    log(f"  {route}: the route's host stages alone, a frame: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items())
        + f" [{card}]")
    log(f"  {route}: {n} JPEG requests of 640x480 (q95, "
        f"{np.mean([len(b) for b in bodies]) / 1e3:.1f} kB) from {clients} "
        f"clients: {rate:.1f} frames/s over HTTP (9e's raw route "
        f"{raw_rate:.1f}); every reply 448^2 and byte-equal to the route's "
        f"JPEG of its device batch's output, each batch within 1 LSB of "
        f"the pipeline on it [{card}]")
    return rate


def jpeg_serving(ckpt: Path, dev, card: str, raw_rate: float) -> float:
    """15d: 9e's engine behind SwapServer: POST /v1/swap with JPEG bodies
    of 640x480 frames (crop and resize), 4 clients x 25 requests, through
    cv2. Each reply decodes to 448^2 and is byte-equal to cv2's JPEG of its
    device batch's output at its slot; each batch within 1 LSB of the
    pipeline on the same batch. Returns frames/s."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        make_device_pipeline)
    from denoising_diffusion_deep_fake_tpu_torch.serving import SwapEngine
    from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
        SwapServer)

    bodies = jpeg_bytes(smooth_frames(dev, 16, 480, 640, SEED + 160))
    engine = SwapEngine(ckpt, "a", height=448, width=448, batch_size=8)
    engine.warmup()
    direct = make_device_pipeline(engine.model)
    ran = []
    pipeline = engine._dispatchers[0].pipeline

    def recorded(batch, batch_idx):
        out = pipeline(batch, batch_idx)
        ran.append((batch.clone(), out, batch_idx))
        return out

    engine._dispatchers[0].pipeline = recorded
    # The server's shutdown closes the engine.
    server = SwapServer(engine, host="127.0.0.1", port=0)
    server.start()
    try:
        return serve_route(server.port, ran, bodies, direct, 4, 25,
                           raw_rate, card)
    finally:
        server.shutdown()


def jpeg_frames(root: Path, ckpt: Path, dev, launches, card: str,
                step_ms: float, npy_rates: dict, raw_rate: float) -> dict:
    """Phase 15: the reference's JPEG/PNG frames on the card through the
    loader's route, cv2 on the card machine. Returns the launch counts by
    path."""
    t0 = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    log("[15a] codec probe and the loader's choice")
    chosen = codec_choice(root, card)
    check(chosen == "cv2", f"15: phase 15 drives cv2, the loader chose "
          f"{chosen!r}")
    log("[15b] the committed fixtures through the loader's route")
    fixture_decodes(root, card)
    log("[15c] the runners and the CLI from JPEG files")
    with CacheProbe() as probe:
        counts = jpeg_training(root / "jpeg", dev, launches, probe, card,
                               step_ms, npy_rates)
    log("[15d] POST /v1/swap with JPEG bodies")
    jpeg_serving(ckpt, dev, card, raw_rate)
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# ------------------- phase 16: color jitter, remat and the CLI's profile


JITTER = (0.2, 0.2, 0.2, 0.05)
FUSED = {"affine_warp_fused": 1, "fused_noise_blend": 1}
POLICIES = ("none", "dots", "full")


def jitter_on_card(dev, card: str) -> None:
    """16a: ``color_jitter_normalised`` at 448^2 x16 fp32 with injected
    factors on the card against the CPU, and its time on the card."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.color import (
        color_jitter_normalised)

    rng = np.random.default_rng(SEED + 160)
    b, s, hue = 16, 448, 0.05
    x = torch.from_numpy(rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32))
    params = {k: torch.from_numpy(rng.uniform(lo, hi, b).astype(np.float32))
              for k, lo, hi in (("brightness", 0.8, 1.2),
                                ("contrast", 0.8, 1.2),
                                ("saturation", 0.8, 1.2),
                                ("hue", -hue, hue))}
    params["apply"] = torch.from_numpy(rng.random(b) < 0.8)
    want = color_jitter_normalised(x, params, *HALF)
    xd = x.to(dev)
    pd = {k: v.to(dev) for k, v in params.items()}
    got = color_jitter_normalised(xd, pd, *HALF).cpu()
    diff = (got - want).abs()
    share = (diff > 1e-5).float().mean().item()
    worst = diff.max().item()
    ms = time_ms(lambda: color_jitter_normalised(xd, pd, *HALF), 20)
    n_bytes = 2 * x.numel() * 4
    log(f"  16a color_jitter_normalised 448^2 x16 fp32, card against CPU: "
        f"max |difference| {worst:.3e}, {share:.2e} of the values beyond "
        f"1e-5 (limits: 1e-3 of them, up to 4 x the largest hue shift "
        f"+ 1e-4 = {4 * hue + 1e-4:.4f}, where a tie between channels "
        f"picks another hue sector); {ms:.4f} ms on the card (mean of 20; "
        f"one pass over its {n_bytes / 1e6:.1f} MB would take "
        f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) [{card}]")
    check(share < 1e-3 and worst <= 4 * hue + 1e-4,
          f"16a: the jitter on the card differs from the CPU's ({worst}, "
          f"{share})")


def remat_references(dev, launches) -> dict:
    """16b: 64^2 x2 resnet18 fp32 under cudnn.deterministic: a denoiser
    step and a deep-fake swap step with each remat policy (jitter on),
    bit-equal across policies, BN statistics the no-remat step's; a K = 3
    graph with ``remat: dots`` and jitter on against 3 eager steps; a
    step with ``warp_method: shear`` and ``hybrid``, card against CPU.
    Returns the graph's launch counts."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    rng = np.random.default_rng(SEED + 161)
    small = dict(batch_size=2, encoder_name="resnet18",
                 compute_dtype="float32", image_size=64,
                 color_jitter=JITTER)
    try:
        for what, make, init, n_args in (
                ("denoiser", lambda p: make_trainer(
                    dev, encoder="resnet18", batch=2, size=64,
                    dtype="float32", remat=p, color_jitter=JITTER),
                 lambda t: t.init_state(seed=SEED), 1),
                ("deep-fake swap", lambda p: make_deep_fake(
                    dev, dict(DENOISE_YML, **SWAP_YML), remat=p,
                    ema_update_after_step=0, **small),
                 lambda t: t.init_states(seed=SEED), 2)):
            batches = [torch.from_numpy(rng.integers(
                0, 256, (2, 64, 64, 3), np.uint8)).to(dev)
                for _ in range(n_args)]
            runs = {}
            for policy in POLICIES:
                trainer = make(policy)
                states = init(trainer)
                metrics = trainer.train_step(states, *batches)
                runs[policy] = (trainer, states, {
                    k: float(v) for k, v in metrics.items()})
            for policy in ("dots", "full"):
                bad = states_differ(runs[policy][1], runs["none"][1])
                check(not bad and runs[policy][2] == runs["none"][2],
                      f"16b {what}: remat {policy} differs from none: "
                      f"{bad[:5]}")
                check(torch.equal(runs[policy][0].generator.get_state(),
                                  runs["none"][0].generator.get_state()),
                      f"16b {what}: remat {policy} moved the generator")
            log(f"  16b {what} step, remat none / dots / full: weights, BN "
                f"running statistics (updated once), Adam moments and "
                f"losses bit-equal ({runs['none'][2]})")

        eager_t, graph_t = (make_trainer(
            dev, encoder="resnet18", batch=2, size=64, dtype="float32",
            remat="dots", color_jitter=JITTER) for _ in "ab")
        eager_s, graph_s = (t.init_state(seed=SEED)
                            for t in (eager_t, graph_t))
        steps = [[torch.from_numpy(rng.integers(
            0, 256, (2, 64, 64, 3), np.uint8)).to(dev)] for _ in range(3)]
        eager = _run_eager(eager_t, eager_s, steps)
        step = graph_t.make_super_step(3)
        step(graph_s, *_k_flat(steps))  # captured on its first call
        bad = states_differ(graph_s, eager_s)
        # Replay the next group from the same states once more.
        steps2 = [[torch.from_numpy(rng.integers(
            0, 256, (2, 64, 64, 3), np.uint8)).to(dev)] for _ in range(3)]
        eager += _run_eager(eager_t, eager_s, steps2)
        torch.cuda.synchronize()
        launches.clear()
        groups = [step(graph_s, *_k_flat(steps2))]
        torch.cuda.synchronize()
        counts = {"graph_remat_jitter_64": dict(launches)}
        check(not bad, f"16b: the first K = 3 group differs: {bad[:5]}")
        check(step.captures == 1, f"16b: {step.captures} captures")
        check_launches(counts["graph_remat_jitter_64"],
                       {"fused_noise_blend": 3},
                       "16b K = 3 remat dots + jitter")
        _check_same("16b remat dots + jitter", graph_t, graph_s, eager_t,
                    eager_s, [groups[0]], eager[3:])
        log("  16b K = 3 graph, remat dots and jitter on: 2 replays "
            "bit-equal to 6 eager steps (weights, BN buffers, Adam, losses, "
            "generator)")
        for method in ("shear", "hybrid"):
            small_reference(dev, warp_method=method)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return counts


def remat_full_width(dev, launches, card: str, twopass_run: dict) -> tuple:
    """16c: the denoiser at 448^2 x16, resnet34, bf16, for each remat
    policy eager (3 + 10 steps and a profile of 3) and at K = 16 (2
    groups); jitter on against off; the 640^2 x4 route with ``remat:
    dots``. Returns the launch counts by path and the rows."""
    counts, rows = {}, {}
    state = None
    for policy in POLICIES + ("jitter",):
        extra = (dict(color_jitter=JITTER) if policy == "jitter"
                 else dict(remat=policy))
        trainer = make_trainer(dev, encoder="resnet34", batch=16, size=448,
                               dtype="bfloat16", **extra)
        if state is None:
            state = trainer.init_state(seed=SEED)
        run = drive(dev, launches, card, single_path(
            trainer, size=448, batch=16, state=state), warmup=3, steps=10,
            per_step=FUSED)
        profile_steps(run, dev, None)
        counts[f"remat_{policy}_448"] = run["counts"]
        row = dict(eager_imgs_s=16 / run["step_ms"] * 1e3,
                   eager_busy_ms=run["busy_ms"], eager_peak_gb=run["peak_gb"],
                   device_ms=run["device_ms"])
        if policy != "jitter":
            graph = graph_rate(dev, launches, card,
                               f"16c remat {policy} 448^2 x16", trainer,
                               state, 1, 16, run, FUSED, phase="16c")
            counts[f"graph_remat_{policy}_448"] = graph["counts"]
            row.update(graph_imgs_s=graph["imgs_s"],
                       graph_busy_ms=graph["busy_ms"],
                       graph_peak_gb=graph["peak_gb"])
        rows[policy] = row
        del trainer, run
        torch.cuda.empty_cache()
    log("  16c remat at 448^2 x16 resnet34 bf16 (imgs/s, kernels ms a "
        "step, peak GB; eager, then K = 16):")
    for policy in POLICIES:
        r = rows[policy]
        log(f"    {policy:5s} eager {r['eager_imgs_s']:.1f}, "
            f"{r['eager_busy_ms']:.3f}, {r['eager_peak_gb']:.2f}; K = 16 "
            f"{r['graph_imgs_s']:.1f}, {r['graph_busy_ms']:.3f}, "
            f"{r['graph_peak_gb']:.2f} [{card}]")
    on, off = rows["jitter"], rows["none"]
    log(f"  16c color_jitter {list(JITTER)} against off, eager: kernels "
        f"{on['eager_busy_ms']:.3f} against {off['eager_busy_ms']:.3f} ms a "
        f"step (the jitter {on['eager_busy_ms'] - off['eager_busy_ms']:.3f} "
        f"ms); device timeline median {on['device_ms']:.3f} against "
        f"{off['device_ms']:.3f} ms; {on['eager_imgs_s']:.1f} against "
        f"{off['eager_imgs_s']:.1f} imgs/s [{card}]")
    trainer = make_trainer(dev, encoder="resnet34", batch=4, size=640,
                           dtype="bfloat16", remat="dots")
    run = drive(dev, launches, card, single_path(trainer, size=640, batch=4),
                warmup=2, steps=10,
                per_step={"warp_axis_pass": 2, "fused_noise_blend": 1})
    counts["remat_dots_640"] = run["counts"]
    log(f"  16c 640^2 x4 remat dots: {4 / run['step_ms'] * 1e3:.1f} imgs/s, "
        f"peak {run['peak_gb']:.2f} GB, beside phase 6's "
        f"{4 / twopass_run['step_ms'] * 1e3:.1f} imgs/s and "
        f"{twopass_run['peak_gb']:.2f} GB [{card}]")
    return counts, rows


# 16d's profiled steps (each step's trace is ~7 MB to write and parse).
PROFILE_CLI_STEPS = 8


def profile_cli(root: Path, codec_root: Path, dev, card: str) -> dict:
    """16d: ``main.py profile --report`` in a subprocess on 15c's JPEG
    manifest (or frames written the same way), 448^2 x16, with
    ``color_jitter`` and ``remat: dots``: the report parses, names both
    port kernels of the path with ``PROFILE_CLI_STEPS`` launches each,
    its categories sum
    to its busy time within 1%; the trace directory is removed after.
    Returns the launches the report counts, by wrapper."""
    root.mkdir(parents=True, exist_ok=True)
    manifest = codec_root / "jpeg" / "a.txt"
    if not manifest.exists():
        from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
            write_image_manifest)

        manifest = root / "a.txt"
        write_image_manifest(manifest, write_jpegs(root / "a", smooth_frames(
            dev, 64, 448, 448, SEED + 150)))
    config = root / "profile.yml"
    config.write_text(json.dumps(dict(
        batch_size=16, learning_rate=0.02, max_epochs=100,
        cosine_scheduler_max_epoch=100, encoder_name="resnet34",
        noise_exponential_sampling_lambda=5, mean=[0.5] * 3, std=[0.5] * 3,
        compute_dtype="bfloat16", image_size=448, seed=SEED,
        color_jitter=list(JITTER), remat="dots",
        log_dir=str(root / "runs"), checkpoint_dir=str(root / "ck"))))
    trace_dir = root / "trace"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "denoising_diffusion_deep_fake_tpu_torch.main",
         "profile", "--config", str(config), "--input_list", str(manifest),
         "--steps", str(PROFILE_CLI_STEPS), "--trace_dir", str(trace_dir),
         "--report"],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    took = time.perf_counter() - t0
    check(out.returncode == 0, f"16d: profile exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    trace_bytes = tree_bytes(trace_dir)
    report = json.loads("\n".join(lines[lines.index("{"):]))
    shutil.rmtree(trace_dir)
    shutil.rmtree(root / "ck", ignore_errors=True)
    check(not trace_dir.exists(), "16d: the trace directory is still there")
    plane = device_report(report)
    check(bool(plane), f"16d: no device plane in the report: "
          f"{report.get('events_by_category')}")
    port = plane["port_kernels"]
    launched = {fn: port.get(fn, {}).get("launches", 0)
                for fn in ("warp_fused_kernel", "noise_blend_f32_kernel")}
    check(launched == {"warp_fused_kernel": PROFILE_CLI_STEPS,
                       "noise_blend_f32_kernel": PROFILE_CLI_STEPS},
          f"16d: the report's launches {launched}, not "
          f"{PROFILE_CLI_STEPS} each")
    busy = plane["ops_busy_ms_per_step"]
    cats = plane["category_ms_per_step"]
    total = sum(cats.values())
    log(f"  16d profile --steps {PROFILE_CLI_STEPS} --report (subprocess, "
        f"{took:.1f} s, "
        f"trace {trace_bytes / 1e6:.1f} MB): card busy {busy:.3f} ms a step, "
        f"module wall {plane['module_wall_ms_per_step']:.3f}, gap "
        f"{plane['in_module_gap_ms_per_step']:.3f}; categories sum "
        f"{total:.3f} ms ({total / busy - 1:+.2%} of busy); "
        f"{plane['n_distinct_ops']} distinct ops; port kernels {port}; "
        f"copies {plane['memcpy']} [{card}]")
    log("    category shares of busy: " + ", ".join(
        f"{k} {v / busy:.1%}" for k, v in cats.items()))
    for name, ms in list(plane["top_ops_ms_per_step"].items())[:8]:
        log(f"    {ms:8.3f}  {name[:100]}")
    log("    its 'other': " + "; ".join(
        f"{name[:70]} {ms:.3f}" for name, ms in
        plane["top_ops_per_category"].get("other", {}).items()))
    check(abs(total - busy) <= 0.01 * busy,
          f"16d: categories sum to {total} ms, busy {busy} ms")
    return {"affine_warp_fused": launched["warp_fused_kernel"],
            "fused_noise_blend": launched["noise_blend_f32_kernel"]}


def swap_remat_jitter(dev, launches, card: str, swap_run: dict,
                      graph_rates: dict) -> dict:
    """16e: the deep-fake pair at 448^2, 16 per identity, swap mode, with
    jitter on and ``remat: dots``, K = 8, 2 groups; imgs/s beside 12c's
    swap rate. Returns the launch counts."""
    trainer = make_deep_fake(dev, dict(DENOISE_YML, **SWAP_YML),
                             color_jitter=JITTER, remat="dots")
    states = trainer.init_states(seed=SEED)
    out = graph_rate(dev, launches, card, "16e deep-fake swap 448^2, 16 per "
                     "identity, jitter + remat dots", trainer, states, 2, 8,
                     swap_run, {k: 2 * v for k, v in FUSED.items()},
                     phase="16e")
    log(f"  16e {out['imgs_s']:.1f} imgs/s beside 12c's swap K = 8 "
        f"{graph_rates['graph_deep_fake_swap_448']:.1f} (peak "
        f"{out['peak_gb']:.2f} GB) [{card}]")
    return out["counts"]


def jitter_remat_profile(root: Path, codec_root: Path, dev, launches,
                         card: str, runs: dict, graph_rates: dict) -> dict:
    """Phase 16. Returns the launch counts by path."""
    t0 = t = time.perf_counter()

    def took(what):
        nonlocal t
        log(f"  {what} took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()

    log("[16a] color jitter on the card: 448^2 x16, card against CPU")
    jitter_on_card(dev, card)
    log("[16b] remat and jitter at 64^2 x2: policies bit-equal, a K = 3 "
        "graph, shear and hybrid")
    counts = remat_references(dev, launches)
    took("16a and 16b")
    log("[16c] remat and jitter at full width")
    full, _ = remat_full_width(dev, launches, card, runs["twopass"])
    counts.update(full)
    took("16c")
    log("[16d] the CLI's profile --report")
    counts["profile_cli_448"] = profile_cli(root, codec_root, dev, card)
    took("16d")
    log("[16e] deep-fake swap with jitter and remat dots, K = 8")
    counts["graph_swap_remat_jitter_448"] = swap_remat_jitter(
        dev, launches, card, runs["swap"], graph_rates)
    took("16e")
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# ---------------------- phase 17: the eight other families, the warp routes

# 17a: one name a family (vgg11 has conv biases and no BN), GPU vs CPU;
# 17b steps all but vgg11 and takes one forward of each other name.
FAMILIES_SMALL = ("vgg11", "vgg16_bn", "densenet121", "se_resnext50_32x4d",
                  "mobilenet_v2", "xception", "inceptionv4",
                  "inceptionresnetv2", "dpn68b")
FAMILIES_STEPPED = FAMILIES_SMALL[1:]
FAMILIES_FORWARD = tuple(
    n for n in PARAM_COUNTS if n not in FAMILIES_STEPPED
    and n not in FAMILY_STEPPED + FAMILY_FORWARD + ("resnet34",)
    and not n.startswith("efficientnet"))


def family_checkpoints(root: Path, data: dict, dev, card: str,
                       cases=(("densenet121", True), ("dpn68b", False)),
                       tag: str = "17c") -> None:
    """Phase 17c (18d): a reference .ckpt of a densenet121 pair in swap
    mode and one of a dpn68b pair in denoise mode (each of ``cases``, a
    name and whether it has shadows), each imported, its 448^2 x16
    swap batch on the card bit-equal to the .ckpt's weights loaded
    straight, exported, and imported again bit-equal to the import."""
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
        export_reference_checkpoint)
    from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
        import_reference_checkpoint)

    root.mkdir(parents=True, exist_ok=True)
    base = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dict(DENOISE_YML, **SWAP_YML).items()}
    base.update(data_path_a=str(data["a"]), data_path_b=str(data["b"]))
    for name, with_ema in cases:
        hparams = dict(base, encoder_name=name,
                       **({} if with_ema else {"mode": "denoise"}))
        ckpt = root / f"reference_{name}.ckpt"
        sd = reference_ckpt(ckpt, name, hparams, with_ema=with_ema)
        t0 = time.perf_counter()
        imported = import_reference_checkpoint(
            ckpt, root / f"imported_{name}").parent
        import_s = time.perf_counter() - t0
        prefix = "ema_model_a.ema_model." if with_ema else "model_a."
        ms = swap_batch_check(imported, sd, prefix, name, dev,
                              use_ema=with_ema)
        out = root / f"exported_{name}.ckpt"
        t0 = time.perf_counter()
        export_reference_checkpoint(imported, out)
        export_s = time.perf_counter() - t0
        exported = torch.load(out, map_location="cpu",
                              weights_only=False)["state_dict"]
        want_keys = {k for k in sd if not k.startswith("criterion.")}
        check(set(exported) == want_keys, f"{tag} {name}: the exported keys "
              f"are not the .ckpt's less criterion.*: "
              f"{sorted(set(exported) ^ want_keys)[:6]}")
        bad = [k for k, v in sd.items() if k in exported
               and v.is_floating_point() and not torch.equal(exported[k], v)]
        check(not bad, f"{tag} {name}: exported tensors differ from the "
              f".ckpt's: {bad[:4]}")
        again = import_reference_checkpoint(out, root / f"again_{name}"
                                            ).parent
        parts = ["model"] + (["ema_model"] if with_ema else [])
        first, second = CheckpointManager(imported), CheckpointManager(again)
        for ident in "ab":
            want = first.restore_partial(ident, parts, device="cpu")
            got = second.restore_partial(ident, parts, device="cpu")
            for part in parts:
                diff = [k for k in want[part] if not torch.equal(
                    got[part][k], want[part][k])]
                check(got[part].keys() == want[part].keys() and not diff,
                      f"{tag} {name} {ident} {part}: export + import differs "
                      f"from the import at {diff[:4]}")
        log(f"  {tag} {name} ({'swap' if with_ema else 'denoise'} mode, "
            f"{ckpt.stat().st_size / 1e6:.1f} MB .ckpt): imported in "
            f"{import_s:.2f} s; its 448^2 x16 swap batch ({ms:.1f} ms, "
            f"first call) bit-equal to the .ckpt's weights loaded straight; "
            f"exported in {export_s:.2f} s, every tensor the .ckpt's; "
            f"imported again, every model{' and shadow' if with_ema else ''}"
            f" tensor bit-equal to the first import [{card}]")


def warp_routes(dev, launches, card: str) -> None:
    """Phase 17d: the auto route's cost at sizes where it now takes JAX's
    route: ``hybrid`` against the two-pass kernels at 256^2 x16 and
    ``shear`` against ``gather`` at 100^2 x16 (fp32 out of uint8, 20
    back-to-back calls each after 3), with the launches of each and the
    outputs' difference."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, augment_batch, sample_affine_params,
        select_warp_method)

    cfg = AffineAugmentConfig.random_affine()
    for size, route, other in ((256, "hybrid", "pallas"),
                               (100, "shear", "gather")):
        check(select_warp_method(size, size, cfg) == route,
              f"17d: auto at {size}^2 is not {route}")
        u8 = torch.randint(0, 256, (16, size, size, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(size)
                           ).to(dev)
        params = {k: v.to(dev) for k, v in sample_affine_params(
            16, cfg, generator=torch.Generator().manual_seed(size + 1)
        ).items()}
        outs, ms, counts = {}, {}, {}
        for method in (route, other):
            def run(method=method):
                return augment_batch(u8, *HALF, cfg, params=params,
                                     method=method)

            torch.cuda.synchronize()
            launches.clear()
            outs[method] = run()
            torch.cuda.synchronize()
            counts[method] = dict(launches)
            ms[method] = time_ms(run, iters=20, warmup=3)
        auto = augment_batch(u8, *HALF, cfg, params=params)
        check(torch.equal(auto, outs[route]), f"17d: auto at {size}^2 is "
              f"not the {route} output")
        check(counts[route] == {} and (other != "pallas" or counts[other]
                                       == {"warp_axis_pass": 2}),
              f"17d launches at {size}^2: {counts}")
        check(all(torch.isfinite(o).all().item() for o in outs.values()),
              f"17d: a route's output at {size}^2 is not finite")
        diff = (outs[route] - outs[other]).abs()
        log(f"  17d {size}^2 x16 uint8 -> fp32: {route} (auto) "
            f"{ms[route]:.4f} ms, {other} {ms[other]:.4f} ms "
            f"({ms[route] / ms[other]:.2f}x); launches {counts}; outputs "
            f"differ by max {diff.max().item():.4f}, mean "
            f"{diff.mean().item():.2e} [{card}]")


def other_families(root: Path, data: dict, dev, launches, card: str,
                   main_run: dict) -> dict:
    """Phase 17: 17a one name a family's 64^2 fp32 step on the GPU against
    the CPU, 17b the stepped names' full-width rates and every other
    name's forward, 17c reference checkpoints of two families in and out,
    17d the warp routes. Returns the launch counts by path."""
    t0 = time.perf_counter()
    log("[17a] one name a family: 64^2 fp32 steps, GPU vs CPU")
    for name in FAMILIES_SMALL:
        small_reference(dev, encoder=name)
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log("[17b] the families at full width: 448^2 x16 bf16")
    counts = family_full_width(dev, launches, card, main_run,
                               stepped=FAMILIES_STEPPED,
                               forward=FAMILIES_FORWARD, tag="17b")
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log("[17c] densenet121 and dpn68b .ckpt files in and out")
    family_checkpoints(root, data, dev, card)
    log("[17d] the auto warp route below 384^2: hybrid and shear")
    warp_routes(dev, launches, card)
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# --------- phase 18: EfficientNet with stochastic depth, the patchified U-Net

EFFICIENTNET_STEPPED = ("efficientnet-b0", "efficientnet-b4",
                        "efficientnet-b7")
B0 = "efficientnet-b0"


def _drop_trainers(dev) -> dict:
    """Phase 18b's cases: 64^2 x2 efficientnet-b0 fp32 trainers with
    ``remat: dots`` (the balancer has no remat) and an epoch a step, as
    12b's; each ``(make, init, batches a step, launches a step, its
    module)``."""
    small = dict(batch_size=2, encoder_name=B0, compute_dtype="float32",
                 image_size=64, remat="dots")

    def epoch_a_step(trainer):
        trainer.steps_per_epoch = 1
        return trainer

    return {
        "denoiser": (lambda: epoch_a_step(make_trainer(
            dev, encoder=B0, batch=2, size=64, dtype="float32",
            remat="dots")), lambda t: t.init_state(seed=SEED), 1,
            {"fused_noise_blend": 1}, "denoiser"),
        "balancer": (lambda: make_balancer(dev, **small),
                     lambda t: t.init_state(seed=SEED), 1,
                     {"fused_normalise_noise_blend": 1}, "balance"),
        "deep_fake_swap": (lambda: epoch_a_step(make_deep_fake(
            dev, dict(DENOISE_YML, **SWAP_YML), ema_update_after_step=2,
            **small)), lambda t: t.init_states(seed=SEED), 2,
            {"fused_noise_blend": 2}, "deep_fake"),
    }


@contextlib.contextmanager
def drawn_masks(module: str, out: list):
    """Records every ``draw_drop_masks`` of a trainer module."""
    import importlib

    mod = importlib.import_module(
        f"denoising_diffusion_deep_fake_tpu_torch.training.{module}")
    draw = mod.draw_drop_masks

    def record(*args):
        out.append(draw(*args))
        return out[-1]

    mod.draw_drop_masks = record
    try:
        yield out
    finally:
        mod.draw_drop_masks = draw


def drop_graphs(dev, launches) -> dict:
    """Phase 18b: at 64^2 x2, efficientnet-b0 (stochastic depth on, the
    masks drawn from each trainer's generator), fp32, ``remat: dots``,
    under cudnn.deterministic: 2 replays of a K = 3 graph against 6 eager
    steps, for the denoiser, the balancer and the deep-fake swap pair:
    every tensor, counter, loss and the generator bit-equal (12b's
    check). Returns the launch counts of the replays by path."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    rng = np.random.default_rng(SEED + 43)
    counts = {}
    try:
        for what, (make, init, n_args, per_step, module) in _drop_trainers(
                dev).items():
            eager_t, graph_t = make(), make()
            eager_s, graph_s = init(eager_t), init(graph_t)
            check(eager_t.drop_keep is not None
                  and eager_t.generator is not None,
                  f"18b {what}: no drop masks to draw")
            steps = [[torch.from_numpy(rng.integers(
                0, 256, (2, 64, 64, 3), np.uint8)).to(dev)
                for _ in range(n_args)] for _ in range(6)]
            with drawn_masks(module, []) as masks:
                eager = _run_eager(eager_t, eager_s, steps)
            dropped = sum(int((~m).sum()) for m in masks)
            check(len(masks) == 6 * n_args and dropped > 0,
                  f"18b {what}: {len(masks)} mask draws, {dropped} drops")
            step = graph_t.make_super_step(3)
            torch.cuda.synchronize()
            launches.clear()
            groups = [step(graph_s, *_k_flat(steps[i:i + 3]))
                      for i in (0, 3)]
            torch.cuda.synchronize()
            counts[f"graph_{what}_efficientnet_64"] = dict(launches)
            check_launches(counts[f"graph_{what}_efficientnet_64"],
                           {k: 6 * v for k, v in per_step.items()},
                           f"18b {what}")
            check(step.captures == 1, f"{what}: {step.captures} captures")
            _check_same(f"18b {what}", graph_t, graph_s, eager_t, eager_s,
                        groups, eager)
            log(f"  {what}: efficientnet-b0 with stochastic depth "
                f"({len(masks)} draws of {tuple(masks[0].shape)} masks in "
                f"the eager steps, {dropped} block x sample drops), remat "
                "dots: 2 replays of K = 3 bit-equal to 6 eager steps "
                "(weights, BN buffers, Adam, losses, counters, generator); "
                f"launches {counts[f'graph_{what}_efficientnet_64']}")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return counts


def efficientnet_full_width(dev, launches, card: str, main_run: dict,
                            peaks: dict | None = None) -> dict:
    """Phase 18c: the denoiser at 448^2 x16 bf16 eager with
    efficientnet-b0, b4 and b7 (stochastic depth on) and resnet34 with
    ``patchify_stem: 2`` (2 warm-up and 5 timed steps, one fused warp
    and one fp32 noise launch a step, a profile of 3 more with its cuDNN
    layout conversions, peak memory), and b0 and the patchified resnet34
    at K = 16, beside phase 5's rate. Returns the launch counts by path;
    ``peaks`` gets each run's peak memory above what was held before it,
    by path."""
    counts = {}
    rows = [f"resnet34 (phase 5) {16 / main_run['step_ms'] * 1e3:.1f} "
            f"imgs/s"]
    cases = [(name, {}) for name in EFFICIENTNET_STEPPED]
    cases.append(("resnet34", {"patchify_stem": 2}))
    for name, overrides in cases:
        run, row = stepped_full_width(dev, launches, card, name,
                                      **overrides)
        plane = run.get("plane", {})
        layout = plane.get("layout_conversions")
        row += (f", cuDNN layout conversions {layout['per_step']:.1f} a "
                f"step ({layout['ms_per_step']:.3f} ms)" if layout
                else ", layout conversions not measured")
        key = (f"{name.replace('-', '_')}_448" if not overrides
               else f"patchify2_{name}_448")
        counts[key] = run["counts"]
        if peaks is not None:
            peaks[key] = run["own_peak_gb"]
        rows.append(row)
        if name == B0:
            check(run["trainer"].drop_keep is not None,
                  "efficientnet-b0 trains without stochastic depth")
        if name == B0 or overrides:
            # Eager, both are host-bound: their K = 16 graph's rate.
            label = name + "".join(f" {k}={v}" for k, v in overrides.items())
            graph = graph_rate(
                dev, launches, card, f"{label} denoiser", run["trainer"],
                run["state"], 1, 16, run,
                {"affine_warp_fused": 1, "fused_noise_blend": 1},
                phase="18c")
            counts[f"graph_{key}"] = graph["counts"]
            rows.append(f"{label} K = 16 {graph['imgs_s']:.1f} imgs/s "
                        f"(kernels {graph['busy_ms']:.3f} ms a step)")
        del run
        torch.cuda.empty_cache()
    log(f"  18c 448^2 x16 bf16 denoiser: {'; '.join(rows)} [{card}]")
    return counts


def batch_slot_check(ckpt: Path, dev, card: str) -> None:
    """Phase 18f, a measurement: does ``cudnn.deterministic`` (set only
    here) make a 448^2 single-pass frame's bits independent of its slot in
    a batch of 8, on 8d's weights (model a)? Eight frames are swapped in
    order, rolled by 3 and with frame 0 among 7 others in slot 5, under
    cuDNN's default and deterministic modes; the frames' largest LSB
    difference and the ms a batch (CUDA events, mean of 20) of each."""
    from denoising_diffusion_deep_fake_tpu_torch.inference import (
        load_swap_model, make_device_pipeline)

    pipe = make_device_pipeline(load_swap_model(ckpt, "a", device=dev))
    rng = np.random.default_rng(SEED + 44)
    frames = torch.from_numpy(rng.integers(
        0, 256, (15, 448, 448, 3), np.uint8)).to(dev)
    base = frames[:8]
    rolled = torch.roll(base, 3, dims=0)
    mixed = torch.cat([frames[8:13], base[:1], frames[13:15]])
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    rows = []
    try:
        for deterministic in (False, True):
            cudnn.deterministic = deterministic
            a = pipe(base, 0)
            b = torch.roll(pipe(rolled, 0), -3, dims=0)
            c = pipe(mixed, 0)[5]
            again = pipe(base, 0)
            diff_roll = (a.int() - b.int()).abs()
            diff_mix = (a[0].int() - c.int()).abs()
            frames_moved = int((diff_roll.flatten(1).amax(1) > 0).sum())
            ms = time_ms(lambda: pipe(base, 0), iters=20, warmup=3)
            rows.append(
                f"deterministic={deterministic}: rolled by 3, "
                f"{frames_moved}/8 frames differ, max "
                f"{int(diff_roll.max())} LSB ({int((diff_roll > 0).sum())} "
                f"values); frame 0 in slot 5 among others max "
                f"{int(diff_mix.max())} LSB; the same batch again "
                f"{'bit-equal' if torch.equal(a, again) else 'DIFFERS'}; "
                f"{ms:.3f} ms a batch of 8")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    log(f"  18f batch slot, 448^2 x8 single-pass, 8d's model a, bf16: "
        f"{'; '.join(rows)} [{card}]")


def efficientnet_and_patchify(root: Path, data: dict, dev, launches,
                              card: str, main_run: dict, ckpt: Path,
                              peaks: dict | None = None) -> dict:
    """Phase 18: 18a 64^2 fp32 steps on the GPU against the CPU
    (efficientnet-b0 with injected drop masks, resnet18 patchified), 18b
    K-step graphs against eager steps with drop on, 18c full-width
    rates, 18d the eight names' eval forwards and a b4 .ckpt round trip,
    18e the balancer with b0, 18f the batch-slot measurement on ``ckpt``
    (8d's states). Returns the launch counts by path (18c's peaks into
    ``peaks``)."""
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        EFFICIENTNET_NAMES)

    t0 = time.perf_counter()
    log("[18a] 64^2 fp32 steps, GPU vs CPU: efficientnet-b0 with drop "
        "masks, resnet18 with patchify_stem 2")
    small_reference(dev, encoder=B0)
    small_reference(dev, encoder="resnet18", patchify_stem=2)
    log("[18b] K = 3 graphs against eager steps with stochastic depth: "
        "64^2 x2 efficientnet-b0, remat dots")
    counts = drop_graphs(dev, launches)
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log("[18c] 448^2 x16 bf16 denoiser: efficientnet-b0/b4/b7, b0 at K = "
        "16, resnet34 patchify_stem 2")
    counts.update(efficientnet_full_width(dev, launches, card, main_run,
                                          peaks))
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log("[18d] eval forwards of the eight names at 448^2 x16 bf16; an "
        "efficientnet-b4 .ckpt in and out")
    family_full_width(dev, launches, card, main_run, stepped=(),
                      forward=EFFICIENTNET_NAMES, tag="18d")
    family_checkpoints(root, data, dev, card,
                       cases=(("efficientnet-b4", True),), tag="18d")
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log("[18e] balancer: 448^2 x12 efficientnet-b0")
    run = drive(dev, launches, card, single_path(
        make_balancer(dev, encoder_name=B0), size=448, batch=12),
        warmup=3, steps=10, per_step={"fused_normalise_noise_blend": 1})
    check(run["trainer"].generator is not None,
          "the efficientnet-b0 balancer draws no drop masks")
    profile_steps(run, dev, None)
    counts["balancer_efficientnet_b0_448"] = run["counts"]
    log(f"  18e balancer efficientnet-b0 448^2 x12: "
        f"{12 / run['step_ms'] * 1e3:.1f} imgs/s, peak "
        f"{run['peak_gb']:.2f} GB [{card}]")
    del run
    torch.cuda.empty_cache()
    log("[18f] a served frame's bits against its batch slot, cuDNN default "
        "and deterministic")
    batch_slot_check(ckpt, dev, card)
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# ---------------------------------------- phase 19: data parallelism


DP_BATCH, DP_SIZE = 4, 64


def noise_element_base(dev, card: str) -> None:
    """Phase 19a: both noise kernels, by value and by device offset, on
    rows ``[lb:]`` of a batch at ``element_base = lb * H * W * C`` (a
    data-parallel rank's launch), against those rows of the launch on the
    whole batch: Philox words and outputs bit-equal, and within one ulp of
    the plain version; a launch at base 0 bit-equal to one without a base.
    At 448^2 x16 the base is a multiple of 4; at 45^2 x6 (lb 3) it is not,
    and the rank's first Philox group starts in the rows before it."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        moved_launches)

    rng = np.random.default_rng(SEED + 90)
    seed, offset = 12345, (1 << 33) + 5
    with moved_launches():
        for shape in ((16, 448, 448, 3), (6, 45, 45, 3)):
            b, lb = shape[0], shape[0] // 2
            base = lb * shape[1] * shape[2] * shape[3]
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
            u8 = torch.from_numpy(rng.integers(0, 256, shape,
                                               np.uint8)).to(dev)
            ratios = torch.from_numpy(rng.uniform(0, 1, b).astype(
                np.float32)).to(dev)
            at = torch.tensor([offset], dtype=torch.int64, device=dev)
            groups = (x.numel() + 3) // 4
            for form, off in (("by value", offset), ("device offset", at)):
                words = nk.philox_words(groups, seed=seed, offset=off,
                                        device=dev)
                tail = nk.philox_words(groups - base // 4, seed=seed,
                                       offset=off, device=dev,
                                       group_base=base // 4)
                check(torch.equal(tail, words[base // 4:]),
                      f"19a {shape} {form}: Philox words from the group "
                      "base differ from the whole launch's")
                launches = {
                    "fused_noise_blend": lambda xs, rs, **kw:
                        nk.fused_noise_blend(xs, rs, seed=seed, **kw),
                    "fused_normalise_noise_blend": lambda xs, rs, **kw:
                        nk.fused_normalise_noise_blend(
                            xs, rs, *HALF, seed=seed, **kw)}
                for name, fn in launches.items():
                    src = x if name == "fused_noise_blend" else u8
                    whole = fn(src, ratios, offset=off)
                    zero = fn(src, ratios, offset=off, element_base=0)
                    part = fn(src[lb:], ratios[lb:], offset=off,
                              element_base=base)
                    torch.cuda.synchronize()
                    check(torch.equal(zero, whole),
                          f"19a {name} {shape} {form}: base 0 changed the "
                          "launch")
                    check(torch.equal(part, whole[lb:]),
                          f"19a {name} {shape} {form}: rows [{lb}:] at "
                          f"their base differ from the whole launch's")
                    if name == "fused_noise_blend":
                        plain = nk.fused_noise_blend_plain(
                            src[lb:], ratios[lb:], seed=seed, offset=offset,
                            element_base=base)
                    else:
                        plain = nk.fused_normalise_noise_blend_plain(
                            src[lb:], ratios[lb:],
                            nk.noise_constants(*HALF, 3), seed=seed,
                            offset=offset, element_base=base)
                    compare_ulp(part, plain, f"19a {name} {shape} rows "
                                f"[{lb}:] at base {base} (base % 4 = "
                                f"{base % 4}), {form}")
    log(f"  both noise kernels: a rank's rows at their element base "
        f"bit-equal to the whole launch's, Philox words too, by value and "
        f"device offset [{card}]")


def _dp_trainer(workload: str, dev, batch: int = DP_BATCH,
                size: int = DP_SIZE, **extra):
    """Phase 19c's trainers: 64^2, a global batch of 4, resnet18, fp32
    (20b's and 21b's at their own batch, size and knobs in ``extra``, the
    encoder too)."""
    common = dict(dict(batch_size=batch, image_size=size,
                       learning_rate=1e-3, encoder_name="resnet18",
                       compute_dtype="float32"), **extra)
    if workload == "swap":
        return make_deep_fake(dev, None, mode="swap",
                              ema_update_after_step=0, **common)
    if workload == "balance":
        return make_balancer(dev, **common)
    extra = dict(extra)
    return make_trainer(dev, encoder=extra.pop("encoder_name", "resnet18"),
                        batch=batch, size=size, dtype="float32", **extra)


def _dp_step(workload: str, dev, rows, batch: int = DP_BATCH,
             size: int = DP_SIZE, to_host: bool = True, **extra) -> dict:
    """One step of ``workload`` from seed-made weights, the U-Nets in
    float64 (fp32 gradients of a 64^2 U-Net are too ill-conditioned for
    1e-5: a decoder BN's bias gradient is a sum that nearly cancels),
    on ``rows(global batch, trainer)``; every tensor after it, by name,
    on the host (where it is, without ``to_host``)."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_state)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        model_states)

    trainer = _dp_trainer(workload, dev, batch, size, **extra)
    states = (trainer.init_states(seed=SEED) if workload == "swap"
              else trainer.init_state(seed=SEED))
    for state in model_states(states):
        for model in (state.model, state.ema_model):
            if model is not None:
                model.double().dtype = torch.float64
            if hasattr(model, "unet"):   # patchified: the inner U-Net too
                model.unet.dtype = torch.float64
    shard_state(states, trainer.mesh)
    rng = np.random.default_rng(SEED + 91)
    batches = [rows(torch.from_numpy(rng.integers(
        0, 256, (batch, size, size, 3), np.uint8)), trainer)
        for _ in range(2 if workload == "swap" else 1)]
    metrics = trainer.train_step(states, *batches)
    out = {f"metric.{k}": float(v) for k, v in metrics.items()
           if isinstance(v, torch.Tensor)}
    out["lr"] = trainer.cfg.learning_rate
    for i, state in enumerate(model_states(states)):
        for name, t in state.model.state_dict().items():
            out[f"{i}.model.{name}"] = t
        if state.has_ema:
            for name, t in state.ema_model.state_dict().items():
                out[f"{i}.shadow.{name}"] = t
        for name, p in state.model.named_parameters():
            out[f"{i}.grad.{name}"] = p.grad
            for k, v in state.optimizer.state[p].items():
                if k != "step":
                    out[f"{i}.adam_{k}.{name}"] = v
    if to_host:
        out = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in out.items()}
    return out


def _dp_compare(what: str, dp: dict, one: dict, phase: str = "19c",
                ranks: str = "2 ranks (gloo)") -> None:
    """19c (20b): a 2-rank step against the one-process step (the CPU
    test's tolerances): the losses 1e-5 relative; BN buffers, gradients,
    Adam moments and shadows' buffers 1e-5 of each tensor's largest;
    weights (and shadows' weights) 1e-6 where the gradient is above 2% of
    its tensor's largest and 1e-6, 2 lr + 1e-6 elsewhere (Adam's first
    step moves a weight by about +-lr whatever |g|)."""
    what = f"{phase} {what}"
    check(set(dp) == set(one), f"{what}: other tensors")
    worst, lr = 0.0, one["lr"]
    for k, want in one.items():
        got = dp[k]
        if k == "lr":
            continue
        if k.startswith("metric."):
            check(abs(got - want) <= 1e-5 * abs(want),
                  f"{what} {k}: {got} against {want}")
            continue
        identity, kind, name = k.split(".", 2)
        diff = (got.double() - want.double()).abs()
        if kind in ("model", "shadow") and "running_" not in name:
            grad = one[f"{identity}.grad.{name}"].double().abs()
            clear = (grad > 2e-2 * grad.max()) & (grad > 1e-6)
            check(float(diff.max()) <= 2 * lr + 1e-6 and (
                not clear.any() or float(diff[clear].max()) <= 1e-6),
                f"{what} {k}: a weight moved apart")
            continue
        scale = float(want.double().abs().max())
        err = float(diff.max())
        if scale > 1e-10:   # else rounding noise, held at 1e-12 below
            worst = max(worst, err / scale)
        check(err <= 1e-5 * scale + 1e-12,
              f"{what} {k}: {err} against {scale}")
    log(f"  {what}: {ranks} against one process on the card: "
        f"losses within 1e-5, BN buffers, gradients, Adam moments and "
        f"shadows within {worst:.2e} of their largest (those of rounding "
        f"noise, below 1e-10, within 1e-12)")


def _dp_worker_gloo(workdir: Path, card: str) -> None:
    """19c, one of two ranks on the one card over gloo: the three steps,
    the K-step graph's refusal, and ``fit_denoiser`` from the cache."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.device import (
        resolve_device)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        LAUNCHES)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import (
        distributed)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    check(distributed.maybe_initialize_from_env(backend="gloo"),
          "19c: no D3F_* launch environment")
    rank = distributed.process_index()
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    dev = resolve_device()
    out = {"counts": {}}
    for workload in ("denoiser", "swap", "balance"):
        LAUNCHES.clear()
        out[workload] = _dp_step(workload, dev, lambda b, t: shard_batch(
            b, t.mesh).to(dev))
        torch.cuda.synchronize()
        out["counts"][f"dp_gloo_{workload}_64"] = dict(LAUNCHES)
    trainer = _dp_trainer("denoiser", dev)
    state = trainer.init_state(seed=SEED)
    u8 = torch.zeros((DP_BATCH // 2, DP_SIZE, DP_SIZE, 3), dtype=torch.uint8,
                     device=dev)
    try:
        trainer.make_super_step(2)(state, u8, u8)
        out["graph_refused"] = False
    except RuntimeError as e:
        out["graph_refused"] = "gloo" in str(e)
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(workdir / "frames_64" / "images.txt"),
        batch_size=DP_BATCH, image_size=DP_SIZE, encoder_name="resnet18",
        compute_dtype="float32", max_epochs=3, data_cache="device",
        log_images=False, seed=SEED, log_dir=str(workdir / "runs"),
        checkpoint_dir=str(workdir / "ck")))
    LAUNCHES.clear()
    state, trainer, ctx = fit_denoiser(cfg, max_steps=4, verbose=False,
                                       decode_fn=np.load)
    torch.cuda.synchronize()
    out["counts"]["dp_gloo_cache_fit_denoiser_64"] = dict(LAUNCHES)
    out["fit"] = {"step": state.step, "world": trainer.mesh.world,
                  "backend": torch.distributed.get_backend(),
                  "weights": [t.cpu() for t in
                              state.model.state_dict().values()]}
    torch.save(out, workdir / f"gloo_rank{rank}.pt")
    distributed.shutdown()


def _dp_worker_nccl(workdir: Path, data: Path, card: str) -> None:
    """19b, one rank over NCCL: ``fit_denoiser`` at full width from the
    ``D3F_*`` launch (which opens the group) eager and at K = 16, the same
    trainer driven and profiled, its K = 16 graph, the step's census, and
    12b's 64^2 K = 3 graphs against eager steps, all inside the group."""
    import torch.distributed as dist

    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        LAUNCHES)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_of_train_step, census_summary, census_violations)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    fused = {"affine_warp_fused": 1, "fused_noise_blend": 1}
    out = {"counts": {}, "rates": {}}
    for k in (1, 16):
        cfg = config_from_dict(DenoiserConfig, dict(
            input_image_list_path=str(data), batch_size=16,
            learning_rate=0.02, max_epochs=2, cosine_scheduler_max_epoch=100,
            encoder_name="resnet34", noise_exponential_sampling_lambda=5,
            compute_dtype="bfloat16", image_size=448, seed=SEED,
            steps_per_call=k, data_cache="device", log_images=False,
            log_dir=str(workdir / f"runs_{k}"),
            checkpoint_dir=str(workdir / f"ck_{k}")))
        ends = {}

        def at_epoch_end(step, states, metrics):
            if step in (16, 32):
                torch.cuda.synchronize()
                ends[step] = time.perf_counter()

        LAUNCHES.clear()
        state, trainer, ctx = fit_denoiser(cfg, verbose=False,
                                           decode_fn=np.load,
                                           step_callback=at_epoch_end)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        check(dist.is_initialized() and dist.get_backend() == "nccl"
              and trainer.mesh.world == 1 and trainer.mesh.in_group,
              "19b: fit_denoiser did not run in an NCCL group of 1")
        check_launches(counts, {n: 32 * v for n, v in fused.items()},
                       f"19b fit_denoiser K = {k}")
        rate = 16 * 16 / (ends[32] - ends[16])
        out["rates"][f"fit_{k}"] = rate
        out["counts"][f"dp_nccl_{'graph_' if k > 1 else ''}"
                      f"fit_denoiser_448"] = counts
        log(f"  19b fit_denoiser 448^2 x16 resnet34 bf16 from the cache, "
            f"NCCL world size 1, K = {k}: {rate:.1f} imgs/s over epoch 2 "
            f"(16 steps; host clock between synchronised epoch ends) "
            f"[{card}]")
        shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    dev = trainer.device
    run = drive(dev, LAUNCHES, card, single_path(make_trainer(
        dev, encoder="resnet34", batch=16, size=448, dtype="bfloat16"),
        size=448, batch=16), warmup=3, steps=10, per_step=fused)
    out["counts"]["dp_nccl_denoiser_448"] = run["counts"]
    port_ms = profile_steps(run, dev, None)
    out["step_ms"], out["busy_ms"] = run["step_ms"], run["busy_ms"]
    out["port_ms"] = port_ms
    graph = graph_rate(dev, LAUNCHES, card, "19b denoiser 448^2 x16 in an "
                       "NCCL group", run["trainer"], run["state"], 1, 16,
                       run, fused, phase="19b")
    out["counts"]["dp_nccl_graph_denoiser_448"] = graph["counts"]
    out["rates"]["graph"] = graph["imgs_s"]
    census = census_of_train_step("denoiser", image_size=448, batch_size=16,
                                  encoder_name="resnet34",
                                  compute_dtype="bfloat16")
    out["census"] = census_summary(census)
    check(not census_violations(census, spatial=False),
          f"19b census: {census_violations(census, spatial=False)}")
    # The host's cost of one collective (a BN's statistics' size).
    t = torch.zeros(1024, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(t)
    out["all_reduce_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    out["all_reduce_us"] = (time.perf_counter() - t0) / 200 * 1e6
    log("[19b] 12b's 64^2 K = 3 graphs of the denoiser and the swap pair "
        "against eager steps inside the NCCL group")
    out["counts"].update({f"dp_nccl_{k}": v for k, v in graph_against_eager(
        dev, LAUNCHES, ("denoiser", "deep_fake_swap")).items()})
    (workdir / "nccl.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_ranks(mode: str, workdir: Path, world: int, extra=(),
                  timeout_s: float = 300) -> None:
    """Start ``world`` ranks of this script's ``--dp-worker mode`` with the
    ``D3F_*`` launch environment, wait for all (stopping every one at the
    first failure or the timeout) and fail unless each exits 0."""
    import os

    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-worker", mode,
         str(workdir), *map(str, extra)],
        env=dict(os.environ, D3F_COORDINATOR=coordinator,
                 D3F_NUM_PROCESSES=str(world), D3F_PROCESS_ID=str(r)))
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            check(time.monotonic() < deadline,
                  f"19 {mode}: the ranks did not finish in {timeout_s} s")
            check(all(p.returncode in (None, 0) for p in procs),
                  f"19 {mode}: a rank failed "
                  f"({[p.returncode for p in procs]})")
            time.sleep(0.2)
        check(all(p.returncode == 0 for p in procs),
              f"19 {mode}: a rank failed ({[p.returncode for p in procs]})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def data_parallel(root: Path, data: Path, dev, launches, card: str,
                  main_run: dict, graph_rates: dict, npy_rates: dict
                  ) -> dict:
    """Phase 19: 19a the noise kernels' element base; 19b one rank over
    NCCL at full width; 19c two ranks on the one card over gloo against
    the one-process step. Returns the launch counts by path."""
    t19 = time.perf_counter()
    log("[19a] the noise kernels' global element base")
    noise_element_base(dev, card)
    log(f"    ({time.perf_counter() - t19:.1f} s)")

    log("[19b] data parallelism over NCCL, world size 1, from the D3F_* "
        "launch: fit_denoiser 448^2 x16 eager and K = 16")
    root.mkdir(parents=True, exist_ok=True)
    if not data.exists():
        data = write_frames(root / "frames_256", 256, 448, SEED + 60)
    t0 = time.perf_counter()
    _launch_ranks("nccl", root, 1, extra=(data,), timeout_s=400)
    nccl = json.loads((root / "nccl.json").read_text())
    main_rate = 16 / main_run["step_ms"] * 1e3
    log(f"  19b rates, imgs/s: fit_denoiser eager {nccl['rates']['fit_1']:.1f}"
        f" and K = 16 {nccl['rates']['fit_16']:.1f} (phase 13b's cached "
        f"fit_denoiser without a group: eager "
        f"{npy_rates.get('denoiser_device_1') or 0:.1f}, K = 16 "
        f"{npy_rates.get('denoiser_device_16') or 0:.1f}); the trainer "
        f"driven {16 / nccl['step_ms'] * 1e3:.1f} beside phase 5's "
        f"{main_rate:.1f}; its K = 16 graph {nccl['rates']['graph']:.1f} "
        f"beside 12c's {graph_rates['graph_denoiser_448']:.1f} [{card}]")
    busy = nccl["busy_ms"]
    log(f"  19b kernels {busy:.3f} ms a step, device idle "
        f"{1 - busy / nccl['step_ms']:.1%} of the eager step"
        if busy > 0 else "  19b: the profiler saw no device time")
    census = nccl["census"]
    log("  19b census of one step: " + ", ".join(
        f"{op} {c['count']} calls, {c['total_mib']:.3f} MiB (largest "
        f"{c['max_mib']:.3f})" for op, c in census.items()))
    check(census.get("all-reduce", {}).get("count", 0) > 0,
          "19b: the step issued no all-reduce")
    log(f"  19b: one NCCL all-reduce of 4 KiB costs the host "
        f"{nccl['all_reduce_host_us']:.1f} us to issue, "
        f"{nccl['all_reduce_us']:.1f} us to complete (200 in a row) [{card}]")
    log(f"    ({time.perf_counter() - t0:.1f} s)")

    log("[19c] two ranks on the one card over gloo: 64^2, a global batch "
        "of 4, resnet18, cudnn.deterministic")
    t0 = time.perf_counter()
    write_frames(root / "frames_64", 16, DP_SIZE, SEED + 92)
    _launch_ranks("gloo", root, 2, timeout_s=300)
    ranks = [torch.load(root / f"gloo_rank{r}.pt", weights_only=False)
             for r in range(2)]
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for workload in ("denoiser", "swap", "balance"):
            one = _dp_step(workload, dev, lambda b, t: b.to(dev))
            _dp_compare(workload, ranks[0][workload], one)
            check(all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                      else a == b for a, b in zip(
                          ranks[0][workload].values(),
                          ranks[1][workload].values())),
                  f"19c {workload}: the ranks' states differ")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    for r in ranks:
        check(r["graph_refused"], "19c: a K-step graph under gloo was not "
              "refused")
        check(r["fit"]["step"] == 4 and r["fit"]["world"] == 2
              and r["fit"]["backend"] == "gloo",
              f"19c fit_denoiser: {r['fit']['step']} steps")
    check(all(torch.equal(a, b) for a, b in zip(
        ranks[0]["fit"]["weights"], ranks[1]["fit"]["weights"])),
        "19c fit_denoiser: the ranks' weights differ")
    check(sorted(p.name for p in (root / "ck").iterdir())
          == ["step_0000000004"], "19c: not one checkpoint by the primary")
    check(len(list((root / "runs").rglob("events.out.tfevents.*"))) == 1,
          "19c: not one event file")
    counts = {**nccl["counts"], **ranks[0]["counts"]}
    log("  19c: fit_denoiser from the cache on both ranks, 4 steps, the "
        "same weights; one checkpoint (step 4) and one event file, by the "
        "primary; a K-step graph under gloo refused before its capture; "
        f"launches by path {ranks[0]['counts']}")
    log(f"    ({time.perf_counter() - t0:.1f} s)")
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s [{card}]")
    return counts


# ---------------------------------------- phase 20: spatial parallelism


SP_BATCH = 2
# 20c's and 20d's full width against one process: the relative L2
# distance of the first forward's output in fp32, and the first step's
# loss (bf16), relative. Readings on the H100: the fp32 forward 2.1e-5
# sound and 0.43 with every halo zero-filled (``_halo_fault``, which
# must land above the first limit in the same run); the first loss
# 5.1e-6 to 5.0e-5 sound, but a broken exchange moves an initialised
# U-Net's loss by only 0.6-1.2e-4 over 2 ranks (1e-3 over 4), so the loss
# guards the bf16 step against gross faults and the fp32 forward holds
# the exchange.
SP_PRED_LIMIT, SP_LOSS_LIMIT = 1e-3, 2e-4


@contextlib.contextmanager
def _row_share_loss(spatial: int):
    """One process's steps with a spatial run's loss arithmetic:
    ``mse_ssim_loss`` as the sum of the ``spatial`` row blocks' shares
    (``ops/losses.py``'s spatial path), each block's SSIM halo rows cut
    from the whole batch in place of an exchange. The swap pair's model b
    trains on a's post-Adam shadow, where the loss's row order alone parts
    b's gradients by up to 0.8% of a tensor's largest at lr 1e-3 (the CPU
    test's witness, ``tests/test_torch_port_spatial.py``): the spatial
    pair is held against this step."""
    from denoising_diffusion_deep_fake_tpu_torch.ops import losses, ssim
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import Mesh
    from denoising_diffusion_deep_fake_tpu_torch.training import state
    whole_loss, exchange = state.mse_ssim_loss, ssim.exchange_rows

    def shares(pred, target, *, mesh=None):
        xy = torch.cat([losses._normalise_between_zero_and_one(
            t.to(torch.float32), -1.0, 1.0) for t in (pred, target)], -1)

        def cut(x, above, below, m, *, dim, pad):
            a, n = m.spatial_index * x.shape[dim], x.shape[dim]
            lo, hi = max(a - above, 0), min(a + n + below, xy.shape[dim])
            return xy.narrow(dim, lo, hi - lo)

        n = pred.shape[1] // spatial
        ssim.exchange_rows = cut
        try:
            return sum(whole_loss(pred[:, s * n:(s + 1) * n],
                                  target[:, s * n:(s + 1) * n],
                                  mesh=Mesh(data=1, spatial=spatial, rank=s,
                                            world=spatial))
                       for s in range(spatial))
        finally:
            ssim.exchange_rows = exchange

    state.mse_ssim_loss = shares
    try:
        yield
    finally:
        state.mse_ssim_loss = whole_loss


def _halo_fault(x, above, below, mesh, *, dim, pad):
    """A broken exchange, for the sensitivity of 20c's check: every rank
    fills its halo rows as a global edge would (zeros; ``-inf`` for the
    max pool) in place of its neighbours' rows."""
    def rows(n):
        shape = list(x.shape)
        shape[dim] = n
        return x.new_full(shape, 0.0 if pad is None else pad)

    return torch.cat([rows(above), x, rows(below)], dim)


def _sp_probe_inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """20c's fixed noisy input and target, global 448^2 x16 fp32."""
    rng = np.random.default_rng(SEED + 104)
    target = rng.uniform(-1, 1, (16, 448, 448, 3)).astype(np.float32)
    noisy = (np.float32(math.sqrt(0.5)) * target + np.float32(math.sqrt(0.5))
             * rng.standard_normal(target.shape, np.float32))
    return torch.from_numpy(noisy), torch.from_numpy(target)


def _sp_prediction(state, mesh, x: torch.Tensor) -> torch.Tensor:
    """The train-mode forward of ``state``'s U-Net on ``x`` (a rank's rows
    over ``mesh``; the whole batch with None), in fp32 on the host; the
    BN running statistics are left as they were."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel import halo

    model = state.model
    saved = [b.clone() for b in model.buffers()]
    model.train()
    with torch.no_grad(), halo.row_sharded(mesh):
        pred = model(x).float().cpu()
    with torch.no_grad():
        for b, v in zip(model.buffers(), saved):
            b.copy_(v)
    return pred


# 20a's (shape, spatial axes) of the row window's checks.
ROW_WINDOWS = (((16, 448, 448, 3), (2, 4)), ((6, 45, 45, 3), (3,)))


def noise_row_window(dev, card: str, windows=ROW_WINDOWS,
                     phase: str = "20a") -> dict:
    """Phase 20a: both noise kernels, by value and by device offset, on a
    spatial rank's rows with their row window (``sample_stride``) against
    those rows of the launch on the whole batch: bit-equal, and within one
    ulp of the plain version; at 448^2 x16 over S = 2 and 4, and at 45^2
    x6 over S = 3 (W * C = 135: runs start inside a Philox group). At
    448^2 x16, S = 2, rank 1's windowed launch is timed by graph replay,
    by value and by device offset, beside one contiguous run of as many
    elements. Returns those times by kernel. ``windows`` and ``phase``:
    other shapes, for another phase."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        moved_launches)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass \
        import graph_ms

    rng = np.random.default_rng(SEED + 100)
    seed, offset = 12345, (1 << 33) + 7
    times = {}
    with moved_launches():
        for shape, spatials in windows:
            b, h, w, c = shape
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
            u8 = torch.from_numpy(rng.integers(0, 256, shape,
                                               np.uint8)).to(dev)
            ratios = torch.from_numpy(rng.uniform(0, 1, b).astype(
                np.float32)).to(dev)
            at = torch.tensor([offset], dtype=torch.int64, device=dev)
            launches = {
                "fused_noise_blend": (x, lambda xs, **kw:
                                      nk.fused_noise_blend(
                                          xs, ratios, seed=seed, **kw)),
                "fused_normalise_noise_blend": (u8, lambda xs, **kw:
                                                nk.fused_normalise_noise_blend(
                                                    xs, ratios, *HALF,
                                                    seed=seed, **kw))}
            for name, (src, fn) in launches.items():
                for form, off in (("by value", offset), ("device offset", at)):
                    whole = fn(src, offset=off)
                    for spatial in spatials:
                        n = h // spatial
                        for r in range(spatial):
                            rows = src[:, r * n:(r + 1) * n].contiguous()
                            window = dict(element_base=r * n * w * c,
                                          sample_stride=h * w * c)
                            got = fn(rows, offset=off, **window)
                            torch.cuda.synchronize()
                            check(torch.equal(got, whole[:, r * n:
                                                         (r + 1) * n]),
                                  f"{phase} {name} {shape} S = {spatial} "
                                  f"rank "
                                  f"{r} {form}: the windowed rows differ "
                                  "from the whole launch's")
                            if r == spatial - 1 and form == "by value":
                                if name == "fused_noise_blend":
                                    plain = nk.fused_noise_blend_plain(
                                        rows, ratios, seed=seed,
                                        offset=offset, **window)
                                else:
                                    plain = (
                                        nk.fused_normalise_noise_blend_plain(
                                            rows, ratios,
                                            nk.noise_constants(*HALF, 3),
                                            seed=seed, offset=offset,
                                            **window))
                                compare_ulp(got, plain, f"{phase} {name} "
                                            f"{shape} S = {spatial} rank {r}"
                                            f" (first run at element "
                                            f"{window['element_base']}, % 4 ="
                                            f" {window['element_base'] % 4})")
                if shape[1] == 448:
                    rows = src[:, h // 2:].contiguous()
                    out = torch.empty(rows.shape, dtype=torch.float32,
                                      device=dev)
                    norm = (None if name == "fused_noise_blend"
                            else nk.noise_constants(*HALF, 3))
                    window = dict(element_base=h // 2 * w * c,
                                  sample_stride=h * w * c)

                    def launch(**kw):
                        return lambda: nk.launch_blend(
                            rows, out, ratios, norm, seed=seed, **kw)

                    times[name] = {
                        "row_window_ms": graph_ms(launch(
                            offset=offset, **window)),
                        "row_window_device_offset_ms": graph_ms(launch(
                            offset=at, **window)),
                        "contiguous_ms": graph_ms(launch(offset=offset))}
                    t = times[name]
                    log(f"  {phase} {name} on rank 1's rows of 448^2 x16 "
                        f"over S = 2 (16 runs of 224 x 448 x 3, graph replay): "
                        f"windowed {t['row_window_ms']:.4f} ms by value, "
                        f"{t['row_window_device_offset_ms']:.4f} ms by "
                        f"device offset; one contiguous run of as many "
                        f"elements {t['contiguous_ms']:.4f} ms [{card}]")
    log(f"  both noise kernels: a spatial rank's rows with their window "
        f"bit-equal to the whole launch's, by value and device offset, "
        f"within one ulp of the plain version [{card}]")
    return times


def _sp_full_width(dev, rank: int, spatial: int = 2,
                   graph_k: int | None = None, encoder: str = "resnet34",
                   knobs: dict | None = None,
                   dtypes=("float32", "bfloat16"),
                   exchange_cost: bool = True) -> dict:
    """20c (20d, 21c) on one rank: phase 5's denoiser (448^2 x16, bf16;
    ``encoder`` and the config ``knobs``) with ``spatial_parallel`` from
    phase 5's seed: the first forward on ``_sp_probe_inputs``' rows in each
    of ``dtypes``, with its exchanges and broken (``_halo_fault``); the
    first step's loss on a fixed batch, 2 more warm-up and 5 timed steps,
    the peak memory, a profile (rank 0), the census of one step and, with
    ``exchange_cost``, the host's cost of one halo exchange; with
    ``graph_k`` (NCCL), one group of K steps as a graph (capture and
    replay), then 2 timed groups."""
    import torch.distributed as dist

    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        LAUNCHES)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import (
        collectives, halo)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_summary, census_violations, collective_census)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch, shard_rows)

    marks = [("start", time.perf_counter())]
    preds = {}
    for dtype in ("float32", "bfloat16"):  # bf16's trainer is stepped below
        trainer = make_trainer(dev, encoder=encoder, batch=16, size=448,
                               dtype=dtype, spatial_parallel=spatial,
                               **(knobs or {}))
        state = trainer.init_state(seed=SEED)
        if dtype not in dtypes:
            continue
        x = shard_rows(shard_batch(_sp_probe_inputs()[0], trainer.mesh),
                       trainer.mesh).to(dev)
        preds[f"pred_{dtype}"] = _sp_prediction(state, trainer.mesh, x)
        exchange, halo.exchange_rows = halo.exchange_rows, _halo_fault
        try:
            preds[f"fault_{dtype}"] = _sp_prediction(state, trainer.mesh, x)
        finally:
            halo.exchange_rows = exchange
        del x
    rng = np.random.default_rng(SEED + 101)
    batches = [shard_batch(torch.from_numpy(rng.integers(
        0, 256, (16, 448, 448, 3), np.uint8)), trainer.mesh).to(dev)
        for _ in range(3)]
    torch.cuda.synchronize()
    marks.append(("forwards", time.perf_counter()))
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    out = {"first_loss": float(trainer.train_step(state,
                                                  batches[0])["loss"]),
           **preds}
    for i in (1, 2):
        trainer.train_step(state, batches[i])
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(5):
        loss = trainer.train_step(state, batches[i % 3])["loss"]
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out["counts"] = dict(LAUNCHES)
    out["last_loss"] = float(loss)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    marks.append(("steps", time.perf_counter()))
    check(out["counts"] == {"affine_warp_fused": 8, "fused_noise_blend": 8},
          f"20c rank {rank}: launches {out['counts']} in 8 steps")
    with collectives.recording() as calls:
        trainer.train_step(state, batches[0])
        torch.cuda.synchronize()
    census = collective_census(calls)
    out["census"] = census_summary(census)
    out["violations"] = census_violations(census, spatial=True)
    marks.append(("census", time.perf_counter()))
    lb = batches[0].shape[0]
    run = dict(single_path(trainer, size=448, batch=lb, state=state),
               step_ms=out["step_ms"])
    if rank == 0:
        profile_steps(run, dev, None)
        out["busy_ms"] = run["busy_ms"]
    else:
        u8 = torch.randint(0, 256, (lb, 448, 448, 3), dtype=torch.uint8,
                           device=dev)
        for _ in range(4):  # profile_steps' steps, on every rank
            run["step"](u8)
        torch.cuda.synchronize()
    marks.append(("profile", time.perf_counter()))
    if exchange_cost:
        # The host's cost of one halo exchange: the stem's output rows (64
        # channels, 112 of 224 rows, 224 wide, bf16), one row each way.
        x = torch.randn((16, 64, 112, 224), device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        collectives.exchange_rows(x, 1, 1, trainer.mesh, dim=2, pad=0.0)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            collectives.exchange_rows(x, 1, 1, trainer.mesh, dim=2, pad=0.0)
        torch.cuda.synchronize()
        out["halo_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    if graph_k:
        step = trainer.make_super_step(graph_k)
        group = [batches[i % 3] for i in range(graph_k)]
        step(state, *group)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, *group)
        torch.cuda.synchronize()
        out["graph_step_ms"] = (time.perf_counter() - t0) / (2 * graph_k) * 1e3
    marks.append(("end", time.perf_counter()))
    out["seconds"] = ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                               for a, b in zip(marks, marks[1:]))
    return out


def _sp_hold_full_width(full: list, data: int, spatial: int, dev,
                        card: str, phase: str, encoder: str = "resnet34",
                        knobs: dict | None = None,
                        dtypes=("float32", "bfloat16")) -> None:
    """20c (20d, 21c): the ranks' ``_sp_full_width`` (of ``encoder`` with
    the config ``knobs``) against one process of the same weights. The
    first forward's rows put together, with the exchanges and broken, by
    relative L2 distance (and the loss of each against the target,
    relative), in each of ``dtypes``; the first step's loss. Fails unless the fp32 forward with exchanges is within
    ``SP_PRED_LIMIT``, the broken one beyond it, and every first loss
    within ``SP_LOSS_LIMIT``. In bf16 the sound forward's distance is
    logged beside the broken one's, not held: bf16 rounds each layer
    to 2^-8, and an initialised U-Net with batch norm amplifies such
    differences with depth, whoever computes them."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.losses import (
        mse_ssim_loss)

    noisy, target = _sp_probe_inputs()
    target = target.to(dev)
    gaps, ones, one_loss = {}, {}, None
    for dtype in ("float32", "bfloat16"):
        trainer = make_trainer(dev, encoder=encoder, batch=16, size=448,
                               dtype=dtype, **(knobs or {}))
        state = trainer.init_state(seed=SEED)
        if dtype in dtypes:
            ones[dtype] = _sp_prediction(state, None, noisy.to(dev))
        if dtype == "bfloat16":
            rng = np.random.default_rng(SEED + 101)
            u8 = torch.from_numpy(rng.integers(0, 256, (16, 448, 448, 3),
                                               np.uint8)).to(dev)
            one_loss = float(trainer.train_step(state, u8)["loss"])
            del u8
        del trainer, state
        if dtype not in dtypes:
            continue
        one = ones[dtype]
        one_fit = float(mse_ssim_loss(one.to(dev), target))
        for key in ("pred", "fault"):
            got = torch.cat([torch.cat([full[d * spatial + s][
                f"{key}_{dtype}"] for s in range(spatial)], 1)
                for d in range(data)], 0)
            fit = float(mse_ssim_loss(got.to(dev), target))
            gaps[key, dtype] = (float((got - one).norm() / one.norm()),
                                abs(fit - one_fit) / abs(one_fit))
    losses = [abs(f["first_loss"] - one_loss) / abs(one_loss) for f in full]
    for dtype in dtypes:
        (sound, sound_fit), (broken, broken_fit) = (gaps["pred", dtype],
                                                    gaps["fault", dtype])
        log(f"  {phase} first forward, 448^2 x16 {dtype}, the ranks' rows "
            f"against one process: relative L2 {sound:.3e}"
            + (f" (limit {SP_PRED_LIMIT:g})" if dtype == "float32" else "")
            + f", its loss {sound_fit:.3e} relative; with every halo "
            f"zero-filled (a broken exchange) {broken:.3e}, its loss "
            f"{broken_fit:.3e} [{card}]")
    if len(ones) == 2:
        bf16, fp32 = ones["bfloat16"], ones["float32"]
        log(f"  {phase} one process's bf16 forward against its fp32 one: "
            f"relative L2 {float((bf16 - fp32).norm() / fp32.norm()):.3e} "
            f"[{card}]")
    log(f"  {phase} first step's loss (bf16) {full[0]['first_loss']:.6f} "
        f"against {one_loss:.6f} in one process ({max(losses):.2e} "
        f"relative at most over the ranks, limit {SP_LOSS_LIMIT:g}) [{card}]")
    sound, broken = gaps["pred", "float32"][0], gaps["fault", "float32"][0]
    check(sound <= SP_PRED_LIMIT < broken,
          f"{phase}: the fp32 first forward {sound:.3e} from one process, "
          f"broken {broken:.3e}, limit {SP_PRED_LIMIT:g}")
    check(max(losses) <= SP_LOSS_LIMIT
          and len({f["first_loss"] for f in full}) == 1,
          f"{phase}: first losses {[f['first_loss'] for f in full]} against "
          f"one process {one_loss}")


def _sp_worker_gloo(workdir: Path) -> None:
    """20b and 20c, one of two ranks on the one card over gloo with
    spatial_parallel: 2 (data 1)."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.device import (
        resolve_device)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        LAUNCHES)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import (
        distributed)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_of_train_step, census_summary, census_violations)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)

    check(distributed.maybe_initialize_from_env(backend="gloo"),
          "20b: no D3F_* launch environment")
    rank = distributed.process_index()
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    dev = resolve_device()
    out = {"counts": {}}

    def rows(b, t):
        return shard_batch(b, t.mesh).to(dev)

    for workload in ("denoiser", "swap", "balance"):
        LAUNCHES.clear()
        out[workload] = _dp_step(workload, dev, rows, SP_BATCH, DP_SIZE,
                                 spatial_parallel=2)
        torch.cuda.synchronize()
        out["counts"][f"sp_gloo_{workload}_64"] = dict(LAUNCHES)
    # remat: the recompute, in the autograd engine's own thread on the
    # card, issues the halo exchanges again inside the backward.
    for policy in ("dots", "full"):
        LAUNCHES.clear()
        got = _dp_step("denoiser", dev, rows, SP_BATCH, DP_SIZE,
                       spatial_parallel=2, remat=policy)
        torch.cuda.synchronize()
        out["counts"][f"sp_gloo_remat_{policy}_64"] = dict(LAUNCHES)
        out[f"remat_{policy}"] = max(
            float((got[k].double() - v.double()).abs().max())
            if isinstance(v, torch.Tensor) else abs(got[k] - v)
            for k, v in out["denoiser"].items())
    out["denoiser_32"] = _dp_step("denoiser", dev, rows, SP_BATCH, 32,
                                  spatial_parallel=2)
    census = census_of_train_step("denoiser", image_size=DP_SIZE,
                                  batch_size=SP_BATCH, encoder_name="resnet18",
                                  compute_dtype="float32", spatial=2)
    out["census"] = census_summary(census)
    out["violations"] = census_violations(census, spatial=True)
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path=str(workdir / "frames_64" / "images.txt"),
        batch_size=SP_BATCH, image_size=DP_SIZE, encoder_name="resnet18",
        compute_dtype="float32", max_epochs=3, spatial_parallel=2,
        log_images=False, seed=SEED, log_dir=str(workdir / "sp_runs"),
        checkpoint_dir=str(workdir / "sp_ck")))
    LAUNCHES.clear()
    state, trainer, ctx = fit_denoiser(cfg, max_steps=4, verbose=False,
                                       decode_fn=np.load)
    torch.cuda.synchronize()
    out["counts"]["sp_gloo_fit_denoiser_64"] = dict(LAUNCHES)
    out["fit"] = {"step": state.step, "mesh": (trainer.mesh.data,
                                               trainer.mesh.spatial),
                  "weights": [t.cpu() for t in
                              state.model.state_dict().values()]}
    cudnn.deterministic, cudnn.benchmark = False, True
    out["full"] = _sp_full_width(dev, rank)
    out["counts"]["sp_gloo_denoiser_448"] = out["full"]["counts"]
    torch.save(out, workdir / f"sp_rank{rank}.pt")
    distributed.shutdown()


def _sp_worker_nccl(workdir: Path) -> None:
    """20d, one of four ranks, a card each, over NCCL
    (``--spatial-cards``): the 64^2 float64 steps at data 1 x spatial 4
    (the denoiser; its stride-32 level gathered) and data 2 x spatial 2
    (the denoiser and the swap pair), a K = 2 graph of the data 2 x
    spatial 2 denoiser against two eager steps, and the full-width
    denoiser at both layouts; then 21c's efficientnet-b0 and patchified
    resnet34 at full width at data 1 x spatial 4 (the forward in fp32),
    eager and as K = 16 graphs, halos and SE sums captured."""
    from denoising_diffusion_deep_fake_tpu_torch.device import (
        resolve_device)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import (
        distributed)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        model_states)

    check(distributed.maybe_initialize_from_env(),
          "20d: no D3F_* launch environment")
    check(torch.distributed.get_backend() == "nccl", "20d: not NCCL")
    rank = distributed.process_index()
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    dev = resolve_device()

    def rows(b, t):
        return shard_batch(b, t.mesh).to(dev)

    out = {"s4": _dp_step("denoiser", dev, rows, SP_BATCH, DP_SIZE,
                          spatial_parallel=4),
           "d2s2": _dp_step("denoiser", dev, rows, 4, DP_SIZE,
                            spatial_parallel=2),
           "swap_d2s2": _dp_step("swap", dev, rows, 4, DP_SIZE,
                                 spatial_parallel=2)}
    rng = np.random.default_rng(SEED + 103)
    group = [torch.from_numpy(rng.integers(0, 256, (4, DP_SIZE, DP_SIZE, 3),
                                           np.uint8)) for _ in range(2)]
    eager_t, graph_t = (_dp_trainer("denoiser", dev, 4, DP_SIZE,
                                    spatial_parallel=2) for _ in "ab")
    eager_s, graph_s = (t.init_state(seed=SEED) for t in (eager_t, graph_t))
    for b in group:
        eager_t.train_step(eager_s, rows(b, eager_t))
    graph_t.make_super_step(2)(graph_s, *(rows(b, graph_t) for b in group))
    torch.cuda.synchronize()
    out["graph_max_diff"] = max(float((a - b).abs().max()) for a, b in zip(
        *(list(model_states(s)[0].model.state_dict().values())
          for s in (eager_s, graph_s))))
    cudnn.deterministic, cudnn.benchmark = False, True
    out["full_s4"] = _sp_full_width(dev, rank, spatial=4, graph_k=16)
    out["full_d2s2"] = _sp_full_width(dev, rank, spatial=2, graph_k=16)
    cudnn.benchmark = False   # as 21c's ranks
    for key, encoder, knobs in SP_FULL_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        out[f"full_s4_{key}"] = _sp_full_width(
            dev, rank, spatial=4, graph_k=16, encoder=encoder, knobs=knobs,
            dtypes=("float32",), exchange_cost=False)
    torch.save(out, workdir / f"sp_nccl_rank{rank}.pt")
    distributed.shutdown()


def spatial_cards(root: Path, dev, card: str) -> None:
    """20d (``--spatial-cards``, four cards): spatial parallelism over
    NCCL, each rank on a card of its own, against the one-process steps
    on card 0."""
    t0 = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    _launch_ranks("spatial_nccl", root, 4, timeout_s=600)
    ranks = [torch.load(root / f"sp_nccl_rank{r}.pt", weights_only=False)
             for r in range(4)]
    log(f"    (ranks {time.perf_counter() - t0:.1f} s)")
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    for key, workload, batch in (("s4", "denoiser", SP_BATCH),
                                 ("d2s2", "denoiser", 4),
                                 ("swap_d2s2", "swap", 4)):
        with (_row_share_loss(2) if workload == "swap"
              else contextlib.nullcontext()):
            one = _dp_step(workload, dev, lambda b, t: b.to(dev), batch,
                           DP_SIZE)
        _dp_compare(f"{key} {DP_SIZE}^2 x{batch}", ranks[0][key], one,
                    phase="20d", ranks="4 NCCL ranks on 4 cards")
        check(all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                  else a == b for r in ranks[1:] for a, b in zip(
                      r[key].values(), ranks[0][key].values())),
              f"20d {key}: the ranks' states differ")
    graphs = [r["graph_max_diff"] for r in ranks]
    check(graphs == [0.0] * 4, f"20d K = 2 graph of the data 2 x spatial 2 "
          f"denoiser: its weights differ from two eager steps' by {graphs}")
    log("  20d K = 2 graph of the data 2 x spatial 2 denoiser, halos "
        f"captured: bit-equal to two eager steps on every rank [{card}]")
    cudnn.deterministic, cudnn.benchmark = False, True
    cases = [("full_s4", "resnet34", {}, (1, 4)),
             ("full_d2s2", "resnet34", {}, (2, 2))]
    cases += [(f"full_s4_{key}", encoder, knobs, (1, 4))
              for key, encoder, knobs in SP_FULL_FAMILIES]
    for key, encoder, knobs, layout in cases:
        what = (f"{encoder}" + "".join(f" {k}={v}" for k, v in knobs.items())
                + f" data {layout[0]} x spatial {layout[1]}")
        full = [r[key] for r in ranks]
        resnet = encoder == "resnet34" and not knobs
        cudnn.benchmark = resnet   # 21c's models as their ranks ran them
        _sp_hold_full_width(full, *layout, dev, card, f"20d {what}",
                            encoder=encoder, knobs=knobs,
                            dtypes=(("float32", "bfloat16") if resnet
                                    else ("float32",)))
        step_ms = max(f["step_ms"] for f in full)
        halo = full[0]["census"].get("collective-permute", {})
        reduce = full[0]["census"].get("all-reduce", {})
        busy = full[0].get("busy_ms", 0.0)
        log(f"  20d {what}, 448^2 x16 bf16 over NCCL: "
            f"{16 / step_ms * 1e3:.1f} imgs/s ({step_ms:.1f} ms a step, "
            f"host clock, mean of 5), first losses "
            f"{[round(f['first_loss'], 6) for f in full]}, peak memory "
            f"{[round(f['peak_gb'], 2) for f in full]} GB; rank 0 kernels "
            f"{busy:.3f} ms a step (idle {1 - busy / step_ms:.1%}); a step: "
            f"{halo.get('count', 0)} halo exchanges, "
            f"{halo.get('total_mib', 0):.3f} MiB a rank, "
            f"{reduce.get('count', 0)} all-reduces "
            f"({reduce.get('spatial_sums', 0)} SE sums), "
            f"{reduce.get('total_mib', 0):.3f} MiB; "
            + (f"one exchange of the stem's rows {full[0]['halo_ms']:.3f} "
               f"ms of host; " if "halo_ms" in full[0] else "")
            + f"K = 16 graph "
            f"{16 / max(f['graph_step_ms'] for f in full) * 1e3:.1f} "
            f"imgs/s [{card}]")
        check(all(not f["violations"] for f in full),
              f"20d census: {[f['violations'] for f in full]}")
    log(f"  phase 20d took {time.perf_counter() - t0:.1f} s [{card}]")


def spatial_parallel(root: Path, dev, launches, card: str,
                     main_run: dict) -> tuple[dict, dict]:
    """Phase 20: 20a the noise kernels' row window; 20b two ranks on the
    one card over gloo with spatial_parallel: 2 against the one-process
    step; 20c the full-width denoiser over those two ranks. Returns the
    launch counts by path and 20a's times."""
    t20 = time.perf_counter()
    log("[20a] the noise kernels' row window")
    times = noise_row_window(dev, card)
    log(f"    ({time.perf_counter() - t20:.1f} s)")

    log("[20b, 20c] two ranks on the one card over gloo, "
        "spatial_parallel: 2")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    root.mkdir(parents=True, exist_ok=True)
    write_frames(root / "frames_64", 16, DP_SIZE, SEED + 102)
    _launch_ranks("spatial", root, 2, timeout_s=400)
    ranks = [torch.load(root / f"sp_rank{r}.pt", weights_only=False)
             for r in range(2)]
    log(f"    (ranks {time.perf_counter() - t0:.1f} s)")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for workload, size in (("denoiser", DP_SIZE), ("swap", DP_SIZE),
                               ("balance", DP_SIZE), ("denoiser_32", 32)):
            kind = workload.split("_")[0]
            with (_row_share_loss(2) if kind == "swap"
                  else contextlib.nullcontext()):
                one = _dp_step(kind, dev, lambda b, t: b.to(dev), SP_BATCH,
                               size)
            _dp_compare(f"{workload} {size}^2", ranks[0][workload], one,
                        phase="20b", ranks="2 spatial ranks (gloo)")
            check(all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                      else a == b for a, b in zip(
                          ranks[0][workload].values(),
                          ranks[1][workload].values())),
                  f"20b {workload}: the ranks' states differ")
        plain = _dp_step("swap", dev, lambda b, t: b.to(dev), SP_BATCH,
                         DP_SIZE)
        parted = max(float((ranks[0]["swap"][k].double() - v.double()).abs()
                           .max() / v.double().abs().max())
                     for k, v in plain.items() if k.startswith("1.grad."))
        log(f"  20b swap pair: held against one process with its loss in "
            f"the ranks' 2 row shares; against the plain one-process step "
            f"model b's gradients part by {parted:.2e} of a tensor's "
            f"largest at most (the loss's row order, lr 1e-3) [{card}]")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    for policy in ("dots", "full"):
        diffs = [r[f"remat_{policy}"] for r in ranks]
        check(diffs == [0.0, 0.0], f"20b remat {policy}: the spatial step "
              f"differs from the one without remat by {diffs}")
    log("  20b remat dots and full over S = 2: each rank's step bit-equal "
        f"to its step without remat [{card}]")
    for r in ranks:
        check(not r["violations"], f"20b census: {r['violations']}")
        check(r["census"].get("collective-permute", {}).get("count", 0) > 0,
              "20b: the spatial step exchanged no halo")
        check(r["fit"]["step"] == 4 and tuple(r["fit"]["mesh"]) == (1, 2),
              f"20b fit_denoiser: {r['fit']['step']} steps on "
              f"{r['fit']['mesh']}")
    check(all(torch.equal(a, b) for a, b in zip(
        ranks[0]["fit"]["weights"], ranks[1]["fit"]["weights"])),
        "20b fit_denoiser: the ranks' weights differ")
    census = ranks[0]["census"]
    log("  20b census of one 64^2 x2 fp32 step over S = 2: " + ", ".join(
        f"{op} {c['count']} calls, {c['total_mib']:.3f} MiB (largest "
        f"{c['max_mib']:.3f})" for op, c in census.items()))
    log("  20b: fit_denoiser from 64^2 .npy frames through the host "
        "loader, 4 steps on a (1, 2) mesh, the ranks' weights equal; "
        f"launches by path {ranks[0]['counts']}")

    log("[20c] 448^2 x16 resnet34 bf16 over S = 2 against one process")
    full = [r["full"] for r in ranks]
    _sp_hold_full_width(full, 1, 2, dev, card, "20c")
    step_ms = max(f["step_ms"] for f in full)
    busy = full[0].get("busy_ms", 0.0)
    halo = full[0]["census"].get("collective-permute", {})
    reduce = full[0]["census"].get("all-reduce", {})
    log(f"  20c: {16 / step_ms * 1e3:.1f} imgs/s ({step_ms:.1f} ms a step, "
        f"host clock, mean of 5, two ranks sharing the card) beside phase "
        f"5's {16 / main_run['step_ms'] * 1e3:.1f} in one process [{card}]")
    log(f"  20c peak memory: rank 0 {full[0]['peak_gb']:.2f} GB, rank 1 "
        f"{full[1]['peak_gb']:.2f} GB, beside phase 5's one-process "
        f"{main_run['peak_gb']:.2f} GB [{card}]")
    log(f"  20c rank 0: kernels {busy:.3f} ms a step, device idle "
        f"{1 - busy / step_ms:.1%} of its step" if busy > 0 else
        "  20c: the profiler saw no device time")
    log(f"  20c a step: {halo.get('count', 0)} halo exchanges, "
        f"{halo.get('total_mib', 0):.3f} MiB sent a rank (through the host:"
        f" gloo), {reduce.get('count', 0)} all-reduces, "
        f"{reduce.get('total_mib', 0):.3f} MiB; one halo exchange of the "
        f"stem's rows (16 x 64 x 224 bf16 each way) costs the host "
        f"{full[0]['halo_ms']:.3f} ms [{card}]")
    check(not full[0]["violations"], f"20c census: {full[0]['violations']}")
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s [{card}]")
    counts = {**ranks[0]["counts"]}
    return counts, times


# ------------------------- phase 21: spatial parallelism, the families


# 21b's cases at 64^2, (key, workload, encoder, patchify_stem): the CPU
# test's names (tests/test_torch_port_spatial_families.py), one a family
# and the patchified resnet18, each stepped, and efficientnet-b0's swap
# pair and balancer.
SP_FAMILY_CASES = (
    *((name, "denoiser", name, 1) for name in (
        "vgg11_bn", "densenet121", "se_resnext50_32x4d", B0, "mobilenet_v2",
        "xception", "inceptionv4", "inceptionresnetv2", "dpn68")),
    ("resnet18_patchify2", "denoiser", "resnet18", 2),
    (f"{B0}_swap", "swap", B0, 1),
    (f"{B0}_balance", "balance", B0, 1),
)
# 21c's models at configs/denoiser.yml's width, (key, encoder, knobs); the
# keys are 18c's paths without their size.
SP_FULL_FAMILIES = (("efficientnet_b0", B0, {}),
                    ("patchify2_resnet34", "resnet34", {"patchify_stem": 2}))
# The row windows the noise kernels take in 21b and 21c: (the global
# shape, the spatial axis).
SP_FAMILY_WINDOWS = (((SP_BATCH, DP_SIZE, DP_SIZE, 3), 2),
                     ((16, 448, 448, 3), 2))


def _checksum(step: dict) -> str:
    """A digest of a ``_dp_step`` result's bits: each tensor's bits summed
    as integers (wrapping), which is cheap for 62M parameters."""
    digest = hashlib.sha256()
    for k, v in step.items():
        if isinstance(v, torch.Tensor):
            bits = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                    1: torch.int8}[v.element_size()]
            v = int(v.reshape(-1).view(bits).sum())
        digest.update(f"{k}={v!r};".encode())
    return digest.hexdigest()


def _sp_families_worker(workdir: Path) -> None:
    """21b and 21c, one of two ranks on the one card over gloo with
    spatial_parallel: 2. Before it joins the group, the rank takes the
    one-process steps of every other case of ``SP_FAMILY_CASES`` (rank r
    the r-th, r + 2-th, ...), kept on the card; in the group, each case's
    64^2 float64 step (its launches and a digest of its bits, under
    ``cudnn.deterministic``), held by the rank that has its one-process
    step (``_dp_compare``, which logs it and fails the rank otherwise);
    the census of an fp32 b0 step; then ``SP_FULL_FAMILIES`` at full
    width (``_sp_full_width``, the forward in fp32), cuDNN's autotuning
    off."""
    import os

    from denoising_diffusion_deep_fake_tpu_torch.device import (
        resolve_device)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
        LAUNCHES)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import (
        distributed)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_of_train_step, census_summary, census_violations)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)

    rank = int(os.environ["D3F_PROCESS_ID"])
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    dev = resolve_device()
    out, refs = {"counts": {}, "sums": {}}, {}
    t0 = time.perf_counter()
    for key, workload, encoder, patchify in SP_FAMILY_CASES[rank::2]:
        with (_row_share_loss(2) if workload == "swap"
              else contextlib.nullcontext()):
            refs[key] = _dp_step(workload, dev, lambda b, t: b.to(dev),
                                 SP_BATCH, DP_SIZE, to_host=False,
                                 encoder_name=encoder,
                                 patchify_stem=patchify)
    out["refs_s"] = time.perf_counter() - t0
    check(distributed.maybe_initialize_from_env(backend="gloo"),
          "21b: no D3F_* launch environment")
    check(distributed.process_index() == rank, "21b: the rank moved")
    dev = resolve_device()
    t0 = time.perf_counter()
    for key, workload, encoder, patchify in SP_FAMILY_CASES:
        LAUNCHES.clear()
        step = _dp_step(workload, dev, lambda b, t: shard_batch(
            b, t.mesh).to(dev), SP_BATCH, DP_SIZE, to_host=False,
            spatial_parallel=2, encoder_name=encoder, patchify_stem=patchify)
        torch.cuda.synchronize()
        out["counts"][f"sp_gloo_{key.replace('-', '_')}_64"] = dict(
            LAUNCHES)
        out["sums"][key] = _checksum(step)
        if key in refs:
            _dp_compare(f"{key} 64^2", step, refs.pop(key), phase="21b",
                        ranks=f"2 spatial ranks (gloo), held on rank {rank}")
        del step
    census = census_of_train_step("denoiser", image_size=DP_SIZE,
                                  batch_size=SP_BATCH, encoder_name=B0,
                                  compute_dtype="float32", spatial=2)
    out["census"] = census_summary(census)
    out["violations"] = census_violations(census, spatial=True)
    out["steps_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # No autotuning at full width: b0's first step at a rank's shapes
    # autotunes its depthwise convolutions for over a minute, and the step
    # is host-bound (the halos and sums cross the host under gloo).
    cudnn.deterministic, cudnn.benchmark = False, False
    out["full"] = {}
    for key, encoder, knobs in SP_FULL_FAMILIES:
        full = out["full"][key] = _sp_full_width(
            dev, rank, encoder=encoder, knobs=knobs, dtypes=("float32",),
            exchange_cost=False)
        out["counts"][f"sp_gloo_{key}_448"] = full["counts"]
        gc.collect()
        torch.cuda.empty_cache()
    distributed.shutdown()
    torch.save(out, workdir / f"sp_families_rank{rank}.pt")


def spatial_families(root: Path, dev, card: str, peaks: dict) -> dict:
    """Phase 21: 21a the noise kernels' row windows at the shapes 21b and
    21c launch (those 20a did not check); 21b two ranks on the one card
    over gloo with spatial_parallel: 2, the 64^2 float64 steps of one
    name a family, the patchified resnet18, b0's swap pair and balancer,
    each against the one-process step on the card, and a census; 21c
    efficientnet-b0 and the patchified resnet34 at full width over those
    two ranks, beside 18c's one-process peaks (``peaks``). Returns the
    launch counts by path."""
    t21 = time.perf_counter()
    log("[21a] the noise kernels' row windows at 21b's and 21c's shapes")
    checked = {(shape, s) for shape, spatials in ROW_WINDOWS
               for s in spatials}
    missing = [(shape, (s,)) for shape, s in SP_FAMILY_WINDOWS
               if (shape, s) not in checked]
    if missing:
        noise_row_window(dev, card, missing, phase="21a")
    log(f"  21a: of the windows {[f'{w[0]} S = {w[1]}' for w in SP_FAMILY_WINDOWS]}"
        f" 20a checked {len(SP_FAMILY_WINDOWS) - len(missing)}, 21a the "
        f"others [{card}]")

    log("[21b, 21c] two ranks on the one card over gloo, spatial_parallel: "
        "2: the nine other families and the patchified U-Net")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    root.mkdir(parents=True, exist_ok=True)
    _launch_ranks("spatial_families", root, 2, timeout_s=420)
    ranks = [torch.load(root / f"sp_families_rank{r}.pt", weights_only=False)
             for r in range(2)]
    log(f"    (ranks {time.perf_counter() - t0:.1f} s: the one-process "
        f"64^2 steps {ranks[0]['refs_s']:.1f} s and "
        f"{ranks[1]['refs_s']:.1f} s, the spatial ones and the census "
        f"{ranks[0]['steps_s']:.1f} s; 21c "
        + ", ".join(f"{k} {v['seconds']}" for k, v in ranks[0]["full"].items())
        + ")")
    for key, *_ in SP_FAMILY_CASES:
        check(ranks[0]["sums"][key] == ranks[1]["sums"][key],
              f"21b {key}: the ranks' states differ")
    for r in ranks:
        reduce = r["census"].get("all-reduce", {})
        check(not r["violations"], f"21b census: {r['violations']}")
        check(r["census"].get("collective-permute", {}).get("count", 0) > 0
              and reduce.get("spatial_sums", 0) > 0,
              f"21b: b0's spatial step exchanged no halo or summed no SE "
              f"mean over the data row: {r['census']}")
    log(f"  21b: the {len(SP_FAMILY_CASES)} steps of both ranks bit-equal "
        f"(their digests), each held above; census of one 64^2 "
        f"x2 fp32 efficientnet-b0 step over S = 2: " + ", ".join(
            f"{op} {c['count']} calls, {c['total_mib']:.3f} MiB"
            + (f" ({c['spatial_sums']} SE sums)" if "spatial_sums" in c
               else "") for op, c in ranks[0]["census"].items()) + f" [{card}]")

    for key, encoder, knobs in SP_FULL_FAMILIES:
        label = f"{encoder}" + "".join(f" {k}={v}" for k, v in knobs.items())
        log(f"[21c] 448^2 x16 {label} bf16 over S = 2 against one process")
        full = [r["full"][key] for r in ranks]
        t0 = time.perf_counter()
        cudnn = torch.backends.cudnn
        saved, cudnn.benchmark = cudnn.benchmark, False  # as the ranks
        try:
            _sp_hold_full_width(full, 1, 2, dev, card, f"21c {label}",
                                encoder=encoder, knobs=knobs,
                                dtypes=("float32",))
        finally:
            cudnn.benchmark = saved
        log(f"    (one process's forward and first step "
            f"{time.perf_counter() - t0:.1f} s)")
        check(not full[0]["violations"],
              f"21c census: {full[0]['violations']}")
        step_ms = max(f["step_ms"] for f in full)
        busy = full[0].get("busy_ms", 0.0)
        halo = full[0]["census"].get("collective-permute", {})
        reduce = full[0]["census"].get("all-reduce", {})
        one_gb = peaks.get(f"{key}_448")
        log(f"  21c {label}: {16 / step_ms * 1e3:.1f} imgs/s "
            f"({step_ms:.1f} ms a step, host clock, mean of 5, two ranks "
            f"sharing the card); "
            + (f"rank 0's kernels {busy:.3f} ms a step, device idle "
               f"{1 - busy / step_ms:.1%}; " if busy > 0 else
               "the profiler saw no device time; ")
            + f"a step: {halo.get('count', 0)} halo exchanges, "
            f"{halo.get('total_mib', 0):.3f} MiB a rank (through the host: "
            f"gloo), {reduce.get('spatial_sums', 0)} SE sums among "
            f"{reduce.get('count', 0)} all-reduces; peak memory rank 0 "
            f"{full[0]['peak_gb']:.2f} GB, rank 1 {full[1]['peak_gb']:.2f} "
            f"GB, beside 18c's one process "
            + (f"{one_gb:.2f} GB" if one_gb is not None else "(not run)")
            + f" [{card}]")
    log(f"  phase 21 took {time.perf_counter() - t21:.1f} s [{card}]")
    return dict(ranks[0]["counts"])


def dp_worker(argv: list) -> int:
    """``--dp-worker nccl|gloo|spatial|spatial_families|spatial_nccl
    WORKDIR [DATA]``: one rank of phase 19 (20b and 20c for ``spatial``,
    21b and 21c for ``spatial_families``, 20d for ``spatial_nccl``)."""
    mode, workdir = argv[0], Path(argv[1])
    card = card_line()
    if mode == "nccl":
        _dp_worker_nccl(workdir, Path(argv[2]), card)
    elif mode == "spatial":
        _sp_worker_gloo(workdir)
    elif mode == "spatial_families":
        _sp_families_worker(workdir)
    elif mode == "spatial_nccl":
        _sp_worker_nccl(workdir)
    else:
        _dp_worker_gloo(workdir, card)
    return 0


def spatial_cards_main() -> int:
    """``--spatial-cards``: build the kernels, then phase 20d alone."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

    faulthandler.dump_traceback_later(1100, exit=True)
    check(torch.cuda.device_count() >= 4, f"--spatial-cards: needs 4 "
          f"cards, {torch.cuda.device_count()} here")
    card = card_line()
    log(card)
    sources = sorted({k[0][:-3] for k in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log("[20d] spatial parallelism over NCCL, four ranks on four cards")
    with tempfile.TemporaryDirectory() as tmp:
        spatial_cards(Path(tmp) / "sp_nccl", torch.device("cuda", 0), card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-out", type=Path, default=None,
                        help="write the main path's profile report (JSON) "
                        "here")
    parser.add_argument("--dp-worker", nargs="+", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--spatial-cards", action="store_true",
                        help="instead of the phases, check spatial "
                        "parallelism over NCCL on four cards")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.spatial_cards:
        return spatial_cards_main()
    t_start = time.perf_counter()
    # A hang anywhere prints every thread's stack and exits non-zero within
    # the script's 1200 s limit (the phases take up to ~1100 s on a slow
    # host).
    faulthandler.dump_traceback_later(1170, exit=True)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log("[1] card (nvidia-smi name, power.limit):")
    log(card)
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    # The plain warp's matmul must stay in fp32 (bf16-valued operands give
    # exact products only there); PyTorch's default, stated and set.
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    sources = sorted({k[0][:-3] for k in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    log(f"[2] built {', '.join(lib.name for lib, _ in built)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, report in built:
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log("    " + line.strip()[:110])

    log("[3] kernels vs plain versions")
    results = kernel_checks(dev)
    results.update(noise_checks(dev))

    log("[4] small-input reference")
    small_reference(dev)

    log("[5] main path: 448^2, batch 16, auto warp route")
    main_run = drive(dev, _build.LAUNCHES, card, single_path(
        make_trainer(dev, encoder="resnet34", batch=16, size=448,
                     dtype="bfloat16"), size=448, batch=16),
                     warmup=3, steps=30,
                     per_step={"affine_warp_fused": 1,
                               "fused_noise_blend": 1})
    denoise = main_run["trainer"].make_denoise_fn()
    x = torch.rand((4, 448, 448, 3), device=dev) * 2 - 1
    out = denoise(main_run["state"], x)
    torch.cuda.synchronize()
    check(out.shape == x.shape and out.dtype == torch.float32
          and torch.isfinite(out).all().item(), "eval forward is not finite")
    log(f"  eval-mode forward {tuple(out.shape)} finite")
    profile_steps(main_run, dev, args.profile_out)

    log("[6] two-pass route: 640^2, batch 4, auto warp route")
    twopass_run = drive(dev, _build.LAUNCHES, card, single_path(
        make_trainer(dev, encoder="resnet34", batch=4, size=640,
                     dtype="bfloat16"), size=640, batch=4),
                        warmup=2, steps=10,
                        per_step={"warp_axis_pass": 2,
                                  "fused_noise_blend": 1})
    profile_steps(twopass_run, dev, None)

    log("[7] balancer: 448^2, batch 12, fixed ratio 0.7")
    balance_run = drive(dev, _build.LAUNCHES, card,
                        single_path(make_balancer(dev), size=448, batch=12),
                        warmup=3, steps=20,
                        per_step={"fused_normalise_noise_blend": 1})
    # The path goes on to the scoring pass: its counts are read after it.
    score_and_write(balance_run, dev, _build.LAUNCHES)
    balance_counts = dict(_build.LAUNCHES)
    log(f"  launches on the balancer path: {balance_counts}")
    profile_steps(balance_run, dev, None)

    log("[8a] deep-fake small reference: 64^2 fp32 swap step")
    deep_fake_reference(dev)
    log("[8b] deep-fake denoise mode: 448^2, batch 16 per identity")
    trainer = make_deep_fake(dev)
    states = trainer.init_states(seed=SEED)
    denoise_run = drive(dev, _build.LAUNCHES, card,
                        deep_fake_path(trainer, states,
                                       probes=online_probes(states)),
                        warmup=2, steps=10,
                        per_step={"affine_warp_fused": 2,
                                  "fused_noise_blend": 2})
    profile_steps(denoise_run, dev, None)
    log("[8c] the flip to swap mode (configs/swap.yml overlaid)")
    swap_trainer = deep_fake_flip(denoise_run, dev)
    log("[8d] deep-fake swap mode: 448^2, batch 16 per identity")
    swap_run = deep_fake_swap(swap_trainer, states, dev, _build.LAUNCHES,
                              card)
    profile_steps(swap_run, dev, None)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, small = Path(tmp) / "swap", Path(tmp) / "small"
        log("[9a] serving: checkpoint of 8d's states, loaded back")
        serving_checkpoint(swap_trainer, states, ckpt)
        log("[9b] serving small reference: 64^2 fp32 pipeline, GPU vs CPU")
        serving_reference(dev, small)
        log("[9c] single-pass pipeline: 448^2, batch 16")
        single_run = serving_single(ckpt, dev, _build.LAUNCHES, card)
        profile_steps(single_run, dev, None)
        log("[9d] DDIM pipeline: 448^2, batch 8, 10 steps")
        ddim_counts, ddim_run = serving_ddim(ckpt, dev, _build.LAUNCHES,
                                             card)
        profile_steps(ddim_run, dev, None)
        log("[9e] SwapEngine + SwapServer: 448^2, batch 8, 4 clients x 75 "
            "requests")
        served = serving_http(ckpt, dev, _build.LAUNCHES, card)

        log("[10] training from disk: the runners and the loop")
        loop_paths, data, loop_rate = training_from_disk(
            dev, _build.LAUNCHES, card, main_run["step_ms"],
            Path(tmp) / "disk")

        t11 = time.perf_counter()
        log("[11a] the i420 ops: 448^2 x 16, card vs CPU, host vs device")
        i420_ops(dev, card)
        log("[11b] i420 uploads: the three trainers at full width, the "
            "small references, fit_denoiser")
        i420_paths = i420_training(
            dev, _build.LAUNCHES, card,
            {"denoiser": main_run, "deep_fake": denoise_run,
             "balancer": balance_run}, Path(tmp) / "disk", data["a"],
            loop_rate)
        log("[11c] i420 pipeline: single-pass 448^2 x16, DDIM 448^2 x8 "
            "10 steps, transfers, 64^2 GPU vs CPU")
        i420_paths["serve_ddim_i420_448"] = i420_pipeline(
            ckpt, small, dev, _build.LAUNCHES, card,
            {"single": 16 / single_run["step_ms"] * 1e3,
             "ddim": 8 / ddim_run["step_ms"] * 1e3})
        log("[11d] SwapEngine(transfer='i420') + SwapServer: 4 clients x 25 "
            "requests with X-Format: i420; mixed formats")
        served_i420 = serving_http(ckpt, dev, _build.LAUNCHES, card,
                                   requests=25, transfer="i420")
        log(f"  served: i420 {served_i420:.1f} frames/s beside 9e's rgb "
            f"{served:.1f}")
        mixed_formats(ckpt, dev, card)
        log("[11e] render_fake_video: 60 frames of 448^2, batch 8, rgb, "
            "i420, DDIM 10 steps")
        i420_paths["render_ddim_448"] = render_check(ckpt, dev,
                                                     _build.LAUNCHES, card)
        log(f"  phase 11 took {time.perf_counter() - t11:.1f} s [{card}]")

        t12 = time.perf_counter()
        log("[12a] K-step graphs: the noise kernels' device-offset launch")
        offset_ms = device_offsets(dev, card)
        log("[12b] K-step graphs against eager steps: 64^2 x2, resnet18, "
            "fp32, K = 3")
        graph_paths = graph_against_eager(dev, _build.LAUNCHES)
        log(f"  12a and 12b took {time.perf_counter() - t12:.1f} s")
        log("[12c] K-step graphs at full width: the denoiser, the 640^2 "
            "route, the balancer (K = 16), the deep-fake trainer (K = 8)")
        graph_counts, graph_rates = graph_full_width(
            dev, _build.LAUNCHES, card,
            {"denoiser": main_run, "twopass": twopass_run,
             "balancer": balance_run, "denoise": denoise_run,
             "swap": swap_run})
        graph_paths.update(graph_counts)
        log("[12d, 12e] the runners with steps_per_call: fit_denoiser "
            "from 10a's frames, a 64^2 grouped resume")
        graph_paths.update(graph_from_disk(Path(tmp) / "disk", data, dev,
                                           _build.LAUNCHES, card))
        log(f"  phase 12 took {time.perf_counter() - t12:.1f} s [{card}]")

        log("[13] data on the device (data_cache: device): the runners "
            "from a dataset on the card")
        cache_paths, npy_rates = data_on_the_device(
            Path(tmp) / "disk", dev, _build.LAUNCHES, card)

        log("[14] the resnet encoder family and reference checkpoints in "
            "and out")
        family_paths = resnet_family_and_checkpoints(
            Path(tmp) / "migration", data, dev, _build.LAUNCHES, card,
            main_run)

        log("[15] the reference's JPEG/PNG frames on the card through the "
            "loader's route (cv2): the loader's choice, the runners, the "
            "CLI and the JPEG route")
        jpeg_paths = jpeg_frames(
            Path(tmp) / "codec", ckpt, dev, _build.LAUNCHES, card,
            main_run["step_ms"], npy_rates, served)

        log("[16] color jitter, remat and the CLI's profile: the trainers' "
            "last single-device knobs, warp_method shear and hybrid")
        knob_paths = jitter_remat_profile(
            Path(tmp) / "knobs", Path(tmp) / "codec", dev, _build.LAUNCHES,
            card, {"twopass": twopass_run, "swap": swap_run}, graph_rates)

        log("[17] the eight other encoder families (vgg, densenet, senet, "
            "mobilenet_v2, xception, inceptionv4, inceptionresnetv2, dpn) "
            "and the auto warp route below 384^2")
        other_paths = other_families(Path(tmp) / "families", data, dev,
                                     _build.LAUNCHES, card, main_run)

        log("[18] EfficientNet-b0..b7 with stochastic depth and the "
            "patchified U-Net")
        full_width_peaks = {}
        efficientnet_paths = efficientnet_and_patchify(
            Path(tmp) / "efficientnet", data, dev, _build.LAUNCHES, card,
            main_run, ckpt, full_width_peaks)

        log("[19] data parallelism: the noise kernels' element base, one "
            "rank over NCCL, two ranks on the one card over gloo")
        dp_paths = data_parallel(
            Path(tmp) / "dp", Path(tmp) / "disk" / "cache_256" /
            "images.txt", dev, _build.LAUNCHES, card, main_run, graph_rates,
            npy_rates)

        log("[20] spatial parallelism: the noise kernels' row window, two "
            "ranks on the one card over gloo with spatial_parallel: 2")
        sp_paths, window_ms = spatial_parallel(
            Path(tmp) / "sp", dev, _build.LAUNCHES, card, main_run)

        log("[21] spatial parallelism for the nine other encoder families "
            "and the patchified U-Net: two ranks on the one card over gloo")
        sp_family_paths = spatial_families(
            Path(tmp) / "sp_families", dev, card, full_width_peaks)

    paths = {"denoiser_448": main_run["counts"],
             "twopass_640": twopass_run["counts"],
             "balancer_448": balance_counts,
             "deep_fake_denoise_448": denoise_run["counts"],
             "deep_fake_swap_448": swap_run["counts"],
             "serve_ddim_448": ddim_counts, **loop_paths, **i420_paths,
             **graph_paths, **cache_paths, **family_paths, **jpeg_paths,
             **knob_paths, **other_paths, **efficientnet_paths,
             **dp_paths, **sp_paths, **sp_family_paths}
    first_path = {"affine_warp_fused": "denoiser_448",
                  "warp_axis_pass": "twopass_640",
                  "fused_noise_blend": "denoiser_448",
                  "fused_normalise_noise_blend": "balancer_448"}
    kernels = []
    for k, (src, tpu, *_) in KERNELS.items():
        by_path = {p: c[k] for p, c in paths.items() if c.get(k)}
        extra = ({"device_offset_ms": offset_ms[k]} if k in offset_ms
                 else {})
        extra.update(window_ms.get(k, {}))
        kernels.append(dict(
            name=k, route="cuda", source=f"{CSRC}/{src}",
            replaces=f"{REPO}/{tpu}", launches=by_path[first_path[k]],
            launches_by_path=by_path, library_ms=None, **results[k],
            **extra))
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s in "
        f"all [{card}]")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
