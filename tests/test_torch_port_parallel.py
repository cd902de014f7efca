"""The port's data-parallel layer in one process, on the CPU.

* The noise kernels' plain versions with ``element_base``: a launch on
  rows ``[lb:]`` at base ``lb * H * W * C`` is bit-equal to those rows of
  the whole batch's, for bases that are and are not multiples of 4 (a
  rank's first Philox group then starts inside the previous rank's rows).
* ``parallel/distributed.py`` and ``parallel/mesh.py`` outside a process
  group: JAX's one-process semantics and messages, ``shard_batch``'s rows
  for a given rank, and the refusals (``data_parallel > 1`` in one
  process, ``spatial > 1`` naming ROADMAP A9b), in the trainers too.
* ``parallel/collectives.py`` outside a group: every function is the
  identity and records nothing.
* ``parallel/audit.py``: the census policy on hand-made calls, as JAX's
  ``test_census_parser_unit``.
* The loader's manifest shards: JAX's two shard tests, on the port.
* ``SwapEngine(devices=2)`` on the CPU: two replicas bit-equal to one
  (single-pass), as JAX's ``tests/test_serving.py:334-359``; DDIM keys
  folded with the replica index.
* The K-step graph refuses gloo on CUDA tensors before it captures; in a
  group the rank's card is ``cuda:{rank % cards}``.

The two-process checks are ``tests/test_torch_port_distributed.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from denoising_diffusion_deep_fake_tpu.data import ImageLoader as JaxLoader
from denoising_diffusion_deep_fake_tpu_torch import config
from denoising_diffusion_deep_fake_tpu_torch import device as port_device
from denoising_diffusion_deep_fake_tpu_torch import inference
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.data.loader import ImageLoader
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
    noise_kernel as nk,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import (
    collectives,
    distributed,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
    census_summary,
    census_violations,
    collective_census,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    shard_batch,
    training_mesh,
)
from denoising_diffusion_deep_fake_tpu_torch.serving import SwapEngine
from denoising_diffusion_deep_fake_tpu_torch.training import multi_step
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)

from helpers import make_image_dataset

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- the noise


@pytest.mark.parametrize("shape,world", [
    ((4, 8, 8, 3), 2), ((4, 5, 3, 3), 2), ((6, 3, 3, 1), 2),
    ((6, 3, 3, 1), 3), ((2, 7, 5, 3), 2)])
def test_noise_rows_at_their_element_base_equal_the_whole_batch(shape,
                                                                world):
    b = shape[0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    u8 = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
    ratios = torch.from_numpy(rng.uniform(0, 1, b).astype(np.float32))
    norm = nk.noise_constants((0.4, 0.5, 0.6)[:shape[-1]],
                              (0.2, 0.3, 0.25)[:shape[-1]], shape[-1])
    whole_f32 = nk.fused_noise_blend_plain(x, ratios, seed=5, offset=7)
    whole_u8 = nk.fused_normalise_noise_blend_plain(u8, ratios, norm, seed=5,
                                                    offset=1 << 33)
    lb = b // world
    bases = []
    for r in range(world):
        rows = slice(r * lb, (r + 1) * lb)
        base = r * x[rows].numel()
        bases.append(base % 4)
        assert torch.equal(nk.fused_noise_blend_plain(
            x[rows], ratios[rows], seed=5, offset=7, element_base=base),
            whole_f32[rows])
        assert torch.equal(nk.fused_normalise_noise_blend_plain(
            u8[rows], ratios[rows], norm, seed=5, offset=1 << 33,
            element_base=base), whole_u8[rows])
        # The wrappers take the plain version for CPU tensors.
        assert torch.equal(nk.fused_noise_blend(
            x[rows], ratios[rows], seed=5, offset=7, element_base=base),
            whole_f32[rows])
    assert any(bases) == (shape != (4, 8, 8, 3))


def test_philox_words_from_a_group_base():
    whole = nk.philox_words(10, seed=3, offset=2, device="cpu")
    assert torch.equal(nk.philox_words(4, seed=3, offset=2, device="cpu",
                                       group_base=6), whole[6:])
    with pytest.raises(ValueError, match="element_base"):
        nk.normal_plain(4, seed=0, offset=0, device="cpu", element_base=-1)


# ----------------------------------------------- distributed and the mesh


def test_single_process_defaults(monkeypatch):
    for name in ("D3F_COORDINATOR", "D3F_NUM_PROCESSES", "D3F_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize_from_env() is False
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0 and distributed.is_primary()
    assert distributed.local_batch_size(16) == 16
    assert distributed.data_shard() is None
    assert create_mesh() == training_mesh(1) == Mesh()
    tree = {"a": torch.arange(3), "b": [torch.ones(2), 5]}
    got = distributed.fetch_local(tree)
    assert np.array_equal(got["a"], np.arange(3)) and got["b"][1] == 5


def test_env_partial_config_rejected(monkeypatch):
    monkeypatch.setenv("D3F_COORDINATOR", "localhost:9999")
    monkeypatch.delenv("D3F_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="D3F_NUM_PROCESSES"):
        distributed.maybe_initialize_from_env()


def test_batch_and_coordinator_checks(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="divisible by process_count 3"):
        distributed.local_batch_size(16)
    with pytest.raises(ValueError, match="host:port"):
        distributed.initialize("nohost", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        distributed.initialize("file:///x", 2, 2, device="cpu")


def test_mesh_refusals():
    """One process refuses a data or spatial axis above 1 (it drives one
    device); spatial_parallel > 1 refuses the families outside the resnet
    family and the patchified U-Net, naming ROADMAP A9c."""
    with pytest.raises(ValueError, match="launch 2 processes"):
        create_mesh(2)
    with pytest.raises(ValueError, match="launch 2 processes"):
        create_mesh(None, spatial=2)
    with pytest.raises(ValueError, match="launch 4 processes"):
        create_mesh(2, spatial=2, encoder_name="resnet50")
    for name in ("efficientnet-b0", "densenet121"):
        with pytest.raises(NotImplementedError, match="A9c"):
            create_mesh(None, spatial=2, encoder_name=name)
    with pytest.raises(NotImplementedError, match="A9c"):
        create_mesh(None, spatial=2, encoder_name="resnet18", patchify=2)


@pytest.mark.parametrize("trainer", [DenoiserTrainer, DeepFakeTrainer,
                                     BalanceTrainer])
def test_trainers_refuse_spatial_and_one_process_data_parallel(trainer):
    """What still refuses spatial_parallel > 1 in each trainer: the
    families outside the resnet family and patchify_stem (A9c), JAX's
    i420 and device-cache refusals; and one process for a data axis."""
    cls = {DenoiserTrainer: config.DenoiserConfig,
           DeepFakeTrainer: config.DeepFakeConfig,
           BalanceTrainer: config.BalanceConfig}[trainer]
    base = dict(input_image_list_path="x", data_path="x", data_path_a="a",
                data_path_b="b", batch_size=4, encoder_name="resnet18")
    fields = {f.name for f in dataclasses.fields(cls)}
    spatial = dict(spatial_parallel=2)
    for knobs, err, match in (
            (dict(spatial, encoder_name="efficientnet-b0"),
             NotImplementedError, "A9c"),
            (dict(spatial, encoder_name="densenet121"), NotImplementedError,
             "A9c"),
            (dict(spatial, patchify_stem=2), NotImplementedError, "A9c"),
            (dict(spatial, upload_format="i420"), ValueError, "i420"),
            (dict(spatial, data_cache="device"), ValueError,
             "data_cache='host' with spatial_parallel"),
            (dict(spatial, image_size=63), ValueError, "spatial_parallel"),
            (dict(spatial), ValueError, "launch 2 processes"),
            (dict(data_parallel=2), ValueError, "launch 2 processes")):
        cfg = config.config_from_dict(cls, {
            k: v for k, v in {**base, **knobs}.items() if k in fields},
            validate=False)
        with pytest.raises(err, match=match):
            trainer(cfg, steps_per_epoch=1, image_size=SIZE, device="cpu")


def test_shard_batch_keeps_a_ranks_rows():
    mesh = Mesh(data=2, rank=1, world=2)
    x = torch.arange(8).reshape(4, 2)
    assert torch.equal(shard_batch(x, mesh), x[2:])
    tree = {"a": np.arange(6), "m": [torch.zeros((4, 3))], "n": None}
    got = shard_batch(tree, mesh)
    assert np.array_equal(got["a"], [3, 4, 5]) and got["n"] is None
    assert got["m"][0].shape == (2, 3)
    masks = torch.arange(12).reshape(3, 4)
    assert torch.equal(shard_batch(masks, mesh, dim=1), masks[:, 2:])
    with pytest.raises(ValueError, match="over 2 ranks"):
        shard_batch(torch.zeros(3), mesh)
    one = Mesh()
    assert shard_batch(x, one) is x


def test_collectives_outside_a_group_are_identities():
    model = torch.nn.Linear(3, 2)
    model(torch.ones(1, 3)).sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    x = torch.ones(3, requires_grad=True)
    with collectives.recording() as calls:
        assert collectives.all_reduce_(x, None) is x
        assert collectives.all_reduce_(x, Mesh()) is x
        collectives.all_reduce_grads_(model, Mesh())
        metrics = {"loss": torch.tensor(0.5)}
        assert collectives.mean_metrics(metrics, Mesh()) is metrics
        collectives.broadcast_tensors_([x], Mesh())
        assert collectives.allgather_flags(True, Mesh()) == [True]
        assert collectives.broadcast_one(7, Mesh()) == 7
    assert calls == []
    assert all(torch.equal(g, p.grad)
               for g, p in zip(grads, model.parameters()))


def test_rank_selects_its_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    assert port_device.resolve_device() == torch.device("cuda", 1)
    assert port_device.resolve_device("cuda") == torch.device("cuda", 1)
    assert port_device.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_k_step_graph_refuses_gloo_before_capture(monkeypatch):
    step = multi_step.make_super_step(
        lambda states, batch, row, gen: {}, 2, scalars=lambda s, j: {},
        advance=lambda s, k: None, generator=None, device="cuda")
    monkeypatch.setattr(multi_step.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(multi_step.dist, "get_backend", lambda: "gloo")
    with pytest.raises(RuntimeError, match="gloo backend cannot"):
        step(None, torch.zeros(1), torch.zeros(1))


# ------------------------------------------------------------------ audit


def test_census_policy_on_hand_made_calls():
    mib = 1 << 20
    calls = [("all-reduce", 128 * 256 * 4, "float32[32768]"),
             ("all-reduce", (64 + 32) * 4, "float32[96]"),
             ("all-gather", 4, "int32[1]"),
             ("all-gather", 16 * 448 * 448 * 16 * 2, "bfloat16[...]"),
             ("collective-permute", mib, "float32[262144]"),
             ("broadcast", 8, "int64[1]")]
    c = collective_census(calls)
    assert c["all-reduce"].count == 2
    assert c["all-reduce"].total_bytes == 128 * 256 * 4 + (64 + 32) * 4
    assert c["all-gather"].count == 2
    assert c["all-gather"].max_bytes == 16 * 448 * 448 * 16 * 2
    v = census_violations(c, spatial=False)
    assert any("collective-permute" in x for x in v)
    assert any("all-gather" in x for x in v)
    assert not census_violations(
        {**c, "collective-permute": collective_census([])[
            "collective-permute"]}, spatial=False,
        allgather_limit_bytes=1 << 30)
    assert census_violations(collective_census([]), spatial=False) == [
        "no all-reduce in the compiled step: gradients are not being "
        "reduced over the data axis"]
    summary = census_summary(c)
    assert summary["broadcast"] == {"count": 1, "total_mib": 0.0,
                                    "max_mib": 0.0}
    assert "all-to-all" not in summary


# ---------------------------------------------------------------- loader


def test_loader_shard_partitions_manifest(tmp_path):
    manifest = make_image_dataset(tmp_path, n=10, size=8, seed=0)
    full = ImageLoader(manifest, 2, shuffle=False)
    shard0 = ImageLoader(manifest, 2, shuffle=False, shard=(0, 2))
    shard1 = ImageLoader(manifest, 2, shuffle=False, shard=(1, 2))
    assert len(shard0.paths) == 5 and len(shard1.paths) == 5
    assert sorted(shard0.paths + shard1.paths) == sorted(full.paths)
    assert set(shard0.paths).isdisjoint(shard1.paths)
    assert shard1.paths == JaxLoader(manifest, 2, shuffle=False,
                                     use_native=False, shard=(1, 2)).paths


def test_loader_shards_equal_length_on_uneven_manifest(tmp_path):
    manifest = make_image_dataset(tmp_path, n=7, size=8, seed=0)
    shard0 = ImageLoader(manifest, 2, shuffle=False, shard=(0, 2))
    shard1 = ImageLoader(manifest, 2, shuffle=False, shard=(1, 2))
    assert len(shard0.paths) == len(shard1.paths) == 3
    assert shard0.batches_per_epoch == shard1.batches_per_epoch
    with pytest.raises(ValueError, match="every process"):
        ImageLoader(manifest, 1, shuffle=False, shard=(0, 8))


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A denoise-mode pair at 32^2, saved by the port's manager."""
    tmp = tmp_path_factory.mktemp("replicas")
    cfg = config.config_from_dict(config.DeepFakeConfig, dict(
        mode="denoise", data_path_a="a", data_path_b="b", batch_size=4,
        encoder_name="resnet18", compute_dtype="float32", image_size=SIZE))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=SIZE,
                              device="cpu")
    CheckpointManager(tmp / "ckpt").save(
        1, trainer.init_states(seed=0), dataclasses.asdict(cfg))
    return tmp / "ckpt"


def test_engine_replicas_match_one_device(checkpoint):
    """devices=2: two replicas off one queue (sharing the CPU); the
    single-pass swap gives each frame the bits the devices=1 engine
    gives it."""
    kw = dict(height=SIZE, width=SIZE, batch_size=4, device="cpu")
    single = SwapEngine(checkpoint, "a", max_wait_ms=1.0, **kw)
    multi = SwapEngine(checkpoint, "a", max_wait_ms=2.0, devices=2, **kw)
    try:
        multi.warmup()
        rng = np.random.default_rng(5)
        frames = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                  for _ in range(8)]
        results = [None] * len(frames)

        def call(i):
            results[i] = multi.swap(frames[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = multi.stats()
        assert stats["devices"] == 2 and stats["frames"] == len(frames) + 1
        assert stats["max_queue_frames"] == 8 * 4 * 2
        for f, r in zip(frames, results):
            assert np.array_equal(r, single.swap(f))
    finally:
        multi.close()
        single.close()
    assert not any(d.thread.is_alive() for d in multi._dispatchers)


def test_ddim_streams_fold_in_the_replica(checkpoint):
    model = inference.load_swap_model(checkpoint, "a", device="cpu")
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    outs = [inference.make_device_pipeline(
        model, sampler_steps=2, seed=3, replica=r)(frames, 4)
        for r in (0, 1)]
    base = inference.make_device_pipeline(model, sampler_steps=2, seed=3)
    assert torch.equal(outs[0], base(frames, 4))
    assert not torch.equal(outs[0], outs[1])
