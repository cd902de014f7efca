"""A configuration, a cell and a per-layer metric are added by new files
and new entries alone: the harness finds them by name."""

import hashlib
import json
import shutil

from bench_port import core


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_found_by_name(tmp_path):
    bench = tmp_path / "bench_port"
    shutil.copytree(core.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    spec = json.loads((core.ROOT / "BENCHMARK.json").read_text())

    config = json.loads((bench / "configs" / "unet_resnet34_448.json")
                        .read_text())
    config["hparams"]["encoder_name"] = "resnet50"
    (bench / "configs" / "unet_resnet50_448.json").write_text(
        json.dumps(config))
    (bench / "traffic" / "cached_k8.json").write_text(json.dumps(
        {"driver": "train_cached", "trainer": "denoiser",
         "steps_per_call": 8, "frames": 1024, "traced_groups": 2}))
    (bench / "workloads" / "train_r50_448_cached_k8.json").write_text(
        json.dumps({"limits": {"loss_gap_step1": 0.5}}))
    (bench / "metrics" / "train.groups_traced.py").write_text(
        "def read(ctx):\n    return ctx['steps'] / 8\n")
    spec["configs"].append({"name": "unet_resnet50_448", "source": "x",
                            "file": "bench_port/configs/unet_resnet50_448.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "train_r50_448_cached_k8",
                              "config": "unet_resnet50_448",
                              "traffic": "cached_k8", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("train_r50_448_cached_k8")
    spec["per_layer"].append({"name": "train.groups_traced", "unit": "1",
                              "better": "higher", "source": "device_trace",
                              "layer": "train step and models",
                              "moves": "train_imgs_per_s",
                              "workloads": ["train_r50_448_cached_k8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.load_cell("train_r50_448_cached_k8", root=tmp_path,
                          bench_dir=bench)
    assert cell.config["hparams"]["encoder_name"] == "resnet50"
    assert cell.traffic["steps_per_call"] == 8
    assert cell.limits == {"limits": {"loss_gap_step1": 0.5}}
    assert [m["name"] for m in cell.end_to_end] == ["train_imgs_per_s",
                                                    "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert "train.groups_traced" in names and "device_idle.swap" not in names
    assert cell.metric_reader("train.groups_traced")({"steps": 24}) == 3
    assert cell.driver().__name__ == "bench_driver_train_cached"
    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())


def test_every_cell_finds_its_files():
    spec = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = core.load_cell(w["name"])
        assert cell.limits["limits"]
        assert cell.driver().run
        for metric in cell.per_layer:
            assert callable(cell.metric_reader(metric["name"]))
