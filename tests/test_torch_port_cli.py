"""The port's entries cli/train.py and cli/test.py: the flag mapping of the
repository's train.py / test.py (tests/test_cli.py), --patchified and
--remat included, less the JAX-only --rng_impl, plus --device and the
geometry overrides; one end-to-end run on the CPU (a narrow AED in place of the
full-width one, as tests/test_cli.py's SmallTrainer does); the card rule;
and the `python -m` entries."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.cli import test as cli_test
from frlw_evd_tpu_torch.cli import train as cli_train
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.models import build_detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSOR, INPUT = (120, 152), (128, 160)


class _SpyTrainer:
    """Records the config and the device instead of training."""

    last = None
    called = None

    def __init__(self, cfg, *, device="cuda"):
        type(self).last = (cfg, device)

    def train(self):
        type(self).called = "train"

    def test(self):
        type(self).called = "test"
        return (0.0,) * 6


def test_train_cli_flag_mapping(monkeypatch, tmp_path):
    monkeypatch.setattr(cli_train, "Trainer", _SpyTrainer)
    cli_train.main([
        "--exp_type", "taf_bfm", "--dataset", "gen4",
        "--batch_size", "8", "--num_cpu_workers", "3",
        "--data_path", str(tmp_path / "d"), "--bbox_path", str(tmp_path / "b"),
        "--log_path", str(tmp_path / "log"), "--event_volume_bins", "8",
        "--exp_name", "smoke", "--augmentation", "False",
        "--max_epoch_to_stop", "2", "--seed", "7", "--nodes", "1",
        "--device", "cpu", "--img_size", "64", "96", "--sensor_hw", "60",
        "76"])
    cfg, device = _SpyTrainer.last
    assert _SpyTrainer.called == "train" and device == "cpu"
    assert cfg.exp_type == "taf_bfm" and cfg.dataset == "gen4"
    assert cfg.batch_size == 8 and cfg.num_workers == 3
    assert cfg.event_volume_bins == 8 and cfg.exp_name == "smoke"
    assert cfg.augmentation is False and cfg.max_epoch_to_stop == 2
    assert cfg.seed == 7 and cfg.stem == "bfm"
    assert cfg.img_size == (64, 96) and cfg.sensor_hw == (60, 76)
    assert cfg.patchified is False and cfg.remat is False
    with pytest.raises(SystemExit):
        cli_train.parse_args(["--data_path", "d", "--bbox_path", "b",
                              "--rng_impl", "rbg"])


def test_train_cli_passes_patchified_and_remat(monkeypatch, tmp_path):
    """--patchified and --remat (train.py:43-50) reach the config."""
    monkeypatch.setattr(cli_train, "Trainer", _SpyTrainer)
    cli_train.main(["--exp_type", "yolox_taf_bfm", "--data_path",
                    str(tmp_path / "d"), "--bbox_path", str(tmp_path / "b"),
                    "--patchified", "--remat", "--device", "cpu"])
    cfg, device = _SpyTrainer.last
    assert cfg.patchified is True and cfg.remat is True
    assert cfg.family == "yolox" and cfg.stem == "bfm" and device == "cpu"


def test_test_cli_flag_mapping(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cli_test, "Trainer", _SpyTrainer)
    cli_test.main([
        "--exp_type", "basic", "--dataset", "gen1",
        "--data_path", str(tmp_path / "d"), "--bbox_path", str(tmp_path / "b"),
        "--log_path", str(tmp_path / "log"), "--resume_exp", "smoke",
        "--record", "True"])
    cfg, device = _SpyTrainer.last
    assert _SpyTrainer.called == "test" and device == "cuda"
    assert cfg.batch_size == 1 and cfg.record is True
    assert cfg.resume_exp == "smoke" and cfg.augmentation is False
    assert cfg.img_size == (256, 320) and cfg.sensor_hw == (240, 304)
    assert "COCO stats" in capsys.readouterr().out


def _small(base):
    class SmallTrainer(base):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            self.model = build_detector(
                cfg.num_classes, stem=cfg.stem, in_channels=(32, 32, 32),
                stem_out_channels=16, head_width=32,
                input_channels=cfg.input_channels, train=True)
    return SmallTrainer


def test_clis_end_to_end_on_the_cpu(monkeypatch, tmp_path, capsys):
    tree = synthetic.build_mini_gen1(
        str(tmp_path / "data"), np.random.default_rng(1),
        sensor_hw=SENSOR, input_hw=INPUT, blobs=("taf",))
    monkeypatch.setattr(cli_train, "Trainer", _small(cli_train.Trainer))
    monkeypatch.setattr(cli_test, "Trainer", _small(cli_test.Trainer))
    common = ["--exp_type", "taf_bfm", "--dataset", "gen1",
              "--event_volume_bins", "8", "--data_path", tree["taf_dir"],
              "--bbox_path", tree["labels"], "--log_path",
              str(tmp_path / "log"), "--device", "cpu", "--img_size",
              *map(str, INPUT), "--sensor_hw", *map(str, SENSOR),
              "--batch_size", "2", "--num_cpu_workers", "2"]
    trainer = cli_train.main(common + ["--exp_name", "cli",
                                       "--augmentation", "False",
                                       "--max_epoch_to_stop", "1"])
    ckpt = tmp_path / "log" / "cli" / "checkpoints"
    assert (ckpt / "last_epoch").exists() and (ckpt / "best_epoch").exists()
    assert trainer.device == torch.device("cpu") and trainer.epoch == 1
    stats = cli_test.main(common + ["--resume_exp", "cli", "--record",
                                    "True"])
    assert len(stats) == 6 and all(np.isfinite(stats))
    out = capsys.readouterr().out
    assert f"COCO stats: {stats}" in out
    assert (tmp_path / "log" / "cli" / "summarise.npz").exists()


def test_clis_ask_for_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--data_path", str(tmp_path), "--bbox_path", str(tmp_path),
            "--log_path", str(tmp_path / "log")]
    for cli in (cli_train, cli_test):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(args)


def test_module_entries_run(tmp_path):
    """`python -m` on the entries: the folder evaluator scores a folder
    against itself (every stat 1 where defined), the CLIs print usage."""
    from frlw_evd_tpu_torch.events.box_loading import array_to_boxes

    rng = np.random.default_rng(0)
    for sub in ("gt", "dt"):
        (tmp_path / sub).mkdir()
    for i in range(2):
        n = 6
        rows = np.stack([np.full(n, 600_000 + 10_000 * i),
                         rng.uniform(0, 200, n), rng.uniform(0, 150, n),
                         rng.uniform(20, 60, n), rng.uniform(20, 60, n),
                         rng.integers(0, 2, n), np.arange(1, n + 1),
                         np.ones(n)], -1)
        for sub in ("gt", "dt"):
            np.save(tmp_path / sub / f"f{i}_bbox.npy", array_to_boxes(rows))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "frlw_evd_tpu_torch.evaluate.psee_evaluator",
         str(tmp_path / "gt"), str(tmp_path / "dt")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "COCO stats: (1.0, 1.0, 1.0" in res.stdout
    for mod in ("cli.train", "cli.test", "tools.generate_taf",
                "tools.stream_infer"):
        res = subprocess.run(
            [sys.executable, "-m", f"frlw_evd_tpu_torch.{mod}", "--help"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0 and "usage" in res.stdout, mod
