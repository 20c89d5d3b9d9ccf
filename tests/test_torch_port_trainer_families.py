"""The port's Trainer builds the model of every family and exp type (JAX
trainer.py:329-357), asks for the card by default, and trains `basic` on
port-made EV blobs and `yolox_taf_bfm` on the TAF blobs for one epoch on
the CPU (the tree of test_torch_port_trainer_common.py)."""

from __future__ import annotations

import os

import pytest
import torch

from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.train import Trainer, make_config

from test_torch_port_trainer_common import (  # noqa: F401 (fixtures)
    INPUT, NARROW, SENSOR, _cfg_kw, _one_epoch, _small_trainer, tree)


@pytest.mark.parametrize("field,value,model", [
    ("family", "yolov3", "YOLOv3Detector"), ("family", "red", "REDDetector"),
    ("memory", "convlstm", "MemoryEventDetector"),
    ("exp_type", "taf_swin", "EventDetector"),
    ("exp_type", "taf_corr", "EventDetector"),
    ("exp_type", "taf_syn", "EventDetector")])
def test_trainer_builds_the_family(tree, tmp_path, field, value, model):
    """The Trainer builds the model of the config's family (JAX
    trainer.py:329-357): the yolov3 detector with the BFM stem for stem
    bfm, RED, the memory detector with ConvLSTM cells over in_channels;
    the experimental exp types' AED with the swin or the correlation stem,
    and taf_syn's SwinDarknet (JAX config.py:140-142)."""
    if field == "exp_type":
        cfg = make_config(value, **_cfg_kw(tree, tmp_path))
    else:
        cfg = make_config("taf_bfm", **_cfg_kw(tree, tmp_path))
        setattr(cfg, field, value)
    built = Trainer(cfg, device="cpu").model
    assert type(built).__name__ == model
    assert built.training
    if value == "yolov3":
        assert type(built.backbone.layer_1).__name__ == "BinsFusionModule"
    if value == "convlstm":
        assert built.memory.lstms_2.hidden_dim == cfg.in_channels[2]
    if field == "exp_type":
        backbone, stem = {
            "taf_swin": ("Darknet", "TemporalActiveFocusSwin"),
            "taf_corr": ("Darknet", "TemporalActiveFocusCorr"),
            "taf_syn": ("SwinDarknet", "Focus")}[value]
        assert type(built.backbone).__name__ == backbone
        assert type(built.backbone.stem).__name__ == stem


def test_trainer_builds_every_jax_exp_type(tree, tmp_path):
    """Every exp type of JAX's EXP_TYPES (config.py:125-143) is the
    port's, and the port's Trainer builds each one's model."""
    from frlw_evd_tpu.train.config import EXP_TYPES as J_EXP_TYPES
    from frlw_evd_tpu_torch.train.config import EXP_TYPES
    assert EXP_TYPES == J_EXP_TYPES
    for exp_type in J_EXP_TYPES:
        cfg = make_config(exp_type, **_cfg_kw(tree, tmp_path))
        assert Trainer(cfg, device="cpu").model.training, exp_type


def test_trainer_asks_for_the_card(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(make_config("taf_bfm", **_cfg_kw(tree, tmp_path)))
    assert not os.path.exists(tmp_path / "taf_bfm")


def test_trainer_trains_basic_on_port_made_ev_blobs(tree, tmp_path,
                                                    monkeypatch):
    """`basic` (aed, focus stem, 5 bins: 10 channels) over the Event
    Volume blobs of tools.generate_eventvolume, run on the tree at its
    120x152 → 128x160 geometry."""
    from frlw_evd_tpu_torch.tools import generate_common
    from frlw_evd_tpu_torch.tools.generate_eventvolume import \
        generate_eventvolume

    monkeypatch.setitem(generate_common.GEOMETRY, "tree",
                        dict(shape=SENSOR, target_shape=INPUT))
    out = str(tmp_path / "blobs")
    stats = generate_eventvolume(tree["events"], tree["labels"], out,
                                 "tree", "cpu")
    assert stats["blobs"] == 3 * 3 * 6        # splits x windows x times
    model = build_detector(2, stem="focus", input_channels=10, train=True,
                           generator=torch.Generator().manual_seed(0),
                           **NARROW)
    trainer = _small_trainer(tree, tmp_path, "basic", exp_type="basic",
                             model=model, event_volume_bins=5,
                             max_epoch_to_stop=1,
                             data_path=os.path.join(out, "EventVolume250000"))
    assert trainer.cfg.input_channels == 10
    _one_epoch(trainer)


def test_trainer_trains_yolox_taf_bfm(tree, tmp_path):
    """`yolox_taf_bfm`: the Trainer builds CSPDarknet with the bfm stem;
    one epoch on the TAF blobs with its head narrowed to 32."""
    cfg = make_config("yolox_taf_bfm", exp_name="built",
                      **_cfg_kw(tree, tmp_path))
    built = Trainer(cfg, device="cpu").model
    assert type(built.backbone).__name__ == "CSPDarknet"
    assert type(built.backbone.stem).__name__ == "BinsFusionModule"
    model = build_detector(2, family="yolox", stem="bfm", head_width=32,
                           dropout_rate=0.0, input_channels=16, train=True,
                           generator=torch.Generator().manual_seed(0))
    _one_epoch(_small_trainer(tree, tmp_path, "yolox",
                              exp_type="yolox_taf_bfm", model=model,
                              max_epoch_to_stop=1))

