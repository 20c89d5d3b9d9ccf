"""The port's Trainer with patchified=True: the p64 stems it builds, the
configs it refuses, and one patchified + remat epoch against the canonical
epoch on the same weights (the tree of
test_torch_port_trainer_common.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.train import Trainer, make_config

from test_torch_port_trainer_common import (  # noqa: F401 (fixtures)
    NARROW, _cfg_kw, _one_epoch, _port_model, _small_trainer, tree)


@pytest.mark.parametrize("exp_type,stem", [("taf_bfm", "BinsFusionModule"),
                                           ("basic", "FocusPatched")])
def test_trainer_builds_the_p64_stems(tree, tmp_path, exp_type, stem):
    cfg = make_config(exp_type, patchified=True, remat=True,
                      **_cfg_kw(tree, tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert type(trainer.model.backbone.stem).__name__ == (
        "BinsFusionModulePatched" if stem == "BinsFusionModule" else stem)


@pytest.mark.parametrize("field,value", [
    ("stem", "bfm_folded"), ("family", "yolov3"), ("family", "red"),
    ("memory", "convlstm")])
def test_trainer_refuses_patchified_without_a_p64_path(tree, tmp_path,
                                                       field, value):
    cfg = make_config("taf_bfm", patchified=True, **_cfg_kw(tree, tmp_path))
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match="patchified"):
        Trainer(cfg, device="cpu")


def test_trainer_patchified_epoch_equals_canonical(tree, tmp_path):
    """One epoch with patchified=True and remat=True (the bfm_p64 stem, the
    steps patchifying) from the canonical model's weights, dropout 0: each
    step's losses within rtol 2e-4 of the canonical epoch's."""
    canon = _port_model(generator=torch.Generator().manual_seed(0))
    p64 = build_detector(2, stem="bfm_p64", train=True, dropout_rate=0.0,
                         **NARROW)
    p64.load_state_dict(canon.state_dict())
    want = _one_epoch(_small_trainer(tree, tmp_path, "canon", model=canon,
                                     max_epoch_to_stop=1))
    got = _one_epoch(_small_trainer(tree, tmp_path, "p64", model=p64,
                                    max_epoch_to_stop=1, patchified=True,
                                    remat=True))
    for g, w in zip(got["losses"], want["losses"]):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=2e-4, err_msg=k)

