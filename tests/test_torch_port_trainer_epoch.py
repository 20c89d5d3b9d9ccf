"""One train() epoch of the port's Trainer on the CPU with its checkpoints,
then a resumed run from last_epoch, with and without the EMA, and the
backbone part of the run's last save (the tree and the small Trainer of
test_torch_port_trainer_common.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.train import load_checkpoint, load_pretrained_backbone

from test_torch_port_trainer_common import (  # noqa: F401 (fixtures)
    _small_trainer, tree)


@pytest.mark.parametrize("use_ema", [False, True], ids=["masters", "ema"])
def test_train_epoch_and_resume(tree, tmp_path, use_ema):
    """One epoch (3 steps at batch 2) of train(), its checkpoints, then a
    resumed run from last_epoch: the epoch, the step count, the weights
    (and the EMA) picked up where they were."""
    first = _small_trainer(tree, tmp_path, "run", max_epoch_to_stop=1,
                           use_ema=use_ema)
    first.train()
    ckpt = tmp_path / "run" / "checkpoints"
    for name in ("last_epoch", "best_epoch", "last_epoch_backbone.pth",
                 "last_epoch_neck.pth"):
        assert (ckpt / name).exists(), name
    assert [h["epoch"] for h in first.history] == [0]
    hist = first.history[0]
    assert hist["steps"] == 3 and len(hist["losses"]) == 3
    assert all(np.isfinite(v) for lo in hist["losses"] for v in lo.values())
    assert 0 <= hist["loader_wait_s"] <= hist["wall_s"]
    assert len(hist["val"]["stats"]) == 6 and first.state.step == 3
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    ema = None if first.ema_params is None else {
        k: v.clone() for k, v in first.ema_params.items()}

    second = _small_trainer(tree, tmp_path, "run", max_epoch_to_stop=1,
                            use_ema=use_ema, resume_exp="run")
    second.create_datasets()
    second.build(len(second.train_loader))
    state, epoch, score = load_checkpoint(str(ckpt / "last_epoch"),
                                          second.state, second.ema_params)
    # last_epoch is saved before the epoch's validation, as in JAX
    assert epoch == 1 and state.step == 3 and score == -1.0
    for k, v in second.model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    if use_ema:
        for k, v in second.ema_params.items():
            torch.testing.assert_close(v, ema[k], rtol=0, atol=0)
        assert not torch.equal(ema["head.obj_preds_0.weight"],
                               saved["head.obj_preds_0.weight"])

    resumed = _small_trainer(tree, tmp_path, "run", max_epoch_to_stop=2,
                             use_ema=use_ema, resume_exp="run")
    resumed.train()
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.state.step == 6 and resumed.epoch == 2

    # the backbone part of the run directory's last save (the resumed run's)
    part = _small_trainer(tree, tmp_path, "part")
    part.build(1)
    load_pretrained_backbone(str(ckpt / "last_epoch_backbone"), part.state)
    want = resumed.model.backbone.state_dict()
    for k, v in part.model.backbone.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)

