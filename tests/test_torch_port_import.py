"""The reference .pth import and the backbone freeze of the port
(train/checkpoints.py: import_torch_checkpoint, default_rename,
freeze_backbone_tx) on the CPU.

The checkpoint is the miniature reference-named model of
tests/test_torch_import.py (Focus stem, Darknet Sequential groups, PAFPN,
YOLOX head ModuleLists; 16 / 32 wide, 4 input channels, 64x64), its
BatchNorm statistics moved by three training forwards, saved as
{"state_dict": {"module." + key: tensor}, "epoch": 7}. No released
FRLW-EvD checkpoint is in the repository, so none is read. Gates: every
key but num_batches_tracked loaded and none unmatched; the port's forward
within 2e-4 of the miniature's (the torch-import parity gate); the port's
state_dict equal, bit for bit, to the JAX package's import of the same
file carried by weights.flax_to_state_dict; default_rename equal to the
JAX importer's key map through weights.state_dict_key. Under
freeze_backbone_tx two Adam steps leave every backbone parameter bit for
bit as it was, while the neck and head parameters and the backbone's
BatchNorm statistics move.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.train.checkpoints import default_rename as j_default_rename
from frlw_evd_tpu.train.checkpoints import \
    import_torch_checkpoint as j_import_torch_checkpoint
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.train import (adam, create_train_state,
                                      default_rename, freeze_backbone_tx,
                                      import_torch_checkpoint,
                                      make_train_step)
from frlw_evd_tpu_torch.weights import flax_to_state_dict, state_dict_key
from test_torch_import import C_IN, CH, H, NUM_CLASSES, W, TModel

MINI = dict(in_channels=(CH * 2,) * 3, stem_out_channels=CH,
            head_width=CH * 2, input_channels=C_IN)
FWD_TOL = 2e-4
STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the miniature reference model in eval mode, its .pth path)."""
    torch.manual_seed(0)
    tmodel = TModel()
    with torch.no_grad():
        for _ in range(3):
            tmodel.train()(torch.randn(2, C_IN, H, W))
    tmodel.eval()
    path = tmp_path_factory.mktemp("pth") / "ckpt.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in
                               tmodel.state_dict().items()}, "epoch": 7},
               path)
    return tmodel, str(path)


def _imported(path, **kw):
    model = build_detector(NUM_CLASSES, stem="focus", **MINI, **kw)
    return model, import_torch_checkpoint(path, model)


def test_import_covers_every_key(reference):
    tmodel, path = reference
    model, report = _imported(path)
    sd = tmodel.state_dict()
    n_stats = sum(k.endswith("num_batches_tracked") for k in sd)
    assert report["unmatched"] == []
    assert report["loaded"] == len(sd) - n_stats
    assert report["skipped"] == n_stats
    ported = model.state_dict()
    for key, v in sd.items():
        name = default_rename("module." + key)
        if name is not None:
            torch.testing.assert_close(ported[name], v, rtol=0, atol=0,
                                       msg=key)
    assert {default_rename(k) for k in sd} - {None} == {
        k for k in ported if not k.endswith("num_batches_tracked")}


def test_forward_equals_the_miniature(reference):
    tmodel, path = reference
    model, _ = _imported(path)
    x = np.random.default_rng(0).uniform(0, 1, (2, C_IN, H, W)).astype(
        np.float32)
    with torch.no_grad():
        want = tmodel(torch.from_numpy(x))
        got = model.eval()(torch.from_numpy(x.transpose(0, 2, 3, 1)))
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t.permute(0, 2, 3, 1), rtol=0,
                                   atol=FWD_TOL)


def test_import_equals_jax_import(reference):
    _, path = reference
    model, _ = _imported(path)
    jm = jax_build(NUM_CLASSES, family="aed", stem="focus",
                   in_channels=(CH * 2,) * 3, stem_out_channels=CH,
                   head_width=CH * 2)
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, H, W, C_IN)), False)
    params, stats, report = j_import_torch_checkpoint(
        path, variables["params"], variables["batch_stats"])
    assert report["unmatched"] == []
    want = flax_to_state_dict({"params": params, "batch_stats": stats})
    got = model.state_dict()
    assert want.keys() == {k for k in got
                           if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_default_rename_is_the_jax_key_map(reference):
    tmodel, _ = reference
    keys = ["module." + k for k in tmodel.state_dict()] + [
        "backbone.stem.convs.0.weight_g", "backbone.stem.convs.2.weight_v",
        "backbone.stem.convs.1.bias", "backbone.stem.trans_up.weight",
        "backbone.stem.conv.bn.running_var", "head.cls_convs.2.1.conv.weight",
        "neck.C3_n4.m.0.conv2.bn.num_batches_tracked"]
    for key in keys:
        path = j_default_rename(key)
        want = None if path is None else state_dict_key(*path)
        assert default_rename(key) == want, key


def test_weight_norm_gain_takes_the_port_layout(tmp_path):
    """A reference weight-norm gain (O, 1, 1, 1) lands in the port's (O,)
    weight_g; a key of another size is unmatched, or raises when
    strict."""
    src = build_detector(NUM_CLASSES, stem="bfm", **MINI)
    sd = src.state_dict()
    gains = [k for k in sd if k.endswith("weight_g")]
    assert gains
    for k in gains:
        sd[k] = torch.rand(sd[k].shape[0], 1, 1, 1)
    path = tmp_path / "wn.pth"
    torch.save(sd, path)
    model = build_detector(NUM_CLASSES, stem="bfm", **MINI,
                           generator=torch.Generator().manual_seed(1))
    report = import_torch_checkpoint(str(path), model,
                                     rename_fn=lambda k: k)
    assert report["unmatched"] == [] and report["loaded"] == len(sd)
    for k in gains:
        torch.testing.assert_close(model.state_dict()[k], sd[k].reshape(-1),
                                   rtol=0, atol=0)
    torch.save({"head.obj_preds_0.bias": torch.zeros(3)}, path)
    assert import_torch_checkpoint(str(path), model, rename_fn=lambda k: k
                                   )["unmatched"] == ["head.obj_preds_0.bias"]
    with pytest.raises(KeyError):
        import_torch_checkpoint(str(path), model, rename_fn=lambda k: k,
                                strict=True)


def test_freeze_backbone_tx(reference):
    """Two Adam(1e-3) steps of the imported model in training mode under
    freeze_backbone_tx: the backbone's parameters bit for bit unchanged
    (no gradient reaches them), every neck and head parameter with a
    gradient moved, the backbone's BatchNorm statistics moved."""
    _, path = reference
    model, _ = _imported(path, train=True, dropout_rate=0.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, freeze_backbone_tx(adam(1e-3)),
                               device="cpu")
    step = make_train_step((8, 16, 32), NUM_CLASSES, 2.5, device="cpu")
    rng = np.random.default_rng(1)
    labels = np.zeros((2, 4, 5), np.float32)
    labels[:, :3] = [[0, 20, 24, 16, 12], [1, 40, 36, 20, 18],
                     [0, 30, 48, 12, 12]]
    for _ in range(2):
        imgs = rng.uniform(0, 1, (2, H, W, C_IN)).astype(np.float32)
        losses = step(state, torch.from_numpy(imgs),
                      torch.from_numpy(labels), torch.Generator())
        assert torch.isfinite(losses["total_loss"])
    assert state.step == 2
    after = model.state_dict()
    params = dict(model.named_parameters())
    n_moved = 0
    for k, p in params.items():
        if k.startswith("backbone."):
            assert p.grad is None, k
            torch.testing.assert_close(p.detach(), before[k], rtol=0,
                                       atol=0, msg=k)
        elif p.grad.abs().sum() > 0:
            # the cls tower of a level with no foreground gets no gradient
            assert not torch.equal(p.detach(), before[k]), k
            n_moved += 1
    assert n_moved > 0.8 * sum(not k.startswith("backbone.") for k in params)
    moved = [k for k in after if k.startswith("backbone.")
             and k.endswith(STATS) and not torch.equal(after[k], before[k])]
    assert len(moved) == sum(k.startswith("backbone.") and k.endswith(STATS)
                             for k in after)
