"""Checkpoint save and load as native .pth (counterpart of
frlw_evd_tpu/train/checkpoints.py::save_checkpoint, load_checkpoint).

One file holds the model's state_dict (f32 masters and BatchNorm
statistics), the optimiser's, the EMA parameters when kept, the update
count, the epoch and the best score. It is written to a temporary file
beside the target and moved over it with os.replace, so a crash leaves the
previous checkpoint whole. The transfer parts (save_part_checkpoints,
load_pretrained_backbone) are .pth files of the backbone's and the neck's
parameters and BatchNorm statistics. `import_torch_checkpoint` loads the
upstream reference's .pth state_dict into a port model: `default_rename`
maps each reference key to the flax path of the JAX package's importer
(the same `_map_sequential`, `_DEPTH2BLOCKS` and `_BN_MAP`) and that path
to the port's key through weights.state_dict_key. `freeze_backbone_tx`
leaves the backbone's parameters out of an optimiser recipe.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Callable, Optional

import torch
from torch import nn

from ..weights import state_dict_key

if TYPE_CHECKING:
    from .trainer import TrainState, Tx


def _save(obj, path: str) -> None:
    """torch.save to a temporary file beside `path`, moved over it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    max_score: float,
                    ema: Optional[dict[str, torch.Tensor]] = None) -> None:
    _save({"model": state.model.state_dict(),
           "optimizer": state.optimizer.state_dict(),
           "ema": ema, "step": state.step, "epoch": epoch,
           "max_score": max_score}, path)


def load_checkpoint(path: str, state: TrainState,
                    ema: Optional[dict[str, torch.Tensor]] = None):
    """Load `path` into `state` (and into `ema` in place, when given) on
    the state's device. Returns (state, the epoch to resume at, max_score),
    as the JAX function does."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if ema is not None:
        if ckpt["ema"] is None:
            raise KeyError(f"{path} holds no EMA parameters")
        with torch.no_grad():
            for k, e in ema.items():
                e.copy_(ckpt["ema"][k])
    return state, ckpt["epoch"] + 1, ckpt.get("max_score", 0.0)


PARTS = ("backbone", "neck")


def _part_path(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".pth") else path + ".pth"


def save_part_checkpoints(path_prefix: str, state: TrainState) -> None:
    """Per-part checkpoints for transfer (checkpoints.py:304-327, reference
    saveCheckpoint:204-210): <path_prefix>_backbone.pth and
    <path_prefix>_neck.pth, each the part's state_dict (parameters and
    BatchNorm statistics, keys relative to the part)."""
    for part in PARTS:
        module = getattr(state.model, part, None)
        if module is not None:
            _save(module.state_dict(), f"{path_prefix}_{part}.pth")


def load_pretrained_backbone(path: str, state: TrainState) -> TrainState:
    """Load a backbone part (`path`, with or without .pth) into the state's
    model in place (checkpoints.py:330-351, reference loadPretrained,
    core/exp.py:178-193). Returns the state."""
    part = _part_path(path)
    if not os.path.exists(part):
        raise FileNotFoundError(f"no checkpoint found at '{path}'")
    device = next(state.model.parameters()).device
    state.model.backbone.load_state_dict(
        torch.load(part, map_location=device, weights_only=True))
    return state


# ---------------------------------------------------------------------------
# the reference's .pth (checkpoints.py:133-280)
# ---------------------------------------------------------------------------

_BN_MAP = {
    "weight": ("scale", "params"),
    "bias": ("bias", "params"),
    "running_mean": ("mean", "batch_stats"),
    "running_var": ("var", "batch_stats"),
    "num_batches_tracked": (None, None),
}

_DEPTH2BLOCKS = {21: [1, 2, 2, 1], 53: [2, 8, 8, 4]}


def _map_sequential(module: str, idx: int, depth: int = 21):
    """Reference nn.Sequential index → the named submodule.

    dark2..dark4: [BaseConv, ResLayer*n] → conv / res_{i-1}.
    dark5: [BaseConv, ResLayer*n, conv1, conv2, SPP, conv3, conv4]
      → (dark5_group, conv / res_{i-1}) then (dark5_spp, conv1..4 / spp).
    """
    blocks = dict(zip(["dark2", "dark3", "dark4", "dark5"],
                      _DEPTH2BLOCKS[depth]))
    if module in ("dark2", "dark3", "dark4"):
        return (module, "conv") if idx == 0 else (module, f"res_{idx - 1}")
    if module == "dark5":
        n = blocks["dark5"]
        if idx == 0:
            return ("dark5_group", "conv")
        if idx <= n:
            return ("dark5_group", f"res_{idx - 1}")
        spp_names = ["conv1", "conv2", "spp", "conv3", "conv4"]
        return ("dark5_spp", spp_names[idx - n - 1])
    return (module, str(idx))


def _flax_path(torch_key: str, depth: int = 21):
    """Reference AED key → (collection, flax path tuple) or None, as the
    JAX package's default_rename (checkpoints.py:208-270)."""
    body = torch_key.removeprefix("module.").split(".")
    leaf, body = body[-1], body[:-1]
    if leaf == "num_batches_tracked":
        return None
    out = []
    i = 0
    while i < len(body):
        p = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else ""
        # darknet sequential groups
        if p in ("dark2", "dark3", "dark4", "dark5") and nxt.isdigit():
            out.extend(_map_sequential(p, int(nxt), depth))
            i += 2
        # CSP bottleneck list m.<i> → m_<i>; BFM convs.<i> → convs_<i>;
        # head ModuleLists stems.0 → stems_0
        elif p in ("m", "convs", "stems", "cls_preds", "reg_preds",
                   "obj_preds") and nxt.isdigit():
            out.append(f"{p}_{nxt}")
            i += 2
        # cls_convs.0.1 → cls_convs_0_1
        elif (p in ("cls_convs", "reg_convs") and nxt.isdigit()
              and i + 2 < len(body) and body[i + 2].isdigit()):
            out.append(f"{p}_{nxt}_{body[i + 2]}")
            i += 3
        else:
            out.append(p)
            i += 1
    if body and body[-1] == "bn":
        name, coll = _BN_MAP[leaf]
        return (coll, (*out, name))
    if leaf in ("weight_g", "weight_v"):
        return ("params", (*out, leaf[-1]))
    return ("params", (*out, "kernel" if leaf == "weight" else leaf))


def default_rename(torch_key: str, depth: int = 21) -> Optional[str]:
    """Reference AED state_dict key → the port's state_dict key, or None
    for keys without a counterpart (num_batches_tracked). Handles the
    Focus / BFM stems (weight-norm weight_g / weight_v included), the
    Darknet Sequential groups, the CSP m.<i> lists, the PAFPN names (1:1)
    and the head's stems / cls_convs / reg_convs / {cls,reg,obj}_preds
    ModuleLists."""
    path = _flax_path(torch_key, depth)
    return None if path is None else state_dict_key(*path)


def import_torch_checkpoint(pth_path: str, model: nn.Module,
                            rename_fn: Optional[Callable] = None,
                            strict: bool = False) -> dict:
    """Load a reference .pth (a state_dict, or a dict holding one under
    "state_dict") into `model` in place (checkpoints.py:156-196).

    rename_fn(reference key) → the port's key, or None to skip it
    (default_rename when None). Every tensor keeps torch's layout, except
    that a weight-norm weight_g (O, 1, 1, 1) becomes the port's (O,). A
    key whose target is missing or of another size is unmatched (a
    KeyError when strict). Returns {"loaded": count, "skipped": count,
    "unmatched": [keys]}."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    rename_fn = rename_fn or default_rename
    targets = model.state_dict()
    loaded, skipped, unmatched = 0, 0, []
    with torch.no_grad():
        for key, tensor in sd.items():
            name = rename_fn(key)
            if name is None:
                skipped += 1
                continue
            if key.endswith("weight_g"):
                tensor = tensor.reshape(-1)
            target = targets.get(name)
            if target is None or target.shape != tensor.shape:
                unmatched.append(key)
                if strict:
                    raise KeyError(f"no match for {key} → {name}")
                continue
            target.copy_(tensor)
            loaded += 1
    return {"loaded": loaded, "skipped": skipped, "unmatched": unmatched}


def freeze_backbone_tx(tx: Tx) -> Tx:
    """`tx` with every backbone.* parameter left out (checkpoints.py:353-363,
    optax set_to_zero on the backbone; the reference's loadPretrained meant
    to freeze it, but its `requries_grad` typo skipped that): `make` takes
    the model's (name, parameter) pairs, stops the gradient of each
    backbone parameter (requires_grad False) and builds `tx`'s optimiser
    over the rest. The backbone's BatchNorm running statistics still move
    in training, as JAX's batch_stats do."""
    from .trainer import Tx

    def make(named_params):
        trainable = []
        for name, p in named_params:
            if name.startswith("backbone."):
                p.requires_grad_(False)
            else:
                trainable.append((name, p))
        return tx.make(trainable)

    return Tx(make, tx.schedule)
