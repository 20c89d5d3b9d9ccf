"""Carry the JAX package's variables into the port's state_dict.

The port's modules carry the flax module names, so a flax path maps to a
state_dict key by joining it with dots and renaming the leaf:

  params      .../kernel (HWIO)   → .../weight (OIHW)
  params      bn/scale, bn/bias   → bn.weight, bn.bias
  batch_stats bn/mean, bn/var     → bn.running_mean, bn.running_var
  (any BatchNorm: `bn`, `bn1`, `c1_bn`, `conv3_bn`, ...)
  params      WeightNorm v (HWIO) → weight_v (OIHW, torch weight_norm layout)
  params      WeightNorm g, bias  → weight_g, bias
  params      Dense kernel (in, out) → Linear weight (out, in)
  params      Conv3d kernel (DHWIO)  → weight (OIDHW)
  params      LayerNorm scale, bias  → weight, bias
  (any LayerNorm: `norm`, `norm1`, `layer_norms_0`, `layer_norms_ref_0`)
  params      relative_position_bias_table → itself, unchanged

The input is the nested dict {"params": ..., "batch_stats": ...} of numpy
arrays (any float dtype; values are carried as float32). `flax_path` is the
inverse key map, in the (collection, path) form that the JAX package's
`train/checkpoints.import_torch_checkpoint` takes as `rename_fn`.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

TABLE = "relative_position_bias_table"
_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "v": "weight_v", "g": "weight_g", TABLE: TABLE}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
# the port's norm module names, whose `weight` is flax's `scale`:
# BatchNorms bn, bn<digits>, <anything>_bn; LayerNorms norm, norm<digits>,
# layer_norms_<i>, layer_norms_ref_<i>
_NORM_NAME = re.compile(r"bn\d*|.+_bn|norm\d*|layer_norms(_ref)?_\d+")
_FROM_TORCH = {("params", "weight_v"): "v", ("params", "weight_g"): "g",
               ("params", "bias"): "bias", ("params", TABLE): TABLE,
               ("batch_stats", "running_mean"): "mean",
               ("batch_stats", "running_var"): "var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_key(collection: str, path) -> str:
    """flax (collection, path tuple) → the port's state_dict key."""
    leaf_map = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    return ".".join((*path[:-1], leaf_map[path[-1]]))


def flax_path(key: str):
    """The port's state_dict key → (collection, flax path tuple), or None
    for keys without a flax counterpart (BatchNorm's num_batches_tracked).
    A `weight` is a BatchNorm's scale when its module is named as the
    port's BatchNorms and LayerNorms are (`bn`, `bn1`, `c1_bn`,
    `conv3_bn`, `norm1`, `layer_norms_ref_0`; _NORM_NAME), else a kernel."""
    *body, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", (*body, _FROM_TORCH[("batch_stats", leaf)])
    if leaf == "weight":
        return "params", (*body, "scale" if _NORM_NAME.fullmatch(body[-1])
                          else "kernel")
    return "params", (*body, _FROM_TORCH[("params", leaf)])


def flax_to_state_dict(variables) -> dict[str, torch.Tensor]:
    """JAX variables → {state_dict key: float32 tensor} in torch layouts."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            a = np.asarray(arr, dtype=np.float32)
            if a.ndim == 4:                       # HWIO → OIHW
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 5:                     # DHWIO → OIDHW
                a = a.transpose(4, 3, 0, 1, 2)
            elif a.ndim == 2 and path[-1] == "kernel":   # Dense (in, out)
                a = a.T
            out[state_dict_key(collection, path)] = torch.from_numpy(
                np.ascontiguousarray(a))
    return out


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy JAX variables into `model` in place; every parameter and
    running statistic must be covered, and every variable must be used."""
    sd = flax_to_state_dict(variables)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"flax variables do not match the model: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    return model
