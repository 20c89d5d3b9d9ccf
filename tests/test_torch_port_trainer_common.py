"""Shared fixtures and helpers of the Trainer tests
(test_torch_port_trainer*.py): the synthetic tree at twice the mini
fixture's scale (120x152 sensor, 128x160 input: at 60x76 the GEN1
evaluation filter drops every box, so the COCO stats would all be -1), the
JAX and port Trainers on it with the port's weights carried from JAX's,
and the small Trainer of one epoch. Holds no test.

The variables of `pair` are JAX's init with BatchNorm scales U(1, 1.25)
and biases N(0, 0.1), the obj biases 2.0 and the box-size biases log 8,
so that boxes pass conf 0.3, of a size the GEN1 filter keeps, and some
overlap the ground truth.

The train-step tests (test_torch_port_remat_patchify.py,
_patchify_jax.py, _run_train.py) share the tiny AED `base` (dropout 0.1,
torch seed 0) and chip_smoke.small_train_batch's `batch`.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as j_build_detector
from frlw_evd_tpu.train import Trainer as JTrainer
from frlw_evd_tpu.train import make_config as j_make_config
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.train import Trainer, make_config
from frlw_evd_tpu_torch.weights import load_flax_variables


SENSOR, INPUT = (120, 152), (128, 160)
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
DET_TOL, STATS_TOL, SAME_DETS_TOL = 1e-4, 1e-3, 1e-12


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthetic.build_mini_gen1(
        str(tmp_path_factory.mktemp("tree")), np.random.default_rng(0),
        sensor_hw=SENSOR, input_hw=INPUT, blobs=("taf",))


def _cfg_kw(tree, log_path, **kw):
    return {**dict(dataset="gen1", batch_size=2, num_workers=1,
                   event_volume_bins=8, augmentation=False,
                   half_precision=False, img_size_override=INPUT,
                   sensor_hw_override=SENSOR, data_path=tree["taf_dir"],
                   bbox_path=tree["labels"], log_path=str(log_path)), **kw}


def _port_model(**kw):
    return build_detector(2, stem="bfm", train=True, dropout_rate=0.0,
                          **NARROW, **kw)


def _serving_params(params, rng):
    flat = {}
    for path, a in flatten_dict(jax.tree.map(np.array, params)).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 1.25, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = 2.0
        elif path[-2].startswith("reg_preds_") and path[-1] == "bias":
            a[:] = [0.0, 0.0, np.log(8.0), np.log(8.0)]
        flat[path] = a
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def pair(tree, tmp_path_factory):
    """(JAX Trainer, port Trainer) built on the tree, the port's weights
    carried from JAX's."""
    logs = tmp_path_factory.mktemp("logs")
    j_cfg = j_make_config("taf_bfm", exp_name="jax", **_cfg_kw(tree, logs))
    jt = JTrainer(j_cfg)
    jt.model = j_build_detector(2, stem="bfm", **NARROW)
    jt.create_datasets()
    jt.build(len(jt.train_loader))
    params = _serving_params(jt.state.params, np.random.default_rng(0))
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, params))

    pt = Trainer(make_config("taf_bfm", exp_name="port",
                             **_cfg_kw(tree, logs)), device="cpu")
    pt.model = _port_model()
    pt.create_datasets()
    pt.build(len(pt.train_loader))
    load_flax_variables(pt.model, {
        "params": params,
        "batch_stats": jax.tree.map(np.array, jt.state.batch_stats)})
    return jt, pt


class _Tee:
    """The port's Evaluator, with each add_result also made on a JAX
    Evaluator of the same geometry."""

    def __init__(self, port, jax_ev):
        self.port, self.jax = port, jax_ev

    def add_result(self, *args):
        self.port.add_result(*args)
        self.jax.add_result(*args)

    def evaluate(self):
        self.jax_stats = self.jax.evaluate()
        return self.port.evaluate()


def _match(got, want, tol):
    """Each row of want within tol of a distinct row of got."""
    assert len(got) == len(want)
    free = list(range(len(got)))
    for row in want:
        err = [np.abs(got[j] - row).max() for j in free]
        assert err and min(err) <= tol, (row, min(err, default=None))
        free.pop(int(np.argmin(err)))



def _small_trainer(tree, log_path, name, exp_type="taf_bfm", model=None,
                   **kw):
    trainer = Trainer(make_config(exp_type, exp_name=name,
                                  **_cfg_kw(tree, log_path, **kw)),
                      device="cpu")
    trainer.model = model or _port_model(
        generator=torch.Generator().manual_seed(0))
    return trainer


def _one_epoch(trainer):
    """train() for one epoch; checks what it ran and wrote, returns the
    epoch's history entry."""
    trainer.train()
    assert [h["epoch"] for h in trainer.history] == [0]
    hist = trainer.history[0]
    assert hist["steps"] == 3
    assert all(np.isfinite(v) for lo in hist["losses"] for v in lo.values())
    assert len(hist["val"]["stats"]) == 6
    for name in ("last_epoch", "best_epoch"):
        assert os.path.exists(os.path.join(trainer.ckpt_dir, name)), name
    return hist



# -- the train-step tests' model and batch ------------------------------------

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import small_train_batch  # noqa: E402

H, W, C, NC = 64, 96, 16, 2
STRIDES = (8, 16, 32)
STATS = ("running_mean", "running_var")
LR = 1e-2


@pytest.fixture(scope="module")
def batch():
    return small_train_batch(np.random.default_rng(0))


@pytest.fixture(scope="module")
def base():
    """The tiny AED with dropout 0.1, weights from torch seed 0."""
    return build_detector(NC, stem="bfm", train=True, dropout_rate=0.1,
                          generator=torch.Generator().manual_seed(0),
                          **NARROW)
