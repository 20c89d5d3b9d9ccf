"""The memory families of the port (models/memory.py: ConvLSTMCell,
ConvGRUCell, MemoryModel; models/detector.py: MemoryEventDetector,
rollout_memory_detector; the convlstm / recconv Trainer) against the JAX
package's on the CPU, f32.

Weights go across with weights.load_flax_variables: JAX's variables tree
(by eval_shape of its init) filled from a seed (seeded_variables). Carries are compared in
the JAX layout (NHWC). Gates: every cell, model and detector output and
carry within 2e-4 (the torch-import parity gate); the steps the
convlstm and recconv Trainers build, on a 16-wide detector, against JAX's
step functions: the eval step's detections within 1e-4, the train step's
losses within rtol 2e-4 and its BatchNorm statistics within 1e-5, in
f64. (The
epoch loop around the steps is the aed family's, held to JAX's Trainer in
test_torch_port_trainer.py; cli.train and cli.test drive every family in
test_torch_port_yolov3.py.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models.blocks import Focus as JFocus
from frlw_evd_tpu.models.darknet import Darknet as JDarknet
from frlw_evd_tpu.models.detector import \
    MemoryEventDetector as JMemoryEventDetector
from frlw_evd_tpu.models.detector import \
    rollout_memory_detector as j_rollout
from frlw_evd_tpu.models.heads import YOLOXHead as JYOLOXHead
from frlw_evd_tpu.models.memory import ConvGRUCell as JConvGRUCell
from frlw_evd_tpu.models.memory import ConvLSTMCell as JConvLSTMCell
from frlw_evd_tpu.models.memory import MemoryModel as JMemoryModel
from frlw_evd_tpu.models.pafpn import YOLOPAFPN as JYOLOPAFPN
from frlw_evd_tpu.train.trainer import TrainState as JTrainState
from frlw_evd_tpu.train.trainer import \
    make_memory_eval_step as j_make_memory_eval_step
from frlw_evd_tpu.train.trainer import \
    make_memory_train_step as j_make_memory_train_step
from frlw_evd_tpu_torch.models.detector import (build_memory_detector,
                                                rollout_memory_detector)
from frlw_evd_tpu_torch.models.memory import (ConvGRUCell, ConvLSTMCell,
                                              MemoryModel, carries_nchw,
                                              carries_nhwc)
from frlw_evd_tpu_torch.train import Trainer, make_config
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables

TOL = 2e-4
LOSS_RTOL, BN_TOL = 2e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for torch's CPU ops in the module (this one and
    the yolov3 and red files, which import it): the suite runs files in
    parallel workers, and each worker's default of one thread a core
    oversubscribes the cores (the full-width yolov3 steps ran 20x slower
    with four workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    """Nests of torch (NHWC) and JAX arrays, leaf by leaf."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        return
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0, err_msg=what)


def seeded_variables(module, rng, *args):
    """The variables tree of module.init(key, *args), its shapes by
    jax.eval_shape (nothing compiled: a jitted init of these models took
    7-12 s on the CPU), filled from rng: kernels N(0, 1 / fan_in),
    BatchNorm statistics, affines and biases as
    test_torch_port_detector.randomize_variables makes them from flax's
    zeros and ones."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            leaf = path[-1]
            if leaf == "kernel":
                v = rng.normal(0, 1 / np.sqrt(np.prod(a.shape[:-1])),
                               a.shape)
            elif leaf == "var":
                v = rng.uniform(0.5, 2.0, a.shape)
            elif leaf == "scale":
                v = rng.uniform(0.5, 1.5, a.shape)
            else:
                assert leaf in ("mean", "bias"), path
                v = rng.normal(0, 0.1, a.shape)
            flat[path] = v.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


def _cell_pair(kind, cin, hidden, x, stride=1):
    jm = (JConvLSTMCell(hidden, 3, stride) if kind == "convlstm"
          else JConvGRUCell(hidden))
    args = (None, jnp.asarray(x)) + ((False,) if kind == "convgru" else ())
    variables = seeded_variables(jm, np.random.default_rng(0), *args)
    tm = (ConvLSTMCell(cin, hidden, 3, stride) if kind == "convlstm"
          else ConvGRUCell(cin, hidden))
    return jm, variables, load_flax_variables(tm, variables).eval()


@pytest.mark.parametrize("kind,stride,hw", [
    ("convlstm", 1, (8, 12)), ("convlstm", 2, (9, 13)),
    ("convgru", 1, (8, 12))])
def test_cell_matches_flax_with_none_and_given_carries(kind, stride, hw):
    """A cell from a None carry, then from that step's carry (and from a
    random one), against flax's on the same variables."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, 12)).astype(np.float32)
    jm, variables, tm = _cell_pair(kind, 12, 16, x, stride)
    extra = (False,) if kind == "convgru" else ()

    def jrun(carry):
        return jm.apply(variables, carry, jnp.asarray(x), *extra)

    def trun(carry):
        with torch.no_grad():
            c, y = tm(carries_nchw(carry), torch.from_numpy(x)
                      .permute(0, 3, 1, 2))
        return carries_nhwc(c), y.permute(0, 2, 3, 1)

    j_carry, j_y = jrun(None)
    t_carry, t_y = trun(None)
    _close(t_carry, j_carry, f"{kind} carry from None")
    _close(t_y, j_y, f"{kind} output from None")
    given = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), j_carry)
    for label, carry in (("carried", j_carry), ("random", given)):
        j_c2, j_y2 = jrun(carry)
        t_c2, t_y2 = trun(jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), carry))
        _close(t_c2, j_c2, f"{kind} carry from a {label} carry")
        _close(t_y2, j_y2, f"{kind} output from a {label} carry")


def test_lstm_carry_promotes_to_the_wider_dtype():
    """bf16 weights and input with an f32 carry compute the state in f32,
    as flax promotes (the red family's f32 init_carries under bf16);
    init_carry floor-divides by the stride."""
    tm = ConvLSTMCell(8, 16, 3, 2).to(torch.bfloat16)
    x = torch.randn(1, 8, 9, 11, dtype=torch.bfloat16)
    carry = tm.init_carry(1, 10, 12)
    assert carry[0].shape == (1, 16, 5, 6) and carry[0].dtype == torch.float32
    (h, c), y = tm(carry, x)
    assert h.dtype == c.dtype == y.dtype == torch.float32
    (h, c), _ = tm(None, x)
    assert h.dtype == torch.bfloat16 and h.shape == (1, 16, 5, 6)


@pytest.mark.parametrize("kind", ["convlstm", "convgru"])
def test_memory_model_matches_flax(kind):
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(2, 16 // 2 ** i, 24 // 2 ** i, 16))
             .astype(np.float32) for i in range(3)]
    jm = JMemoryModel(kind, (16, 16, 16), act="relu")
    variables = seeded_variables(jm, np.random.default_rng(0), (None,) * 3,
                                 [jnp.asarray(f) for f in feats], False)
    tm = load_flax_variables(MemoryModel(kind, (16, 16, 16)),
                             variables).eval()
    j_c, j_out = jm.apply(variables, (None,) * 3,
                          [jnp.asarray(f) for f in feats], False)
    j_c2, j_out2 = jm.apply(variables, j_c, [jnp.asarray(f) for f in feats],
                            False)
    with torch.no_grad():
        t_feats = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
        t_c, t_out = tm((None,) * 3, t_feats)
        t_c2, t_out2 = tm(t_c, t_feats)
    _close(carries_nhwc(t_c), j_c, f"{kind} carries")
    _close(carries_nhwc(t_c2), j_c2, f"{kind} second carries")
    for got, want in ((t_out, j_out), (t_out2, j_out2)):
        _close([o.permute(0, 2, 3, 1) for o in got], list(want),
               f"{kind} outputs")


def _jax_memory_detector(kind, width=16, stem_out=16):
    ch = (width,) * 3
    return JMemoryEventDetector(
        backbone=JDarknet(depth=21, stem=JFocus, stem_out_channels=stem_out,
                          out_channels=ch),
        memory=JMemoryModel(kind, ch, act="relu"),
        neck=JYOLOPAFPN(depth=0.33, in_channels=ch),
        head=JYOLOXHead(num_classes=2, width=width))


@pytest.fixture(scope="module", params=["convlstm", "convgru"])
def detector_pair(request):
    kind = request.param
    jm = _jax_memory_detector(kind)
    variables = seeded_variables(jm, np.random.default_rng(0), None,
                                 jnp.zeros((1, 64, 96, 10)), False)
    tm = build_memory_detector(2, kind, in_channels=(16, 16, 16),
                               stem_out_channels=16, head_width=16,
                               input_channels=10)
    return kind, jm, variables, load_flax_variables(tm, variables).eval()


def test_memory_detector_rollout_matches_flax(detector_pair):
    """MemoryEventDetector at in_channels (16, 16, 16): one window from None
    carries, then rollout_memory_detector over T = 3 windows against JAX's
    lax.scan rollout: the head maps of every window and the last
    carries."""
    kind, jm, variables, tm = detector_pair
    windows = np.random.default_rng(3).uniform(0, 1, (3, 2, 64, 96, 10)
                                               ).astype(np.float32)
    j_c, j_maps = jm.apply(variables, None, jnp.asarray(windows[0]), False)
    with torch.no_grad():
        t_c, t_maps = tm(None, torch.from_numpy(windows[0]))
    _close(t_maps, list(j_maps), f"{kind} one window")
    _close(t_c, j_c, f"{kind} one window's carries")
    j_c, j_stack = j_rollout(jm, variables, jnp.asarray(windows))
    with torch.no_grad():
        t_c, t_stack = rollout_memory_detector(tm, torch.from_numpy(windows))
    assert t_stack[0].shape == (3, 2, 8, 12, 7)
    _close(t_stack, list(j_stack), f"{kind} rollout maps")
    _close(t_c, j_c, f"{kind} rollout carries")


# ---------------------------------------------------------------------------
# the Trainer's steps
# ---------------------------------------------------------------------------

def _spread_head(params, rng):
    """BatchNorm affines U(1, 1.25) / N(0, 0.1), the obj biases 2.0 and the
    box-size biases log 8 (test_torch_port_trainer._serving_params), so
    that the eval step's boxes pass its confidence threshold."""
    from test_torch_port_trainer_common import _serving_params
    return _serving_params(params, rng)


def random_labels(rng, n, hw, k=3, g=4):
    """(n, g, 5) [class, cx, cy, w, h] in pixels of an hw input, k boxes
    an image, the rest padding."""
    labels = np.zeros((n, g, 5), np.float32)
    for i in range(n):
        labels[i, :k, 0] = rng.integers(0, 2, k)
        labels[i, :k, 1:3] = rng.uniform(0.25, 0.75, (k, 2)) * hw[::-1]
        labels[i, :k, 3:5] = rng.uniform(0.15, 0.4, (k, 2)) * hw[::-1]
    return labels


def steps_against_jax(pt, module, variables, j_train, j_eval, imgs,
                      labels):
    """The port Trainer's eval_step then train_step (the steps its build
    chose for its config; its model carries `variables`) against JAX's
    step functions of `module` on the same batch, the network in f64 on
    both sides (the head maps cast to f32 for the decode and the loss, as
    both steps do): the detections (each JAX row within 1e-4 of a distinct
    port row), the losses within rtol 2e-4 and the BatchNorm running
    statistics after the step within 1e-5. In f32 flax's batch variance
    (the mean of squares less the squared mean) alone moves a running
    variance by 1.1e-5 from torch's; f64 takes that noise out, so the
    gates test the algorithm."""
    from test_torch_port_trainer_common import DET_TOL, _match
    imgs = imgs.astype(np.float64)
    tx = optax.sgd(0.0)    # unused: the compared numbers precede the update
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_state = JTrainState(
            step=jnp.zeros((), jnp.int32), params=v64["params"],
            batch_stats=v64["batch_stats"], opt_state=tx.init(v64["params"]),
            tx=tx, apply_fn=module.apply)
        j_dets, j_keep = j_eval(j_state, jnp.asarray(imgs))
        j_new, j_losses = j_train(j_state, jnp.asarray(imgs),
                                  jnp.asarray(labels), jax.random.key(1))
        j_dets, j_keep = np.asarray(j_dets), np.asarray(j_keep)
        j_losses = {k: float(v) for k, v in j_losses.items()}
        want = flax_to_state_dict(
            {"batch_stats": jax.tree.map(np.asarray, j_new.batch_stats)})
    t_dets, t_keep = pt.eval_step(pt.state, torch.from_numpy(imgs))
    for n in range(len(imgs)):
        assert j_keep[n].any(), f"image {n}: no detection to compare"
        _match(t_dets[n][t_keep[n]].numpy(), j_dets[n][j_keep[n]], DET_TOL)
    t_losses = pt.train_step(pt.state, torch.from_numpy(imgs),
                             torch.from_numpy(labels), pt.generator)
    assert t_losses.keys() == j_losses.keys()
    for k, v in j_losses.items():
        np.testing.assert_allclose(t_losses[k].item(), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    got = pt.model.state_dict()
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=BN_TOL, err_msg=k)


def test_trainer_steps_match_jax(detector_pair, tmp_path):
    """convlstm / recconv: the Trainer builds a MemoryEventDetector of the
    config's cells (256 wide); on the 16-wide detector its steps (None
    carries every batch, the SimOTA loss; eval_decode and
    postprocess_batch's defaults) against JAX's make_memory_train_step and
    make_memory_eval_step, batch 2 at 64x96."""
    kind, jm, variables, _ = detector_pair
    exp_type = {"convlstm": "convlstm", "convgru": "recconv"}[kind]
    pt = Trainer(make_config(exp_type, batch_size=2, half_precision=False,
                             img_size_override=(64, 96),
                             log_path=str(tmp_path)), device="cpu")
    assert type(pt.model.memory.lstms_0).__name__ == {
        "convlstm": "ConvLSTMCell", "convgru": "ConvGRUCell"}[kind]
    assert pt.model.memory.lstms_0.hidden_dim == 256
    variables = {**variables, "params": _spread_head(
        variables["params"], np.random.default_rng(0))}
    pt.model = load_flax_variables(
        build_memory_detector(2, kind, in_channels=(16, 16, 16),
                              stem_out_channels=16, head_width=16,
                              input_channels=10, train=True),
        variables).double()
    pt.build(1)
    cfg = pt.cfg
    rng = np.random.default_rng(4)
    steps_against_jax(
        pt, jm, variables,
        j_make_memory_train_step(cfg.strides, 2, cfg.center_radius),
        j_make_memory_eval_step(cfg.strides),
        rng.uniform(0, 1, (2, 64, 96, 10)), random_labels(rng, 2, (64, 96)))
