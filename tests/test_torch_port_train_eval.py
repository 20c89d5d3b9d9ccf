"""The port's eval step against the JAX package's, on the CPU, in f32 and
in bf16 (half_precision: the network on bf16 copies of the f32 masters,
the BatchNorm statistics f32).

The variables are JAX's after one bf16 Adam(1e-3) step of the tiny AED of
test_torch_port_train.py on its batch, with the BatchNorm affines spread
and the obj biases raised as in test_torch_port_p64.py, so boxes pass the
0.3 gate and NMS suppresses some; both packages' make_eval_step run on
them. In f32: head maps within atol 1e-2 (the gate of
test_torch_port_p64.py's slice), keep masks equal, and the kept dets
matched as there (test_torch_port_p64._assert_same_dets). In bf16 the
gates of test_eval_step's docstring.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models.detector import eval_decode as jax_eval_decode
from frlw_evd_tpu.train.trainer import _compute_params as jax_compute_params
from frlw_evd_tpu.train.trainer import \
    create_train_state as jax_create_train_state
from frlw_evd_tpu.train.trainer import make_eval_step as jax_make_eval_step
from frlw_evd_tpu.train.trainer import make_train_step as jax_make_train_step
from frlw_evd_tpu_torch.models import eval_decode, postprocess_batch
from frlw_evd_tpu_torch.models.blocks import BatchNorm2d
from frlw_evd_tpu_torch.train import adam, create_train_state, make_eval_step
from frlw_evd_tpu_torch.train.trainer import _forward
from test_torch_port_p64 import OBJ_BIAS, _assert_same_dets
from test_torch_port_train import (C, H, NC, STRIDES, W, jax_model,
                                   port_model, small_train_batch)
from test_torch_port_train_bf16 import _flax_batchnorm, _record_batchnorms


@pytest.fixture(scope="module")
def stepped():
    """JAX's train state after one bf16 step, its model and the batch."""
    imgs, labels = small_train_batch(np.random.default_rng(0))
    jm = jax_model()
    state = jax_create_train_state(jm, jax.random.key(1),
                                   jnp.zeros((1, H, W, C)), optax.adam(1e-3))
    state, _ = jax_make_train_step(STRIDES, NC, 2.5, half_precision=True)(
        state, jnp.asarray(imgs), jnp.asarray(labels), jax.random.key(2))
    return imgs, jm, state


def _spread(params, rng):
    """test_torch_port_p64._serving_variables' spread: BatchNorm scales
    U(1, 2) and biases N(0, 0.5), the obj biases OBJ_BIAS."""
    flat = {}
    for path, a in flatten_dict(jax.tree.map(np.array, params)).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 2.0, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.5, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = OBJ_BIAS
        flat[path] = a
    return unflatten_dict(flat)


def _jax_eval(jm, j_state, imgs, half_precision):
    """JAX's make_eval_step on `imgs`, and the head maps it decodes (f32)."""
    dets, keep = jax_make_eval_step(STRIDES, max_detections=50,
                                    half_precision=half_precision)(
                                        j_state, jnp.asarray(imgs))
    cast = jnp.bfloat16 if half_precision else jnp.float32
    outs = jax.jit(lambda v, x: jm.apply(v, x, False))(
        {"params": jax_compute_params(j_state.params, half_precision),
         "batch_stats": j_state.batch_stats}, jnp.asarray(imgs).astype(cast))
    return (np.asarray(dets), np.asarray(keep),
            [o.astype(jnp.float32) for o in outs])


@pytest.mark.parametrize("half_precision", [False, True])
def test_eval_step(stepped, half_precision):
    """Both packages' eval steps on the variables of the module docstring;
    the port's model is left in eval mode with f32 masters.

    f32: head maps atol 1e-2, keep masks equal, the kept dets matched.
    bf16: the two frameworks' bf16 networks round apart by about 1% of the
    head maps (measured here: up to 1.8 on maps of size 72), so the keep
    masks cannot be equal; JAX's own bf16 keep mask differs from its f32
    one in 29 of 200 places. Instead: every BatchNorm of the step, bf16
    activations over f32 statistics, gives flax's output within one bf16
    ulp on the same input; each level's head maps are as far from JAX's
    f32 maps as JAX's bf16 maps are, within a factor 2; the keep mask
    differs from JAX's f32 one in at most twice as many places as JAX's
    bf16 one does; and the step's dets and keep mask are postprocess_batch
    of eval_decode of the port's own bf16 maps, exactly (on equal maps the
    two packages' decode and NMS agree: test_torch_port_detector.py)."""
    imgs, jm, j_state = stepped
    params = _spread(j_state.params, np.random.default_rng(0))
    stats = jax.tree.map(np.array, j_state.batch_stats)
    j_state = j_state.replace(params=jax.tree.map(jnp.asarray, params))
    j_dets, j_keep, j_outs = _jax_eval(jm, j_state, imgs, False)

    state = create_train_state(
        port_model({"params": params, "batch_stats": stats}), adam(1e-3),
        device="cpu")
    calls = _record_batchnorms(state.model)
    dets, keep = make_eval_step(STRIDES, max_detections=50,
                                half_precision=half_precision,
                                device="cpu")(state, torch.from_numpy(imgs))
    assert dets.shape == (4, 50, 6) and keep.shape == (4, 50)
    assert not state.model.training
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    valid = j_dets[..., 5] > 0
    assert j_keep.sum() > 0 and (valid & ~j_keep).sum() > 0

    if not half_precision:
        with torch.no_grad():
            outs = state.model(torch.from_numpy(imgs))
        for lvl, (o, jo) in enumerate(zip(outs, j_outs)):
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-2,
                                       err_msg=f"level {lvl}")
        np.testing.assert_array_equal(keep.numpy(), j_keep)
        j_dec = np.asarray(jax_eval_decode(j_outs, STRIDES))
        for b in range(4):
            _assert_same_dets(dets.numpy()[b][j_keep[b]],
                              j_dets[b][j_keep[b]], j_dec[b])
        return

    assert len(calls) == sum(isinstance(m, BatchNorm2d)
                             for m in state.model.modules())
    for name, call in calls.items():
        assert call["x"].dtype == torch.bfloat16, name
        assert call["mean"].dtype == torch.float32, name
        want, _ = _flax_batchnorm(call, train=False)
        assert want.dtype == jnp.bfloat16 and \
            call["out"].dtype == torch.bfloat16, name
        want = np.asarray(want, np.float32)
        got = call["out"].permute(0, 2, 3, 1).float().numpy()
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0 ** -7 * np.abs(want) + 1e-30,
                                     err_msg=name)
    _, jb_keep, jb_outs = _jax_eval(jm, j_state, imgs, True)
    with torch.no_grad():
        outs = _forward(state.model, torch.from_numpy(imgs).bfloat16(),
                        True)
    for lvl, (o, jo, jb) in enumerate(zip(outs, j_outs, jb_outs)):
        jax_err = np.abs(np.asarray(jb) - np.asarray(jo)).max()
        assert np.abs(o.numpy() - np.asarray(jo)).max() <= 2 * jax_err, lvl
    assert (keep.numpy() != j_keep).sum() <= 2 * (jb_keep != j_keep).sum()
    want = postprocess_batch(eval_decode(outs, STRIDES), max_detections=50)
    assert torch.equal(dets, want[0]) and torch.equal(keep, want[1])
