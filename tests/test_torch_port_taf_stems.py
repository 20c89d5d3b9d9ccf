"""The port's other TAF stems and backbones (models/stems.py:
TemporalActiveFocus, TemporalActiveFocus3D; models/darknet.py:
SEAttention, SwinDarknet; models/mobilenet.py: CoordAtt, MBV2CA), each
stem inside build_detector, and the Trainer's steps of the taf_swin,
taf_corr and taf_syn exp types, against the JAX package's on the CPU.

Weights go across with weights.load_flax_variables from JAX's variables
tree filled from a numpy seed (test_torch_port_swin3d.seeded_variables),
and both packages' dropout masks are made equal (EqualDropout). Gates: the
forwards in eval and training mode within 2e-4 (ROADMAP's f32 forward
gate) and the BatchNorm running statistics after a training forward
within 1e-5, in f64 (_forward_pair); the train steps in f64 (as
test_torch_port_memory.steps_against_jax: flax's mean-of-squares variance
moves an f32 running variance by 1e-5 alone), losses within rtol 2e-4 and
statistics within 1e-5. Also: the port's
stem and family tables cover JAX's, with the same variables, and the
dtypes of the swin and corr stems under bf16 compute are JAX's but for
the stems' last conv (ROADMAP §C).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen
from torch.func import functional_call

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models import detector as jdet
from frlw_evd_tpu.models.blocks import Focus as JFocus
from frlw_evd_tpu.models.darknet import SEAttention as JSEAttention
from frlw_evd_tpu.models.darknet import SwinDarknet as JSwinDarknet
from frlw_evd_tpu.models.mobilenet import MBV2CA as JMBV2CA
from frlw_evd_tpu.models.mobilenet import CoordAtt as JCoordAtt
from frlw_evd_tpu.models.stems import \
    TemporalActiveFocus as JTemporalActiveFocus
from frlw_evd_tpu.models.stems import \
    TemporalActiveFocus3D as JTemporalActiveFocus3D
from frlw_evd_tpu.models.swin3d import \
    TemporalActiveFocusCorr as JTemporalActiveFocusCorr
from frlw_evd_tpu.models.swin3d import \
    TemporalActiveFocusSwin as JTemporalActiveFocusSwin
from frlw_evd_tpu.train.config import EXP_TYPES as J_EXP_TYPES
from frlw_evd_tpu.train.trainer import TrainState as JTrainState
from frlw_evd_tpu.train.trainer import make_train_step as j_make_train_step
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models import detector as pdet
from frlw_evd_tpu_torch.models.blocks import Focus
from frlw_evd_tpu_torch.models.darknet import SEAttention, SwinDarknet
from frlw_evd_tpu_torch.models.mobilenet import MBV2CA, CoordAtt
from frlw_evd_tpu_torch.models.stems import (TemporalActiveFocus,
                                             TemporalActiveFocus3D)
from frlw_evd_tpu_torch.models.swin3d import (TemporalActiveFocusCorr,
                                              TemporalActiveFocusSwin)
from frlw_evd_tpu_torch.train import Trainer, make_config
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from test_torch_port_memory import _two_torch_threads  # noqa: F401
from test_torch_port_memory import random_labels
from test_torch_port_swin3d import (EqualDropout, fast_jit,
                                   seeded_variables, variable_shapes)

TOL, BN_TOL, LOSS_RTOL = 2e-4, 1e-5, 2e-4
NARROW = dict(in_channels=(16, 16, 16), stem_out_channels=16, head_width=16)
H, W, K = 64, 96, 4
SHORT_CFGS = JMBV2CA.CFGS[:4]


def _nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def _forward_pair(jm, tm, x, seed=0, what="", nchw=(False, True),
                  shapes=None):
    """JAX's and the port's forward of `x` (NHWC) on carried seeded
    variables, in eval and in training mode with equal dropout masks, in
    f64 (one JAX compile for both; an f32 batch variance differs between
    flax's mean of squares and torch's centred sum by up to 1.3e-5 of a
    running variance here, and the batch statistics of 2 images amplify
    f32 rounding in the maps; the stems' f32 forwards are held in
    test_torch_port_swin3d.py): the outputs within 2e-4 and the running
    statistics after the training forward within 1e-5. nchw: whether the
    port module takes NCHW and returns NCHW (4-D outputs). Returns the
    number of dropout calls. shapes: the variables' tree, when known."""
    variables = seeded_variables(jm, np.random.default_rng(seed), x, False,
                                 shapes=shapes)
    load_flax_variables(tm, variables).double()
    xt = torch.from_numpy(x).double()
    if nchw[0]:
        xt = xt.permute(0, 3, 1, 2)

    def close(got, want, tag):
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            g = _nhwc(g) if nchw[1] else g
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=TOL, rtol=0,
                                       err_msg=f"{what} {tag} [{i}]")

    drops = EqualDropout(3)
    with jax.enable_x64(True), drops.jax() as j_calls:
        def both(v, a):
            return (jm.apply(v, a, False),
                    jm.apply(v, a, True, mutable=["batch_stats"]))

        evaled, (want, upd) = jax.tree.map(np.asarray, fast_jit(both)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables),
            jnp.asarray(x, jnp.float64)))
    with torch.no_grad():
        close(tm.eval()(xt), evaled, "eval")
    with drops.torch() as t_calls, torch.no_grad():
        close(tm.train()(xt), want, "train")
    assert j_calls == t_calls, (j_calls, t_calls)
    sd = tm.state_dict()
    stats = flax_to_state_dict(upd)
    assert stats
    for key, v in stats.items():
        np.testing.assert_allclose(sd[key].numpy(), v.numpy(), atol=BN_TOL,
                                   rtol=0, err_msg=f"{what} {key}")
    return len(j_calls)


@functools.lru_cache()
def _jax_detector(family, stem, merged=False):
    """JAX's NARROW detector and its variables' tree (variable_shapes at
    the (H, W, 2K) input), traced once a file for the tests that share
    them."""
    jm = jax_build(2, family=family, stem=stem, head_merged=merged, **NARROW)
    return jm, variable_shapes(jm, np.zeros((1, H, W, 2 * K), np.float32),
                               False)


def _volume(seed, k=K, h=32, w=48, n=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 2 * k)).astype(
        np.float32)


@pytest.mark.parametrize("k", [4, 8])
def test_temporal_active_focus_matches_flax(k):
    """log2(K) grouped weight-norm convs at full width, then the fused
    6x6 form of patchify + 3x3 conv on JAX's (3, 3, 4*2K, O) kernel."""
    _forward_pair(JTemporalActiveFocus(12), TemporalActiveFocus(2 * k, 12),
                  _volume(1, k), what="taf")


@pytest.mark.parametrize("k", [4, 8])
def test_temporal_active_focus_3d_matches_flax(k):
    """Grouped 3x3 BaseConvs with a bias, the first at stride 2, and the
    fusing 1x1 BaseConv's dropout 0.25 between its BatchNorm and its
    activation."""
    n = _forward_pair(JTemporalActiveFocus3D(12, embed_dim=8),
                      TemporalActiveFocus3D(2 * k, 12, embed_dim=8),
                      _volume(2, k), what="taf_3d")
    assert n == 1


def test_se_attention_matches_flax():
    x = np.random.default_rng(3).normal(size=(2, 8, 12, 16)).astype(
        np.float32)
    jm, tm = JSEAttention(24, reduction=4), SEAttention(16, 24, reduction=4)
    variables = seeded_variables(jm, np.random.default_rng(0), x, False)
    load_flax_variables(tm, variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got).numpy(),
                               np.asarray(jm.apply(variables, x, False)),
                               atol=TOL, rtol=0)


def test_swin_darknet_matches_flax():
    """Focus beside TemporalActiveFocus3D, fused by SEAttention, dark2
    narrowed to the stem width: the (dark3, dark4, dark5) pyramid."""
    jm = JSwinDarknet(stem=JFocus, stem_out_channels=16,
                      out_channels=(16, 16, 16))
    tm = SwinDarknet(Focus, 2 * K, stem_out_channels=16,
                     out_channels=(16, 16, 16))
    assert _forward_pair(jm, tm, _volume(4, h=64, w=96), what="swin") == 1


class _ShortJMBV2CA(JMBV2CA):
    CFGS = SHORT_CFGS


class _ShortMBV2CA(MBV2CA):
    CFGS = SHORT_CFGS


def test_mbv2ca_and_coord_att_match_flax():
    """CoordAtt alone, then MBV2-CA at width 0.25 with its classifier's
    dropout, on the first four of its seven block settings (each kind of
    block: no expansion, expansion with CoordAtt, stride 2, the identity
    shortcut; the seventeen blocks' XLA compile took 8 s of this test
    alone), the settings table itself equal to JAX's."""
    assert MBV2CA.CFGS == JMBV2CA.CFGS
    x = np.random.default_rng(5).normal(size=(2, 6, 10, 16)).astype(
        np.float32)
    _forward_pair(JCoordAtt(16), CoordAtt(16, 16), x, what="coord_att",
                  nchw=(True, True))
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    n = _forward_pair(_ShortJMBV2CA(num_classes=10, width_mult=0.25),
                      _ShortMBV2CA(3, num_classes=10, width_mult=0.25), x,
                      what="mbv2ca")
    assert n == 1


@pytest.mark.parametrize("family,stem", [("aed", "taf"), ("aed", "taf_3d")])
def test_stem_in_build_detector_matches_flax(family, stem):
    """The taf and taf_3d stems inside the AED: the head maps in eval and
    training mode, the running statistics of every BatchNorm after the
    training forward (taf_swin, taf_corr and SwinDarknet inside theirs:
    test_trainer_train_step_matches_jax)."""
    jm, shapes = _jax_detector(family, stem)
    _forward_pair(jm, build_detector(2, family=family, stem=stem,
                                     input_channels=2 * K, **NARROW),
                  _volume(7, h=H, w=W), what=stem, nchw=(False, False),
                  shapes=shapes)


def test_port_builds_every_stem_and_family_of_jax():
    """The port's _STEMS has JAX's keys (detector.py:93-106), and each
    stem that takes the NHWC volume builds, with each family of JAX's
    build_detector and either head, the variables JAX's does: the same
    state_dict keys and shapes."""
    assert set(pdet._STEMS) == set(jdet._STEMS)
    cases = [("aed", s, False) for s in ("focus", "taf", "bfm", "taf_swin",
                                         "taf_corr", "taf_3d")]
    cases += [("swin_darknet", "focus", False), ("yolox", "focus", False),
              ("aed", "bfm", True), ("swin_darknet", "focus", True)]
    for family, stem, merged in cases:
        shapes = _jax_detector(family, stem, merged)[1]
        want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes)).items()}
        tm = build_detector(2, family=family, stem=stem, head_merged=merged,
                            input_channels=2 * K, **NARROW)
        got = {k: tuple(v.shape) for k, v in tm.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        assert got == want, (family, stem, merged)


def _dtypes_jax(jm, variables, x):
    """{module path: output dtype} of JAX's training forward of jm on bf16
    parameters and input (trainer._compute_params), by eval_shape."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(out, jax.Array) and context.method_name == "__call__":
            seen[".".join(context.module.path)] = getattr(
                torch, np.dtype(out.dtype).name)
        return out

    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                          variables["params"])

    def run(p, a):
        with linen.intercept_methods(record):
            return jm.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            a, True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.key(0)})

    jax.eval_shape(run, params, jnp.asarray(x, jnp.bfloat16))
    return seen


@pytest.mark.parametrize("stem", ["swin", "corr"])
def test_bf16_dtypes_follow_jax_but_for_the_last_conv(stem):
    """Under bf16 compute both stems promote as jnp does: the swin stem's
    f32 shift mask and the corr stem's f32 deltas carry f32 through the
    attention, the LayerNorms, the Linears and the reference chain, each
    submodule's output dtype JAX's. The one departure (ROADMAP §C): the
    stem casts its features to its conv's dtype, so its BaseConv (`conv`)
    runs in bf16 where JAX's runs, with the network after it, in f32."""
    jcls, tcls = {"swin": (JTemporalActiveFocusSwin, TemporalActiveFocusSwin),
                  "corr": (JTemporalActiveFocusCorr,
                           TemporalActiveFocusCorr)}[stem]
    x = _volume(8, 8, 16, 24)
    jm, tm = jcls(12, embed_dim=8), tcls(16, 12, embed_dim=8)
    variables = seeded_variables(jm, np.random.default_rng(0), x, False)
    want = _dtypes_jax(jm, variables, x)
    load_flax_variables(tm, variables).train()
    for mod in tm.modules():
        if hasattr(mod, "generator"):
            mod.generator = torch.Generator()
    got = {}
    hooks = [mod.register_forward_hook(
        lambda m, a, out, name=name: got.__setitem__(name, out.dtype))
        for name, mod in tm.named_modules() if name]
    params = {k: p.to(torch.bfloat16)
              for k, p in tm.named_parameters()}
    with torch.no_grad():
        out = functional_call(tm, params, (torch.from_numpy(x).to(
            torch.bfloat16),))
    for h in hooks:
        h.remove()
    common = sorted(set(want) & set(got))
    assert len(common) > 10
    differ = {k for k in common if got[k] != want[k]}
    assert differ == {"conv", "conv.conv", "conv.bn"}, differ
    assert want["conv"] == torch.float32 and out.dtype == torch.bfloat16
    f32 = {k for k in common if want[k] == torch.float32} - differ
    assert f32, "the promotion is exercised"


@pytest.mark.parametrize("exp_type", ["taf_swin", "taf_corr", "taf_syn"])
def test_trainer_train_step_matches_jax(exp_type, tmp_path):
    """The Trainer of the exp type builds its family and stem (JAX
    config.py:140-142); on the 16-wide detector, the head maps in eval
    mode within 2e-4 of flax's, then its train step against JAX's
    make_train_step on the same variables, batch and dropout masks
    (losses, and every BatchNorm's running statistics after the
    training forward), the network in f64 on both sides. JAX's eval
    forward and train step are compiled as one program."""
    spec = J_EXP_TYPES[exp_type]
    pt = Trainer(make_config(exp_type, batch_size=2, half_precision=False,
                             event_volume_bins=K, img_size_override=(H, W),
                             log_path=str(tmp_path)), device="cpu")
    stem_cls = type(pt.model.backbone.stem).__name__
    assert stem_cls == {"taf_swin": "TemporalActiveFocusSwin",
                        "taf_corr": "TemporalActiveFocusCorr",
                        "taf_syn": "Focus"}[exp_type]
    assert (type(pt.model.backbone).__name__ == "SwinDarknet") == (
        exp_type == "taf_syn")
    jm, shapes = _jax_detector(spec["family"], spec["stem"])
    rng = np.random.default_rng(9)
    imgs = rng.uniform(0, 1, (2, H, W, 2 * K))
    labels = random_labels(rng, 2, (H, W))
    variables = seeded_variables(jm, rng, shapes=shapes)
    pt.model = load_flax_variables(build_detector(
        2, family=spec["family"], stem=spec["stem"], input_channels=2 * K,
        train=True, **NARROW), variables).double()
    pt.build(1)
    cfg = pt.cfg
    tx = optax.sgd(0.0)    # unused: the compared numbers precede the update
    j_step = j_make_train_step(cfg.strides, 2, cfg.center_radius)
    drops = EqualDropout(5)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_state = JTrainState(
            step=jnp.zeros((), jnp.int32), params=v64["params"],
            batch_stats=v64["batch_stats"], opt_state=tx.init(v64["params"]),
            tx=tx, apply_fn=jm.apply)
        with drops.jax() as j_calls:
            j_maps, (j_new, j_losses) = fast_jit(
                lambda st, a, lab, key: (
                    jm.apply({"params": st.params,
                              "batch_stats": st.batch_stats}, a, False),
                    j_step(st, a, lab, key)))(
                j_state, jnp.asarray(imgs), jnp.asarray(labels),
                jax.random.key(1))
        j_losses = {k: float(v) for k, v in j_losses.items()}
        want = flax_to_state_dict(
            {"batch_stats": jax.tree.map(np.asarray, j_new.batch_stats)})
    with torch.no_grad():
        t_maps = pt.model.eval()(torch.from_numpy(imgs))
    for lvl, (g, w) in enumerate(zip(t_maps, j_maps)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f"eval level {lvl}")
    with drops.torch() as t_calls:
        t_losses = pt.train_step(pt.state, torch.from_numpy(imgs),
                                 torch.from_numpy(labels), pt.generator)
    assert j_calls == t_calls and len(j_calls) == {
        "taf_swin": 0, "taf_corr": 3, "taf_syn": 1}[exp_type]
    assert t_losses.keys() == j_losses.keys()
    for k, v in j_losses.items():
        np.testing.assert_allclose(t_losses[k].item(), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    got = pt.model.state_dict()
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=BN_TOL, err_msg=k)
