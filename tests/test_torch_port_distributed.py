"""Data-parallel training of the port (frlw_evd_tpu_torch/parallel/dist.py,
multihost.py, the group BatchNorm of models/blocks.py, the global loss
normalisers and the Trainer under a process group) on the CPU over gloo,
against the port's one process on the whole batch and JAX's step.

Two gloo ranks are spawned once for the file (parallel/check.py's spawn,
torchrun's environment) and run parallel/check.py's cases on their rows
of each seeded global batch; the one-process reference is the same case
run here without a group. Gates: gather_objects and sync_batch_stats as
tests/test_multihost.py:23-53; the group BatchNorm's outputs, statistics
and input gradients in f64 within 1e-12 (the affine gradients' shares
summed over the ranks); dropout masks the rows of the one-process masks;
one SGD step each of the narrow AED, a small yolov3 and a small red: in
f32 the losses within rtol 2e-4 and the running statistics within 1e-5
(yolov3 in f64 only, at the same gates), with the network in f64 the
gradients within 1e-6 of each leaf's largest magnitude; the world-2 AED step also against JAX's make_train_step step
on the whole batch at the same gates; one Trainer epoch (3 steps, its
validation, its checkpoint) at world 2 against world 1: the losses within
rtol 2e-4, the COCO stats equal, the running statistics within 1e-5 and
the parameters after three Adam steps within 1e-4 (Adam's first update,
lr * g / (|g| + eps), moves an element whose f32 gradient is at its
rounding noise by up to lr); the refusal of a batch the world does not
divide. cli.train under torchrun's environment at world size 2 runs on
the card (chip_smoke.py phase 42).
"""

from __future__ import annotations

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.data import Loader, synthetic
from frlw_evd_tpu_torch.parallel import check, dist

from test_torch_port_train import (H, W, C, jax_model, jax_sgd_step,
                                   port_model, small_train_batch)

STATS = ("running_mean", "running_var")
FAMILIES = ("aed", "yolov3", "red")
CASES = ("objects", "bn", "dropout", *FAMILIES, "trainer")


def _tree_kw(tree, log_path):
    return json.dumps(dict(data_path=tree["taf_dir"],
                           bbox_path=tree["labels"], log_path=str(log_path),
                           sensor_hw=synthetic.SENSOR_HW,
                           input_hw=synthetic.INPUT_HW))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process while the file runs: the cases'
    small ops stall on the thread pool's barriers when the suite's other
    workers hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX AED variables, the port's state_dict of them, the mini
    tree, and the two ranks' outputs of every case."""
    root = tmp_path_factory.mktemp("dist")
    jm = jax_model()
    variables = jax.tree.map(np.array, jax.jit(
        jm.init, static_argnums=(2,))(jax.random.key(1),
                                      jnp.zeros((1, H, W, C)), False))
    aed_state = str(root / "aed.pt")
    torch.save(port_model(variables).state_dict(), aed_state)
    tree = synthetic.build_mini_gen1(str(root / "tree"),
                                     np.random.default_rng(0),
                                     blobs=("taf",))
    out = root / "ranks"
    check.spawn(2, ["--out", str(out), "--device", "cpu",
                    "--cases", ",".join(CASES), "--aed_state", aed_state,
                    "--trainer", _tree_kw(tree, root / "log2")],
                env={"OMP_NUM_THREADS": "1"})
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    shutil.rmtree(out)
    assert [r["world"] for r in ranks] == [2, 2]
    return dict(jm=jm, variables=variables, aed_state=aed_state, tree=tree,
                root=root, ranks=ranks)


def _hold_step(got, want):
    """One rank's steps against the reference's: the f32 step's losses
    and statistics (the f64 step's where there is no f32 one), the f64
    step's gradients."""
    run = "f32" if "f32" in want else "f64"
    g, w = got[run], want[run]
    assert g["losses"].keys() == w["losses"].keys()
    for k, v in w["losses"].items():
        np.testing.assert_allclose(g["losses"][k], v, rtol=2e-4, err_msg=k)
    assert w["stats"] and g["stats"].keys() == w["stats"].keys()
    for k, v in w["stats"].items():
        np.testing.assert_allclose(g["stats"][k].numpy(), v, atol=1e-5,
                                   rtol=0, err_msg=k)
    grads = got["f64"]["grads"]
    assert grads.keys() == want["f64"]["grads"].keys()
    for k, ref in want["f64"]["grads"].items():
        ref = np.asarray(ref, np.float64)
        np.testing.assert_allclose(grads[k].double().numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max() + 1e-12,
                                   rtol=0, err_msg=k)


def test_gather_objects_and_sync_batch_stats(setup):
    for out in setup["ranks"]:
        objs = out["objects"]["gathered"]
        assert [o["rank"] for o in objs] == [0, 1]
        assert len(objs[1]["dets"]) == 8 and objs[1]["dets"][1] == ("box",
                                                                   1.5)
        module = out["objects"]["module"]
        assert torch.equal(module["running_mean"], torch.full((4,), 0.5))
        assert torch.equal(module["running_var"], torch.full((4,), 1.5))
        sd = out["objects"]["state_dict"]
        assert torch.equal(sd["bn.running_mean"], torch.full((3,), 1.0))
        assert torch.equal(sd["bn.running_var"], torch.full((3,), 4.5))
    # a key that is no BatchNorm statistic is left as it was
    assert [float(out["objects"]["state_dict"]["conv.weight"][0])
            for out in setup["ranks"]] == [0.0, 1.0]


def test_group_batch_norm_matches_one_process_in_f64(setup):
    want = check.run_case("bn", "cpu")
    ranks = [out["bn"] for out in setup["ranks"]]
    for key in ("y", "x_grad"):
        got = torch.cat([r[key] for r in ranks])
        torch.testing.assert_close(got, want[key], atol=1e-12, rtol=0,
                                   msg=key)
    for key in ("mean", "var"):
        for r in ranks:
            torch.testing.assert_close(r[key], want[key], atol=1e-12,
                                       rtol=0, msg=key)
    for key in ("w_grad", "b_grad"):
        torch.testing.assert_close(ranks[0][key] + ranks[1][key], want[key],
                                   atol=1e-12, rtol=0, msg=key)
    for k, v in want["running"].items():
        for r in ranks:
            torch.testing.assert_close(r["running"][k], v, atol=1e-5,
                                       rtol=0, msg=k)


def test_dropout_masks_are_rows_of_the_one_process_masks(setup):
    want = check.run_case("dropout", "cpu")
    for key in ("out", "out2"):
        got = torch.cat([out["dropout"][key] for out in setup["ranks"]])
        assert torch.equal(got, want[key]), key
    assert not torch.equal(want["out"], want["out2"])
    assert 0.2 < (want["out"] == 0).float().mean() < 0.4


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_one_process(setup, family):
    kw = {"aed_state": setup["aed_state"]} if family == "aed" else {}
    want = check.run_case(family, "cpu", **kw)
    for out in setup["ranks"]:
        _hold_step(out[family], want)
    # every rank ends on the same parameters and statistics
    a, b = (out[family]["f64"] for out in setup["ranks"])
    assert a["param_sums"] == b["param_sums"]
    for k in a["stats"]:
        assert torch.equal(a["stats"][k], b["stats"][k]), k


def test_aed_step_matches_jax_on_the_whole_batch(setup):
    imgs, labels = small_train_batch(np.random.default_rng(0))
    same = check.small_batch(np.random.default_rng(0))
    assert np.array_equal(imgs, same[0]) and np.array_equal(labels, same[1])
    jm, variables = setup["jm"], setup["variables"]
    # one JAX step, in f64: its losses and statistics hold the port's f32
    # ones at the f32 gates as well as JAX's f32 step would
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        j64 = jax_sgd_step(jm, v64, imgs.astype(np.float64), labels)
    want = {"f32": {"losses": {k: float(v) for k, v in
                               j64["losses"].items()},
                    "stats": {k: v.double().numpy()
                              for k, v in j64["after"].items()
                              if k.endswith(STATS)}},
            "f64": {"grads": {k: v.double().numpy()
                              for k, v in j64["grads"].items()}}}
    for out in setup["ranks"]:
        _hold_step(out["aed"], want)


def test_trainer_epoch_matches_one_process(setup):
    want = check.run_case("trainer", "cpu", trainer=_tree_kw(
        setup["tree"], setup["root"] / "log1"))
    for out in setup["ranks"]:
        got = out["trainer"]
        assert len(got["losses"]) == len(want["losses"]) == 3
        for g, w in zip(got["losses"], want["losses"]):
            for k, v in w.items():
                np.testing.assert_allclose(g[k], v, rtol=2e-4, err_msg=k)
        assert got["stats"] == want["stats"]
        assert got["files"] == want["files"]
        for k, v in want["state"].items():
            np.testing.assert_allclose(
                got["state"][k].numpy(), v.numpy(), rtol=0, err_msg=k,
                atol=1e-5 if k.endswith(STATS) else 1e-4)
    assert "last_epoch" in want["files"]


def test_a_batch_the_world_does_not_divide_is_refused(monkeypatch):
    monkeypatch.setattr(dist, "world", lambda: 2)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    assert dist.rows(4) == (2, 4)
    with pytest.raises(ValueError, match="multiple of the world size"):
        dist.shard_batch(torch.zeros(5, 3))
    with pytest.raises(ValueError, match="multiple of the world size"):
        Loader(list(range(10)), 3, shard=(0, 2))
    loader = Loader(list(range(7)), 4, shuffle=False, drop_last=False,
                    shard=(1, 2))
    assert [list(b) for b in loader._batch_indices()] == [[2, 3], [5, 6]]
