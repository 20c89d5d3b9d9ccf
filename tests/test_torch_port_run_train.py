"""train/synthetic.run_train's remat and p64 switches (bench.py:460-490)
on the CPU at a tiny size."""

from __future__ import annotations

import numpy as np
import torch

from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.train import run_train

from test_torch_port_trainer_common import H, NARROW, NC, W


def test_run_train_switches():
    """run_train's remat / p64 switches (bench.py:460-490) at a tiny size,
    bf16 over f32 masters as the bench runs: the remat ways' first steps
    give their plain ways' losses, p64 its own (its stem's bf16 sums run
    in another order; the f32 and f64 tests above hold its math)."""
    cfg = dict(input_hw=(H, W), batch=2, num_classes=NC)

    def first_losses(stem, **kw):
        model = build_detector(NC, stem=stem, train=True, dropout_rate=0.1,
                               generator=torch.Generator().manual_seed(2),
                               **NARROW)
        out = run_train(cfg, steps=1, warmup=1, model=model, device="cpu",
                        **kw)
        assert all(np.isfinite(list(lo.values())).all()
                   for lo in out["losses"])
        return out["losses"][0]

    assert first_losses("bfm", remat=True) == first_losses("bfm")
    p64 = first_losses("bfm_p64", p64=True)
    assert first_losses("bfm_p64", p64=True, remat=True,
                        remat_policy="dots") == p64
