"""The BFM stem's per-pixel channel chain on the patchified volume, kernels
B4 and B7 (counterpart of frlw_evd_tpu/models/pallas_stem.py).

Per subpixel block of 2K = 16 channels (4 blocks per quarter-resolution
pixel): three weight-norm grouped 1x1 convs 16→16 (4 groups), 16→8 (2
groups), 8→4, each with bias and ReLU; the first 4 channels of each level
make h (12); then h + trans_down(act(trans_up(h))), 12→48→12. The rounding
points are the TPU kernel's: bf16 input and weights (the materialised
weight-norm weights, computed in the parameters' own dtype, then rounded),
f32 accumulation and biases, y0/y1/y2 and act(u) rounded to bf16 before
they are used, the output rounded to bf16.

`bfm_chain_apply_folded` (B4) maps the folded (B, H2, W2*64) volume to
(B, H2, W2*64): per pixel the 48 channels of h, then 16 zeros.
`bfm_chain_apply` (B7) maps the NHWC (B, H2, W2, 64) volume to
(B, H2, W2, 48). `params` is the stem's parameter subtree as a mapping of
state_dict names ("convs_0.weight_v", ..., "trans_down.bias"), as the JAX
functions take the canonical params subtree. CUDA tensors launch
`csrc/bfm_chain.cu`; CPU tensors run the plain twins.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import _build

S = 4                       # subpixel blocks per pixel (2x2 space-to-depth)
IN_CH = 16                  # 2K channels per subpixel block (K = 8)
MIXER = 12                  # h channels per subpixel block
GROUPS = (4, 2, 1)          # grouped 1x1 convs 16→16, 16→8, 8→4
MACS_PER_SUBPIXEL = 16 * 4 + 8 * 8 + 4 * 8 + 48 * 12 + 12 * 48    # 1312
SILU_PER_SUBPIXEL = 48      # act on the trans_up output


def chain_weights(params) -> dict[str, torch.Tensor]:
    """The chain's f32 weights with the TPU kernel's rounding
    (pallas_stem.py:153-172, _wn_dense:208-216): weight-norm weights
    g * v / sqrt(sum v^2 + 1e-12) computed in the parameters' dtype, then
    bf16-rounded; trans_up / trans_down kernels bf16-rounded; biases f32.
    Returns w0 (16, 4), w1 (8, 8), w2 (4, 8), wu (48, 12), wd (12, 48) as
    (out, in per group) matrices and b0, b1, b2, bu, bd."""
    def rounded(w):
        return w.detach().to(torch.bfloat16).to(torch.float32).flatten(1)

    out = {}
    for i in range(len(GROUPS)):
        v = params[f"convs_{i}.weight_v"].detach()
        g = params[f"convs_{i}.weight_g"].detach()
        norm = torch.sqrt((v * v).sum(dim=(1, 2, 3)) + 1e-12)
        out[f"w{i}"] = rounded(v * (g / norm).view(-1, 1, 1, 1))
        out[f"b{i}"] = params[f"convs_{i}.bias"].detach().float()
    for key, name in (("u", "trans_up"), ("d", "trans_down")):
        out[f"w{key}"] = rounded(params[f"{name}.weight"])
        out[f"b{key}"] = params[f"{name}.bias"].detach().float()
    shapes = {"w0": (16, 4), "w1": (8, 8), "w2": (4, 8), "wu": (48, 12),
              "wd": (12, 48)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"the chain kernels take the K = 8, embed 4 "
                             f"BFM: {k} must be {shape}, got "
                             f"{tuple(out[k].shape)}")
    return out


def _pack(w: dict[str, torch.Tensor], device) -> torch.Tensor:
    """The (1400,) f32 weight block in csrc/bfm_chain.cu's order, with
    trans_down transposed so that the kernel reads each row contiguously."""
    blocks = [w["w0"], w["b0"], w["w1"], w["b1"], w["w2"], w["b2"], w["wu"],
              w["bu"], w["wd"].T, w["bd"]]
    return torch.cat([b.reshape(-1) for b in blocks]).to(device)


def _round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def bfm_chain_plain(x: torch.Tensor, params):
    """Plain-PyTorch twin of the chain (any device), act silu: x (..., 64)
    → h (..., 4, 12) bf16, per subpixel block, with the kernels'
    rounding."""
    w = chain_weights(params)
    lead = x.shape[:-1]
    v = _round(x).reshape(-1, S, IN_CH)
    ys = []
    for i, groups in enumerate(GROUPS):
        wi = w[f"w{i}"]
        n_out, k = wi.shape
        vg = v.reshape(v.shape[0], S, groups, k)
        y = torch.einsum("nsgk,gok->nsgo", vg,
                         wi.view(groups, n_out // groups, k))
        v = _round(F.relu(y.reshape(v.shape[0], S, n_out) + w[f"b{i}"]))
        ys.append(v[..., :4])
    h = torch.cat(ys, dim=-1)                                  # (n, S, 12)
    a = _round(F.silu(h @ w["wu"].T + w["bu"]))
    out = _round(h + (a @ w["wd"].T + w["bd"]))
    return out.to(torch.bfloat16).reshape(*lead, S, MIXER)


def _check_act(act: str) -> None:
    if act != "silu":
        raise ValueError(f"the chain kernels apply silu, got act {act!r}")


def _check_folded(vol_f: torch.Tensor, width: int, act: str) -> None:
    _check_act(act)
    if (vol_f.dtype != torch.bfloat16 or vol_f.dim() != 3
            or vol_f.shape[-1] != width * S * IN_CH):
        raise ValueError(f"bfm_chain_apply_folded: the volume must be "
                         f"(B, H2, {width}*64) bf16, got "
                         f"{tuple(vol_f.shape)} {vol_f.dtype}")


def _check_nhwc(vol: torch.Tensor, act: str) -> None:
    _check_act(act)
    if (vol.dtype != torch.bfloat16 or vol.dim() != 4
            or vol.shape[-1] != S * IN_CH):
        raise ValueError(f"bfm_chain_apply: the volume must be (B, H2, W2, "
                         f"64) bf16, got {tuple(vol.shape)} {vol.dtype}")


def bfm_chain_apply_folded_plain(vol_f, params, *, act: str = "silu",
                                 width: int):
    """Plain twin of kernel B4: (B, H2, W2*64) → (B, H2, W2*64) bf16."""
    _check_folded(vol_f, width, act)
    B, H2, WF = vol_f.shape
    h = bfm_chain_plain(vol_f.view(B, H2, width, S * IN_CH), params)
    pad = h.new_zeros(B, H2, width, 64 - S * MIXER)
    return torch.cat([h.reshape(B, H2, width, S * MIXER), pad],
                     dim=-1).view(B, H2, WF)


def bfm_chain_apply_plain(vol, params, *, act: str = "silu"):
    """Plain twin of kernel B7: (B, H2, W2, 64) → (B, H2, W2, 48) bf16."""
    _check_nhwc(vol, act)
    h = bfm_chain_plain(vol, params)
    return h.reshape(*vol.shape[:-1], S * MIXER)


def _launch(entry: str, vol, params, out, B, H2, W2):
    if not vol.is_contiguous() or vol.data_ptr() % 16:
        raise ValueError(f"{entry}: the volume must be contiguous and "
                         f"16-byte aligned")
    weights = _pack(chain_weights(params), vol.device)
    _build.launch("bfm_chain", entry, (vol, weights, out), (B, H2, W2),
                  vol.device)
    return out


def bfm_chain_apply_folded(vol_f, params, *, act: str = "silu",
                           width: int):
    """The chain on the folded p64 volume (pallas_stem.py:135-205).

    Args:
      vol_f: (B, H2, W2*64) bf16 folded patchified volume.
      params: the stem's chain parameters by state_dict name.
      width: W2, the quarter-resolution width.
    Returns (B, H2, W2*64) bf16: per pixel the 48 channels of h (s-major,
    [lvl0[0:4] | lvl1[0:4] | lvl2[0:4]] per subpixel), then 16 zeros.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and
    count the launch in `bfm_chain_apply_folded.launches`) or raise.
    """
    if vol_f.device.type == "cpu":
        return bfm_chain_apply_folded_plain(vol_f, params, act=act,
                                            width=width)
    if vol_f.device.type != "cuda":
        raise ValueError(f"bfm_chain_apply_folded: unsupported device "
                         f"{vol_f.device}")
    _check_folded(vol_f, width, act)
    B, H2, _ = vol_f.shape
    out = torch.empty_like(vol_f)
    _launch("bfm_chain_apply_folded", vol_f, params, out, B, H2, width)
    bfm_chain_apply_folded.launches += 1
    return out


bfm_chain_apply_folded.launches = 0


def bfm_chain_apply(vol, params, *, act: str = "silu"):
    """The chain on the NHWC p64 volume (pallas_stem.py:220-283).

    Args:
      vol: (B, H2, W2, 64) bf16 patchified volume.
      params: the stem's chain parameters by state_dict name.
    Returns h (B, H2, W2, 48) bf16, ready for the stem's 3x3 conv.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and
    count the launch in `bfm_chain_apply.launches`) or raise.
    """
    if vol.device.type == "cpu":
        return bfm_chain_apply_plain(vol, params, act=act)
    if vol.device.type != "cuda":
        raise ValueError(f"bfm_chain_apply: unsupported device {vol.device}")
    _check_nhwc(vol, act)
    B, H2, W2, _ = vol.shape
    out = torch.empty(B, H2, W2, S * MIXER, dtype=torch.bfloat16,
                      device=vol.device)
    _launch("bfm_chain_apply", vol, params, out, B, H2, W2)
    bfm_chain_apply.launches += 1
    return out


bfm_chain_apply.launches = 0
