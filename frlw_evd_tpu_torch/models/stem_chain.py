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

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _build
from ..utils.profiling import span

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

    levels = sum(name.endswith(".weight_v") for name in params)
    if levels != len(GROUPS):
        raise ValueError(f"the chain kernels take the K = 8, embed 4 BFM "
                         f"({len(GROUPS)} levels), got {levels} levels")
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


# The kernel's weight block (csrc/bfm_chain.cu): for each lane (g, t) =
# (lane // 4, lane % 4) of a warp, FRAG_WORDS B-fragment words of mma.sync
# (two bf16, the lower k in the low half), then N_BIASES f32 biases, those
# of columns 2t and 2t + 1 of each n8 tile; stored [word][lane].
FRAG_WORDS, N_BIASES = 31, 24
PACK_WORDS = FRAG_WORDS + N_BIASES
_FLAT = ("w0", "w1", "w2", "wu", "wd", "b0", "b1", "b2", "bu", "bd")
_FLAT_SIZES = (64, 64, 32, 576, 576, 16, 8, 4, 48, 12)


def x_channel(k: int) -> int:
    """The input channel that the A fragment takes as k: lane t loads
    channels 4t..4t+3 of a row as k = 2t, 2t+1, 2t+8, 2t+9."""
    return 4 * ((k % 8) // 2) + 2 * (k // 8) + k % 2


def y1_channel(n: int) -> int:
    """The y1 channel in column n of y1's C tile: rotated by 4, so that
    y1[0:4] sit in columns 4-7, where h takes them."""
    return (n + 4) % 8


def _dense_tiles() -> dict[str, np.ndarray]:
    """Each product's B operand (K, N) and each bias row (N,) as indices
    into the flat vector of _FLAT followed by one zero: the grouped convs as
    block-diagonal tiles, the permutations applied, every pad entry the
    index of that zero."""
    off = dict(zip(_FLAT, np.cumsum((0,) + _FLAT_SIZES)))
    zero = sum(_FLAT_SIZES)
    t = {"w0": np.full((16, 16), zero), "w1": np.full((16, 8), zero),
         "w2": np.full((8, 8), zero), "wu": np.full((16, 48), zero),
         "wd": np.full((48, 16), zero), "b0": off["b0"] + np.arange(16),
         "b1": off["b1"] + np.array([y1_channel(n) for n in range(8)]),
         "b2": np.full(8, zero), "bu": off["bu"] + np.arange(48),
         "bd": np.full(16, zero)}
    for k in range(16):
        c = x_channel(k)
        for o in range(16):                       # y0[o] <- x[4 (o//4) + j]
            if c // 4 == o // 4:
                t["w0"][k, o] = off["w0"] + o * 4 + c % 4
        for n in range(8):                        # y1[o] <- y0[8 (o//4) + j]
            o = y1_channel(n)
            if k // 8 == o // 4:
                t["w1"][k, n] = off["w1"] + o * 8 + k % 8
    for k in range(8):
        for n in range(4):
            t["w2"][k, n] = off["w2"] + n * 8 + y1_channel(k)
    t["wu"][:12] = (off["wu"] + np.arange(48)[None, :] * 12
                    + np.arange(12)[:, None])
    t["wd"][:, :12] = (off["wd"] + np.arange(12)[None, :] * 48
                       + np.arange(48)[:, None])
    t["b2"][:4] = off["b2"] + np.arange(4)
    t["bd"][:12] = off["bd"] + np.arange(12)
    return t


def _fragment_index() -> np.ndarray:
    """(2 * FRAG_WORDS * 32 + N_BIASES * 32,) indices into the flat vector:
    the B fragment halves [word][lane][half], then the biases [word][lane],
    in the order of csrc/bfm_chain.cu's kW* and kB* offsets."""
    t = _dense_tiles()
    lane = np.arange(32)
    g, tq = lane // 4, lane % 4

    def frag(mat, k0, n0, k16=True):
        """The b0 (and b1) words of the 16x8 (8x8) slice at (k0, n0)."""
        words = [np.stack([mat[k0 + 2 * tq, n0 + g],
                           mat[k0 + 2 * tq + 1, n0 + g]], -1)]
        if k16:
            words.append(np.stack([mat[k0 + 2 * tq + 8, n0 + g],
                                   mat[k0 + 2 * tq + 9, n0 + g]], -1))
        return words

    words = (frag(t["w0"], 0, 0) + frag(t["w0"], 0, 8) + frag(t["w1"], 0, 0)
             + frag(t["w2"], 0, 0, k16=False)
             + [w for j in range(6) for w in frag(t["wu"], 0, 8 * j)]
             + [w for c in range(3) for j in range(2)
                for w in frag(t["wd"], 16 * c, 8 * j)])
    biases = [row[8 * j + 2 * tq + e] for key in ("b0", "b1", "b2", "bu", "bd")
              for row in (t[key],) for j in range(len(row) // 8)
              for e in (0, 1)]
    assert len(words) == FRAG_WORDS and len(biases) == N_BIASES
    return np.concatenate([np.stack(words).reshape(-1),
                           np.stack(biases).reshape(-1)])


_INDEX: dict[torch.device, torch.Tensor] = {}


def _pack(w: dict[str, torch.Tensor], device) -> torch.Tensor:
    """The (PACK_WORDS, 32) int32 weight block of csrc/bfm_chain.cu from
    chain_weights: one gather from the flat weights, the fragment halves
    rounded to bf16 (exact: the weights are bf16 values) and paired."""
    flat = torch.cat([w[k].reshape(-1) for k in _FLAT]
                     + [w["b0"].new_zeros(1)]).to(device)
    index = _INDEX.get(flat.device)
    if index is None:
        index = _INDEX.setdefault(flat.device, torch.from_numpy(
            _fragment_index()).to(flat.device))
    vals = flat[index]
    n = 2 * FRAG_WORDS * 32
    return torch.cat([vals[:n].to(torch.bfloat16).view(torch.int32),
                      vals[n:].view(torch.int32)]).view(PACK_WORDS, 32)


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


_PACKED: dict[tuple, tuple] = {}       # key → (parameter tensors, block)
_PACKED_MAX = 8


def packed_weights(params, device) -> torch.Tensor:
    """_pack(chain_weights(params), device), kept while the parameter
    tensors stay as they were: weight norm and pack are some 35 small
    operations, more host time than the kernel takes. The key is each
    tensor's identity, storage and version counter, which every in-place
    update bumps (an edit through `.data` does not, and is not seen; nor
    does torch.optim's fused=True step, so the port's optimisers keep
    foreach, which does). Inference tensors keep no version counter and
    are packed every call."""
    tensors = tuple(params[k] for k in sorted(params))
    if any(t.is_inference() for t in tensors):
        return _pack(chain_weights(params), device)
    key = (str(device),) + tuple((id(t), t.data_ptr(), t._version)
                                 for t in tensors)
    hit = _PACKED.get(key)
    if hit is None:
        if len(_PACKED) >= _PACKED_MAX:
            del _PACKED[next(iter(_PACKED))]
        hit = _PACKED[key] = (tensors, _pack(chain_weights(params), device))
    return hit[1]


def _launch(entry: str, vol, params, out, B, H2, W2):
    if not vol.is_contiguous() or vol.data_ptr() % 16:
        raise ValueError(f"{entry}: the volume must be contiguous and "
                         f"16-byte aligned")
    weights = packed_weights(params, vol.device)
    _build.launch("bfm_chain", entry, (vol, weights, out), (B, H2, W2),
                  vol.device)
    return out


def _refuse_grad(entry: str, vol, params) -> None:
    """Kernels B4 and B7 have no backward, as the JAX package cannot
    differentiate their pallas_call: raise where a gradient is asked for,
    on any device, instead of running the (differentiable) twin."""
    if torch.is_grad_enabled() and (vol.requires_grad or any(
            p.requires_grad for p in params.values())):
        raise RuntimeError(f"{entry} has no backward: call it under "
                           f"torch.no_grad() or torch.inference_mode(), and "
                           f"train the 'bfm' stem instead")


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
    count the launch in `bfm_chain_apply_folded.launches`) or raise. Both
    raise where a gradient is asked for (`_refuse_grad`).
    """
    _refuse_grad("bfm_chain_apply_folded", vol_f, params)
    if vol_f.device.type == "cpu":
        with span("kernel.b4"):
            return bfm_chain_apply_folded_plain(vol_f, params, act=act,
                                                width=width)
    if vol_f.device.type != "cuda":
        raise ValueError(f"bfm_chain_apply_folded: unsupported device "
                         f"{vol_f.device}")
    _check_folded(vol_f, width, act)
    B, H2, _ = vol_f.shape
    out = torch.empty_like(vol_f)
    with span("kernel.b4"):
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
    count the launch in `bfm_chain_apply.launches`) or raise. Both raise
    where a gradient is asked for (`_refuse_grad`).
    """
    _refuse_grad("bfm_chain_apply", vol, params)
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
