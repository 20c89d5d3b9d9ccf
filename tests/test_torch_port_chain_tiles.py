"""The arithmetic and the weight packing of the chain kernels B4 and B7
(csrc/bfm_chain.cu), without a card.

The kernel runs the chain as mma.sync tiles of 16 subpixel blocks, with the
weights packed by `stem_chain._pack` into each lane's B fragments and
biases. These tests decode that block by the PTX fragment layout of
m16n8k16 / m16n8k8 (lane = 4 g + t; b0 holds B[2t][g], B[2t+1][g], b1
B[2t+8][g], B[2t+9][g]; a lane's biases are those of columns 2t, 2t+1),
then replay the kernel's steps in plain torch per 16-row tile: the 8-byte
input loads taken as k = 2t, 2t+1, 2t+8, 2t+9, f32 sums, bf16 rounding of
y0, y1, y2, act(u) and the output, h chosen lane-locally (y0's columns 0-3,
y1's columns 4-7, y2's columns 0-3), trans_down in three k16 chunks, the
residual in h's columns, and the ragged last tile masked per pixel.

Tolerance against the plain twin `bfm_chain_plain`: atol 1e-2 + rtol 1e-2
(a bf16-rounded intermediate may round the other way where the two sum in
another order), and equal bit for bit on at least 99.9% of outputs.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from frlw_evd_tpu_torch.models import stem_chain
from frlw_evd_tpu_torch.models.stems import BinsFusionModuleFolded

# (B, H2, W2); the last two have B*H2*W2 % 4 != 0, a ragged last tile
SHAPES = [(2, 4, 8), (1, 3, 5), (3, 2, 7)]
SEEDS = [0, 1, 2]


def _params(seed, dtype=torch.float32):
    stem = BinsFusionModuleFolded(16, 8)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in stem.chain_params().items():
            p.normal_(0.1 if name.endswith("bias") else 0.0, 0.3,
                      generator=g)
    return {k: v.detach().to(dtype) for k, v in stem.chain_params().items()}


def _halves(words):
    """int32 words → (lo, hi) f32 of their two bf16 halves."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    lo = ((w & 0xFFFF) << 16).to(torch.int32).view(torch.float32)
    hi = (w >> 16 << 16).to(torch.int32).view(torch.float32)
    return lo, hi


def _b_tile(block, w0, w1=None):
    """The (16, 8) B slice of words w0, w1 (or (8, 8) from w0 alone)."""
    m = torch.full((16 if w1 is not None else 8, 8), float("nan"))
    for word, k0 in ((w0, 0), (w1, 8)):
        if word is None:
            continue
        lo, hi = _halves(block[word])
        for lane in range(32):
            g, t = lane // 4, lane % 4
            m[k0 + 2 * t, g], m[k0 + 2 * t + 1, g] = lo[lane], hi[lane]
    return m


def _bias_row(block, first, n_tiles):
    """The biases of n_tiles n8 tiles from bias words first, first + 1, ...;
    every lane of a column holds the same value."""
    row = torch.full((8 * n_tiles,), float("nan"))
    for j in range(n_tiles):
        for e in (0, 1):
            vals = block[stem_chain.FRAG_WORDS + first + 2 * j + e].view(
                torch.float32)
            for t in range(4):
                col = vals[t::4]
                assert torch.equal(col, col[:1].expand(8))
                row[8 * j + 2 * t + e] = col[0]
    return row


def unpack(block):
    """The dense B operands and bias rows that the kernel's lanes hold."""
    assert block.shape == (stem_chain.PACK_WORDS, 32)
    assert block.dtype == torch.int32
    return {
        "w0": torch.cat([_b_tile(block, 0, 1), _b_tile(block, 2, 3)], 1),
        "w1": _b_tile(block, 4, 5),
        "w2": _b_tile(block, 6),
        "wu": torch.cat([_b_tile(block, 7 + 2 * j, 8 + 2 * j)
                         for j in range(6)], 1),
        "wd": torch.cat([torch.cat([_b_tile(block, 19 + 4 * c + 2 * j,
                                            20 + 4 * c + 2 * j)
                                    for j in range(2)], 1)
                         for c in range(3)], 0),
        "b0": _bias_row(block, 0, 2), "b1": _bias_row(block, 4, 1),
        "b2": _bias_row(block, 6, 1), "bu": _bias_row(block, 8, 6),
        "bd": _bias_row(block, 20, 2)}


def _bf16(t):
    return t.to(torch.bfloat16).float()


def emulate(vol_rows, n_pix, d, keep=None):
    """The kernel on (n_pix * 4, 16) bf16 subpixel rows, tile by tile:
    returns (n_pix * 4, 12) f32 outputs; `keep` collects h per tile."""
    out = torch.empty(n_pix * 4, 12)
    for p0 in range(0, n_pix, 4):
        x = torch.zeros(16, 16)
        rows = vol_rows[p0 * 4:min(p0 + 4, n_pix) * 4].float()
        x[:rows.shape[0]] = rows                  # masked per pixel
        a = torch.empty(16, 16)                   # lane t's 8-byte load
        for t in range(4):
            ks = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
            a[:, ks] = x[:, 4 * t:4 * t + 4]
        y0 = _bf16(F.relu(a @ d["w0"] + d["b0"]))
        y1 = _bf16(F.relu(y0 @ d["w1"] + d["b1"]))
        y2 = _bf16(F.relu(y1 @ d["w2"] + d["b2"]))
        h = torch.zeros(16, 16)       # lanes t < 2 take y0, y2; t >= 2 y1
        h[:, 0:4], h[:, 4:8] = y0[:, 0:4], y1[:, 4:8]
        h[:, 8:12] = y2[:, 0:4]
        dsum = torch.zeros(16, 16)
        for c in range(3):
            cols = slice(16 * c, 16 * c + 16)
            act = _bf16(F.silu(h @ d["wu"][:, cols] + d["bu"][cols]))
            dsum = dsum + act @ d["wd"][cols]
        res = _bf16(h + (dsum + d["bd"]))
        n = rows.shape[0]
        out[p0 * 4:p0 * 4 + n] = res[:n, :12]
        if keep is not None:
            keep.append((y0, y1, y2, h))
    return out


def _volume(shape, seed):
    B, H2, W2 = shape
    g = torch.Generator().manual_seed(100 + seed)
    return torch.rand(B, H2, W2, 64, generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_tile_emulation_matches_twin(seed, shape):
    params = _params(seed)
    vol = _volume(shape, seed)
    n_pix = vol[..., 0].numel()
    d = unpack(stem_chain._pack(stem_chain.chain_weights(params), "cpu"))
    got = emulate(vol.reshape(-1, 16), n_pix, d)
    want = stem_chain.bfm_chain_plain(vol, params).float().reshape(-1, 12)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    assert (got == want).float().mean().item() >= 0.999
    assert (want > 0.05).float().mean().item() > 0.2   # not all zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", SEEDS)
def test_pack_holds_the_weights_and_zero_pads(seed, dtype):
    """Each dense tile holds the chain's weights where the grouped structure
    (and the permutations) put them, and exactly 0 everywhere else."""
    w = stem_chain.chain_weights(_params(seed, dtype))
    d = unpack(stem_chain._pack(w, "cpu"))
    for k in range(16):
        c = stem_chain.x_channel(k)
        for o in range(16):
            want = w["w0"][o, c % 4] if c // 4 == o // 4 else 0.0
            assert d["w0"][k, o] == want
        for n in range(8):
            o = stem_chain.y1_channel(n)
            assert d["w1"][k, n] == (w["w1"][o, k % 8] if k // 8 == o // 4
                                     else 0.0)
    assert sorted(stem_chain.x_channel(k) for k in range(16)) == list(
        range(16))
    rotated = [stem_chain.y1_channel(k) for k in range(8)]
    torch.testing.assert_close(d["w2"][:, :4], w["w2"].T[rotated], rtol=0,
                               atol=0)
    torch.testing.assert_close(d["wu"][:12], w["wu"].T, rtol=0, atol=0)
    torch.testing.assert_close(d["wd"][:, :12], w["wd"].T, rtol=0, atol=0)
    for pad in (d["w2"][:, 4:], d["wu"][12:], d["wd"][:, 12:],
                d["b2"][4:], d["bd"][12:]):
        assert torch.equal(pad, torch.zeros_like(pad))
    torch.testing.assert_close(d["b0"], w["b0"], rtol=0, atol=0)
    torch.testing.assert_close(d["b1"], w["b1"][[stem_chain.y1_channel(n)
                                                 for n in range(8)]],
                               rtol=0, atol=0)
    torch.testing.assert_close(d["b2"][:4], w["b2"], rtol=0, atol=0)
    torch.testing.assert_close(d["bu"], w["bu"], rtol=0, atol=0)
    torch.testing.assert_close(d["bd"][:12], w["bd"], rtol=0, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_h_takes_each_level_in_place(seed):
    """y0[0:4], y1[0:4] and y2[0:4] land in h's columns 0-3, 4-7 and 8-11,
    computed here from chain_weights without the pack."""
    params = _params(seed)
    w = stem_chain.chain_weights(params)
    vol = _volume((1, 2, 4), seed)
    tiles = []
    emulate(vol.reshape(-1, 16), 8, unpack(stem_chain._pack(w, "cpu")), tiles)
    x = vol.reshape(-1, 16).float()
    y0 = _bf16(F.relu(torch.einsum("ngk,gok->ngo", x.view(-1, 4, 4),
                                   w["w0"].view(4, 4, 4)).reshape(-1, 16)
                      + w["b0"]))
    y1 = _bf16(F.relu(torch.einsum("ngk,gok->ngo", y0.view(-1, 2, 8),
                                   w["w1"].view(2, 4, 8)).reshape(-1, 8)
                      + w["b1"]))
    y2 = _bf16(F.relu(y1 @ w["w2"].T + w["b2"]))
    h = torch.cat([t[3] for t in tiles])
    torch.testing.assert_close(h[:, 0:4], y0[:, :4], rtol=0, atol=1e-6)
    torch.testing.assert_close(h[:, 4:8], y1[:, :4], rtol=0, atol=1e-6)
    torch.testing.assert_close(h[:, 8:12], y2, rtol=0, atol=1e-6)
    assert torch.equal(h[:, 12:], torch.zeros(h.shape[0], 4))


def test_pack_refuses_other_widths():
    """The kernels take the K = 8, embed 4 chain; K = 4 raises."""
    stem = BinsFusionModuleFolded(8, 8)
    with pytest.raises(ValueError, match="K = 8"):
        stem_chain._pack(stem_chain.chain_weights(stem.chain_params()), "cpu")


def test_packed_weights_follow_in_place_updates():
    """The wrapper's pack is kept while the parameters are unchanged, made
    anew after an in-place update, and every call for inference tensors."""
    stem = BinsFusionModuleFolded(16, 8)
    first = stem_chain.packed_weights(stem.chain_params(), "cpu")
    assert stem_chain.packed_weights(stem.chain_params(), "cpu") is first
    with torch.no_grad():
        stem.trans_down.bias.add_(0.5)
    fresh = stem_chain.packed_weights(stem.chain_params(), "cpu")
    want = stem_chain._pack(stem_chain.chain_weights(stem.chain_params()),
                            "cpu")
    assert fresh is not first and torch.equal(fresh, want)
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in stem.chain_params().items()}
    assert torch.equal(stem_chain.packed_weights(frozen, "cpu"), want)
