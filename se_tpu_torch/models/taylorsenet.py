"""TaylorSENet, the Taylor-unfolding enhancement framework: the port of
se_tpu/models/taylorsenet.py.

(B, T, F = 161, 2) noisy (re, im) -> the zero-order block (a U2Net
encoder of nested mini-U-nets, p stacks of 4 squeezed TCMs on the (B, T,
256) flattening, a U2Net decoder -> a sigmoid gain on the noisy magnitude
at the noisy phase) plus `order_num` high-order terms: a separate U2Net
encoder's flattened features concatenated with the previous term
flattened, a 1x1 conv to 256, p TCM stacks, real and imaginary 1x1 heads;
update_k = f(feat, prev) + k * prev, out += update_k / (k + 1)!. Its gated
convs are one conv of 2C outputs split main-then-gate. Norm variant "cln"
(cumulative LN) or "in" (InstanceNorm).

Module names follow the reference state_dict that se_tpu's
`from_reference_state_dict` reads: `zeroorderblock.{en,de}.meta_unet_list
.{i}` (`in_conv`, `enco.{j}.conv`, `deco.{j}.deconv`), `.last_conv`,
`zeroorderblock.tcms.{i}.tcm_list.{j}`, `separate_en`,
`highorderblock_list.{k}.{in_conv,tcms,real_resi,imag_resi}`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.models.tcm_parts import (
    CH, D_FEAT, ChunkGateConv2d, EnUnetModule, TcmList, U2NetEncoder,
    check_norm, count, finish, flatten_cf, norm2d, put_norm_act,
    put_tcm_list, put_unet, run, unflatten_cf,
)
from se_tpu_torch.nn import Conv1d, Conv2d, PReLU
from se_tpu_torch.ops.stft import PRESET_320

BINS = 161


def _encoder(k1, k2, norm: str) -> U2NetEncoder:
    """TaylorSENet's U2Net encoder: single-conv gates, the units' inner
    convs (kernel k2) causal."""
    return U2NetEncoder(ChunkGateConv2d, [((2, 5), 4), (k1, 3), (k1, 2),
                                          (k1, 1)], k2, k1, norm)


class U2NetDecoder(nn.Module):
    """inter_connect 'cat': (B, T, 4, CH) and the encoder's skips -> a
    sigmoid gain (B, T, 161)."""

    def __init__(self, k1, k2, norm: str):
        super().__init__()
        self.meta_unet_list = nn.ModuleList(
            EnUnetModule(ChunkGateConv2d(2 * CH, CH, k1, deconv=True),
                         CH, k2, scale, norm)
            for scale in (1, 2, 3, 4))
        self.last_conv = nn.ModuleDict({
            "0": ChunkGateConv2d(2 * CH, 16, (2, 5), deconv=True),
            "1": norm2d(norm, 16), "2": PReLU(16),
            "3": Conv2d(16, 1, (1, 1))})

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i, unit in enumerate(self.meta_unet_list):
            x = unit(torch.cat([x, skips[-(i + 1)]], dim=-1))
        x = run(self.last_conv, torch.cat([x, skips[0]], dim=-1))
        return torch.sigmoid(x[..., 0])


class ZeroOrderBlock(nn.Module):
    def __init__(self, k1, k2, kd1: int, p: int, norm: str):
        super().__init__()
        self.en = _encoder(k1, k2, norm)
        self.tcms = nn.ModuleList(TcmList(kd1, norm) for _ in range(p))
        self.de = U2NetDecoder(k1, k2, norm)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        en_x, skips = self.en(spec)
        h = flatten_cf(en_x)
        for tcms in self.tcms:
            h = tcms(h)
        return self.de(unflatten_cf(h, en_x.shape[2]), skips)


class HighOrderBlock(nn.Module):
    """feat (B, T, D_FEAT), pre (B, T, F, 2) -> (B, T, F, 2)."""

    def __init__(self, kd1: int, p: int, norm: str):
        super().__init__()
        self.in_conv = Conv1d(D_FEAT + 2 * BINS, D_FEAT)
        self.tcms = nn.ModuleList(TcmList(kd1, norm) for _ in range(p))
        self.real_resi = Conv1d(D_FEAT, BINS)
        self.imag_resi = Conv1d(D_FEAT, BINS)

    def forward(self, feat: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(torch.cat([feat, flatten_cf(pre)], dim=-1))
        for tcms in self.tcms:
            x = tcms(x)
        return torch.stack([self.real_resi(x), self.imag_resi(x)], dim=-1)


class TaylorSENet(nn.Module):
    """Constructor arguments as se_tpu's (its defaults: the reference's
    decode configuration). Weights are drawn from `generator` (seed 0 when
    None) with torch's init; `device=None` means the card."""

    def __init__(self, *, k1=(1, 3), k2=(2, 3), kd1: int = 5, p: int = 2,
                 order_num: int = 3, norm: str = "cln",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        norm = check_norm(norm)
        k1, k2 = tuple(k1), tuple(k2)
        self.zeroorderblock = ZeroOrderBlock(k1, k2, kd1, p, norm)
        self.separate_en = _encoder(k1, k2, norm)
        self.highorderblock_list = nn.ModuleList(
            HighOrderBlock(kd1, p, norm) for _ in range(order_num))
        finish(self, generator, device)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, T, F, 2) -> (B, T, F, 2)."""
        re, im = spec[..., 0], spec[..., 1]
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re)
        zmag = self.zeroorderblock(spec) * mag
        zero = torch.stack([zmag * torch.cos(phase),
                            zmag * torch.sin(phase)], dim=-1)
        feat = flatten_cf(self.separate_en(spec)[0])
        out, pre = zero, zero
        for k, block in enumerate(self.highorderblock_list):
            pre = block(feat, pre) + k * pre
            out = out + pre / math.factorial(k + 1)
        return out


# --------------------------------------------------------------- weights

def _gate_putter(kt: int, deconv: bool):
    """Places se_tpu's single-conv gate {conv} at ChunkGateConv2d's key."""
    sub = f".{0 if deconv else 1}" if kt > 1 else ""

    def put(sd: dict, prefix: str, tree: dict) -> None:
        jt.put_conv(sd, f"{prefix}.conv{sub}", tree["conv"], transpose=deconv)

    return put


def _put_unets(sd: dict, prefix: str, tree: dict, kts, k2t: int,
               deconv: bool) -> None:
    for i, kt in enumerate(kts):
        put_unet(sd, f"{prefix}.meta_unet_list.{i}", tree[f"unet{i}"],
                 _gate_putter(kt, deconv), k2t)


def _put_encoder(sd: dict, prefix: str, tree: dict, k1, k2) -> None:
    _put_unets(sd, prefix, tree, (2,) + (k1[0],) * 3, k2[0], False)
    _gate_putter(k1[0], False)(sd, f"{prefix}.last_conv.0", tree["last_gc"])
    put_norm_act(sd, f"{prefix}.last_conv", tree["last_norm"],
                 tree["last_act"], 1)


def _put_decoder(sd: dict, prefix: str, tree: dict, k1, k2) -> None:
    _put_unets(sd, prefix, tree, (k1[0],) * 4, k2[0], True)
    _gate_putter(2, True)(sd, f"{prefix}.last_conv.0", tree["last_gc"])
    put_norm_act(sd, f"{prefix}.last_conv", tree["last_norm"],
                 tree["last_act"], 1)
    jt.put_conv(sd, f"{prefix}.last_conv.3", tree["last_conv"])


def from_jax_variables(variables: dict, k1=(1, 3), k2=(2, 3)) -> dict:
    """se_tpu's TaylorSENet {"params"} tree -> this port's state_dict (k1,
    k2 as the model's: they set where the reference's pads sit)."""
    prm = variables["params"]
    sd: dict = {}
    zero = prm["zeroorder"]
    _put_encoder(sd, "zeroorderblock.en", zero["en"], k1, k2)
    _put_decoder(sd, "zeroorderblock.de", zero["de"], k1, k2)
    _put_encoder(sd, "separate_en", prm["separate_en"], k1, k2)
    for i in range(count(zero, "tcms")):
        put_tcm_list(sd, f"zeroorderblock.tcms.{i}", zero[f"tcms{i}"], "tcm")
    for k in range(count(prm, "high")):
        blk, p = prm[f"high{k}"], f"highorderblock_list.{k}"
        for name in ("in_conv", "real_resi", "imag_resi"):
            jt.put_conv1d(sd, f"{p}.{name}", blk[name])
        for i in range(count(blk, "tcms")):
            put_tcm_list(sd, f"{p}.tcms.{i}", blk[f"tcms{i}"], "tcm")
    return sd


register(
    ModelEntry(
        name="taylorsenet",
        make=TaylorSENet,
        stft=PRESET_320,
        io_kind="complex_map",
        from_jax_variables=from_jax_variables,
        variants=("cln", "in"),
        bf16=True,
    )
)
