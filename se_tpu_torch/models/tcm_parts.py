"""Parts shared by the TCM families (CTSNet, TaylorSENet, G2Net): the norm
of each variant, the reference's nn.Sequential slots, the two-conv gated
(de)conv and the gated-conv encoder, the nested mini-U-net, the squeezed
TCM units, weight init, and the helpers that carry se_tpu's trees of
these into the port's state_dict keys.

The reference builds its blocks as nn.Sequential, where a pad or a chomp
holds an index but no parameter. The port keeps those indices as the
string keys of an nn.ModuleDict (`slot`, `run`), the pads folded into the
layers, so that the port's state_dict has the reference's keys.
"""

from __future__ import annotations

import torch
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.nn import (
    Conv1d, Conv2d, ConvParams, ConvTranspose2d, CumulativeLayerNorm1d,
    CumulativeLayerNorm2d, InstanceNorm1d, InstanceNorm2d, Linear, PReLU,
)

NORMS = ("cln", "in")
CH = 64          # the encoders' and the squeezed TCMs' inner channels
D_FEAT = 256     # the TCMs' feature width, the (4, 64) encoding flattened
DILATIONS = (1, 2, 5, 9)  # a TcmList's four units


def check_norm(kind: str) -> str:
    if kind not in NORMS:
        raise ValueError(f"unknown norm {kind!r}: one of {NORMS}")
    return kind


def norm2d(kind: str, ch: int) -> nn.Module:
    """"cln": the cumulative LN over (F, C); "in": InstanceNorm over (T, F)."""
    return CumulativeLayerNorm2d(ch) if kind == "cln" else InstanceNorm2d(ch)


def norm1d(kind: str, ch: int) -> nn.Module:
    return CumulativeLayerNorm1d(ch) if kind == "cln" else InstanceNorm1d(ch)


def slot(index: int, module: nn.Module) -> nn.ModuleDict:
    """`module` at `index` of a reference nn.Sequential whose other entries
    hold no parameters."""
    return nn.ModuleDict({str(index): module})


def run(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The modules of an nn.ModuleDict `block` in order, each on the last
    one's output; any other module on x."""
    if not isinstance(block, nn.ModuleDict):
        return block(x)
    for mod in block.values():
        x = mod(x)
    return x


class GateConv2d(nn.Module):
    """conv(x) * sigmoid(gate_conv(x)), stride (1, 2) over (T, F): kt - 1
    causal frames of zeros before T (the reference's pad at index 0, the
    conv at `conv.1`), or with `deconv` transposed convs (at `conv.0`)
    with the last frame dropped (the chomp at index 1)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 deconv: bool = False):
        super().__init__()
        self.deconv = deconv

        def make():
            if deconv:
                return slot(0, ConvTranspose2d(cin, cout, kernel, (1, 2)))
            pad = ((kernel[0] - 1, 0), (0, 0))
            return slot(1, Conv2d(cin, cout, kernel, (1, 2), padding=pad))

        self.conv, self.gate_conv = make(), make()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = run(self.conv, x) * torch.sigmoid(run(self.gate_conv, x))
        return y[:, :-1] if self.deconv else y


def put_gate_conv(sd: dict, prefix: str, tree: dict, deconv: bool) -> None:
    """se_tpu's two-conv gate ({conv, gate_conv}) -> GateConv2d's keys."""
    index = 0 if deconv else 1
    for part in ("conv", "gate_conv"):
        jt.put_conv(sd, f"{prefix}.{part}.{index}", tree[part],
                    transpose=deconv)


def finish(model: nn.Module, generator: torch.Generator | None,
           device) -> None:
    """torch's init from `generator` (seed 0 when None) for every conv and
    Linear; norms and PReLU slopes at their defaults. Then the weights go
    to `device` (None: the card), in eval mode until train()."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for mod in model.modules():
        if isinstance(mod, (ConvParams, Conv1d, Linear)):
            mod.reset_parameters(generator)
    model.to(resolve_device(device)).eval()


def flatten_cf(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F, C) -> (B, T, C * F), C outer as the reference flattens
    (for a spectrum (B, T, F, 2): the re block, then the im block)."""
    b, t, f, c = x.shape
    return x.transpose(2, 3).reshape(b, t, c * f)


def unflatten_cf(x: torch.Tensor, f: int) -> torch.Tensor:
    """flatten_cf's inverse: (B, T, C * f) -> (B, T, f, C)."""
    b, t, n = x.shape
    return x.reshape(b, t, n // f, f).transpose(2, 3)


class GatedConvEncoder(nn.Module):
    """5 x (GateConv2d, stride 2 over F; norm; PReLU), CH channels, under
    `attr`: (B, T, 161, cin) -> (B, T, 4, CH) and the five outputs as
    skips (CTSNet's encoders, G2Net's UNet encoder)."""

    def __init__(self, cin: int, norm: str, attr: str):
        super().__init__()
        self.attr = attr
        setattr(self, attr, nn.ModuleList(nn.ModuleDict({
            "0": GateConv2d(cin if i == 0 else CH, CH,
                            (2, 5) if i == 0 else (2, 3)),
            "1": norm2d(norm, CH), "2": PReLU(CH)}) for i in range(5)))

    def forward(self, x: torch.Tensor):
        skips = []
        for level in getattr(self, self.attr):
            x = run(level, x)
            skips.append(x)
        return x, skips


class EnUnetModule(nn.Module):
    """`gate` (a gated conv or deconv taking the input) -> norm -> PReLU,
    then a mini-U-net of `scale` strided convs and deconvs (kernel k2,
    causal: kt - 1 frames padded before the convs and dropped after the
    deconvs; concat skips), added to the gate's output (TaylorSENet's and
    G2Net's En_unet_module). Reference indices: `in_conv.{0,1,2}`,
    `enco.{j}.conv.{conv, norm, act}` at 1-3 after a pad (kt > 1) or
    0-2, `deco.{j}.deconv.{deconv, norm, act}` at 0, 2, 3 around a chomp
    or 0-2."""

    def __init__(self, gate: nn.Module, ch: int, k2, scale: int,
                 norm: str):
        super().__init__()
        self.in_conv = nn.ModuleDict({"0": gate, "1": norm2d(norm, ch),
                                      "2": PReLU(ch)})
        kt = k2[0]
        ci, ni = (1, 2) if kt > 1 else (0, 1)
        self.chomp = kt - 1
        self.enco = nn.ModuleList(nn.ModuleDict({"conv": nn.ModuleDict({
            str(ci): Conv2d(ch, ch, k2, (1, 2),
                            padding=((kt - 1, 0), (0, 0))),
            str(ci + 1): norm2d(norm, ch), str(ci + 2): PReLU(ch)})})
            for _ in range(scale))
        self.deco = nn.ModuleList(nn.ModuleDict({"deconv": nn.ModuleDict({
            "0": ConvTranspose2d(ch if i == 0 else 2 * ch, ch, k2, (1, 2)),
            str(ni): norm2d(norm, ch), str(ni + 1): PReLU(ch)})})
            for i in range(scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_resi = run(self.in_conv, x)
        x, skips = x_resi, []
        for blk in self.enco:
            x = run(blk["conv"], x)
            skips.append(x)
        for i, blk in enumerate(self.deco):
            if i > 0:
                x = torch.cat([x, skips[-(i + 1)]], dim=-1)
            deconv, norm, act = blk["deconv"].values()
            x = deconv(x)
            if self.chomp:
                x = x[:, :-self.chomp]
            x = act(norm(x))
        return x_resi + x


class ChunkGateConv2d(nn.Module):
    """One conv of 2 * cout outputs, stride (1, 2), split into main and
    gate: main * sigmoid(gate). kt > 1: kt - 1 causal frames of zeros
    before T (the reference's pad at index 0, the conv at `conv.1`), or
    with `deconv` a transposed conv (at `conv.0`) with its last kt - 1
    frames dropped; kt = 1: a bare `conv`."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 deconv: bool = False):
        super().__init__()
        kt = kernel[0]
        if deconv:
            conv, index = ConvTranspose2d(cin, 2 * cout, kernel, (1, 2)), 0
        else:
            conv = Conv2d(cin, 2 * cout, kernel, (1, 2),
                          padding=((kt - 1, 0), (0, 0)))
            index = 1
        self.conv = slot(index, conv) if kt > 1 else conv
        self.chomp = kt - 1 if deconv else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = run(self.conv, x)
        if self.chomp:
            h = h[:, :-self.chomp]
        a, g = h.chunk(2, dim=-1)
        return a * torch.sigmoid(g)


class U2NetEncoder(nn.Module):
    """Four EnUnetModules (`units`: (gate kernel, scale) each; their gates
    made by `gate(cin, cout, kernel)`, the first on the 2 input channels),
    then a gate with `last_kernel` -> norm -> PReLU: (B, T, 161, 2) ->
    (B, T, 4, CH) and the five outputs as skips (TaylorSENet's and G2Net's
    U2Net_Encoder). Reference keys `meta_unet_list.{i}`, `last_conv`."""

    def __init__(self, gate, units, k2, last_kernel, norm: str):
        super().__init__()
        self.meta_unet_list = nn.ModuleList(
            EnUnetModule(gate(2 if i == 0 else CH, CH, k), CH, k2, scale,
                         norm)
            for i, (k, scale) in enumerate(units))
        self.last_conv = nn.ModuleDict({
            "0": gate(CH, CH, last_kernel), "1": norm2d(norm, CH),
            "2": PReLU(CH)})

    def forward(self, x: torch.Tensor):
        skips = []
        for unit in self.meta_unet_list:
            x = unit(x)
            skips.append(x)
        x = run(self.last_conv, x)
        skips.append(x)
        return x, skips


class SqueezedTCM(nn.Module):
    """Dilated TCN unit on (B, T, D_FEAT): 1x1 in (CH) -> PReLU -> norm ->
    causal conv (k, dilation d); `gated` (TaylorSENet): times a second
    such branch through a sigmoid; then PReLU -> norm -> 1x1 out (D_FEAT),
    residual (G2Net's Glu: not gated). Reference indices: branch 0, 1 and
    3 (a pad at 2), out 0-2."""

    def __init__(self, kernel: int, dilation: int, norm: str,
                 gated: bool = True):
        super().__init__()
        self.gated = gated
        self.in_conv = Conv1d(D_FEAT, CH, bias=False)
        for name in ("left_conv", "right_conv")[:1 + gated]:
            setattr(self, name, nn.ModuleDict({
                "0": PReLU(CH), "1": norm1d(norm, CH),
                "3": Conv1d(CH, CH, kernel, dilation=dilation,
                            bias=False)}))
        self.out_conv = nn.ModuleDict({
            "0": PReLU(CH), "1": norm1d(norm, CH),
            "2": Conv1d(CH, D_FEAT, bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(x)
        y = run(self.left_conv, h)
        if self.gated:
            y = y * torch.sigmoid(run(self.right_conv, h))
        return run(self.out_conv, y) + x


class TcmList(nn.Module):
    """SqueezedTCMs at DILATIONS, in turn."""

    def __init__(self, kernel: int, norm: str, gated: bool = True):
        super().__init__()
        self.tcm_list = nn.ModuleList(SqueezedTCM(kernel, d, norm, gated)
                                      for d in DILATIONS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for tcm in self.tcm_list:
            x = tcm(x)
        return x


# ------------------------------------------------- se_tpu's trees -> keys

def put_norm_act(sd: dict, prefix: str, norm: dict, act: dict,
                 at: int) -> None:
    """A 2-D norm at `{prefix}.{at}` and its PReLU at `at + 1`."""
    jt.put_tcm_norm(sd, f"{prefix}.{at}", norm, 2)
    jt.put_channel_prelu(sd, f"{prefix}.{at + 1}", act)


def put_gated_encoder(sd: dict, prefix: str, tree: dict) -> None:
    """se_tpu's gc{i} / norm{i} / act{i} -> GatedConvEncoder's levels at
    `{prefix}.{i}`."""
    for i in range(5):
        put_gate_conv(sd, f"{prefix}.{i}.0", tree[f"gc{i}"], deconv=False)
        put_norm_act(sd, f"{prefix}.{i}", tree[f"norm{i}"], tree[f"act{i}"],
                     1)


def put_unet(sd: dict, prefix: str, tree: dict, put_gate, k2t: int) -> None:
    """se_tpu's EnUnetModule tree -> EnUnetModule's keys; `put_gate(sd,
    prefix, tree)` places the gate's weights."""
    put_gate(sd, f"{prefix}.in_conv.0", tree["gc"])
    put_norm_act(sd, f"{prefix}.in_conv", tree["gc_norm"], tree["gc_act"], 1)
    ci, ni = (1, 2) if k2t > 1 else (0, 1)
    for j in range(count(tree, "enco", "_conv")):
        p = f"{prefix}.enco.{j}.conv"
        jt.put_conv(sd, f"{p}.{ci}", tree[f"enco{j}_conv"])
        put_norm_act(sd, p, tree[f"enco{j}_norm"], tree[f"enco{j}_act"],
                     ci + 1)
        p = f"{prefix}.deco.{j}.deconv"
        jt.put_conv(sd, f"{p}.0", tree[f"deco{j}_conv"], transpose=True)
        put_norm_act(sd, p, tree[f"deco{j}_norm"], tree[f"deco{j}_act"], ni)


def put_tcm_list(sd: dict, prefix: str, tree: dict, stem: str) -> None:
    """se_tpu's TCMList / TcmList ({stem}{i}: SqueezedTCM or Glu) ->
    TcmList's keys."""
    for i in range(count(tree, stem)):
        t, p = tree[f"{stem}{i}"], f"{prefix}.tcm_list.{i}"
        jt.put_conv1d(sd, f"{p}.in_conv", t["in_conv"])
        for tag in ("left", "right"):
            if f"{tag}_act" in t:
                jt.put_channel_prelu(sd, f"{p}.{tag}_conv.0", t[f"{tag}_act"])
                jt.put_tcm_norm(sd, f"{p}.{tag}_conv.1", t[f"{tag}_norm"], 1)
                jt.put_conv1d(sd, f"{p}.{tag}_conv.3", t[f"{tag}_conv"])
        jt.put_channel_prelu(sd, f"{p}.out_conv.0", t["out_act"])
        jt.put_tcm_norm(sd, f"{p}.out_conv.1", t["out_norm"], 1)
        jt.put_conv1d(sd, f"{p}.out_conv.2", t["out_conv"])


def count(tree: dict, stem: str, suffix: str = "") -> int:
    """How many of `{stem}0{suffix}`, `{stem}1{suffix}`, ... `tree` holds."""
    n = 0
    while f"{stem}{n}{suffix}" in tree:
        n += 1
    return n
