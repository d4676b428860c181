"""CTS-Net, the two-stage complex spectral decoupling net: the port of
se_tpu/models/ctsnet.py.

(B, T, F = 161, 2) noisy (re, im) -> stage 1 on the magnitude: 5 gated
convs (1 -> 64 channels, F 161 -> 4) with norm and PReLU, 3 stacks of 6
dilated GLU units (ShareSepConv smoothing) on the (B, T, 256) flattening,
their outputs summed, 5 gated deconvs on concat skips, Linear(161) over
frequency, softplus -> a magnitude at the noisy phase. Stage 2 takes
cat(noisy, stage 1) (4 channels) through the same shape with its own
weights and two decoders (real, imag), and its output is added to stage
1's. Norm variant "cln" (cumulative LN, causal) or "in" (InstanceNorm).

Module names follow the reference's two state_dicts under `step1.` and
`step2.`: stage 1 `en.en.{i}`, `tcm{1..3}.tcm_list.{i}`, `de.de.{i}`,
`de.de6.0`; stage 2 `en.en_module.{i}`, `tcm_list.{r}.glu_list.{i}` with
branches `ori_conv` / `att_ori`, `de_{r,i}.de_list.{i}`, `de_{r,i}.de6.0`
(se_tpu's `from_reference_state_dicts`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.models.tcm_parts import (
    GateConv2d, GatedConvEncoder, check_norm, finish, flatten_cf, norm1d,
    norm2d, put_gate_conv, put_gated_encoder, put_norm_act, run,
    unflatten_cf,
)
from se_tpu_torch.nn import Conv1d, Linear, PReLU, ShareSepConv
from se_tpu_torch.ops.stft import PRESET_320

STEP1_BRANCHES = ("left_conv", "right_conv")
STEP2_BRANCHES = ("ori_conv", "att_ori")


class GluBlock(nn.Module):
    """Dilated gated TCN unit on (B, T, 256): 1x1 in (64), two branches
    PReLU -> norm -> ShareSepConv(2d - 1) -> causal conv (k 5, dilation d),
    the second through a sigmoid, their product -> PReLU -> norm -> 1x1
    out (256), residual. Reference Sequential indices: branch 0-2 and 4
    (a pad at 3), out 0-2."""

    def __init__(self, dilation: int, norm: str, branches=STEP1_BRANCHES):
        super().__init__()
        d = dilation
        self.branches = branches
        self.in_conv = Conv1d(256, 64, bias=False)
        for name in branches:
            setattr(self, name, nn.ModuleDict({
                "0": PReLU(64), "1": norm1d(norm, 64),
                "2": ShareSepConv(2 * d - 1),
                "4": Conv1d(64, 64, 5, dilation=d, bias=False)}))
        self.out_conv = nn.ModuleDict({"0": PReLU(64), "1": norm1d(norm, 64),
                                       "2": Conv1d(64, 256, bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(x)
        left, right = (run(getattr(self, b), h) for b in self.branches)
        return run(self.out_conv, left * torch.sigmoid(right)) + x


class GluStack(nn.Module):
    """Six GluBlocks at dilations 1, 2, ..., 32 under `attr`."""

    def __init__(self, norm: str, attr: str = "tcm_list",
                 branches=STEP1_BRANCHES):
        super().__init__()
        self.attr = attr
        setattr(self, attr, nn.ModuleList(
            GluBlock(2 ** i, norm, branches) for i in range(6)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in getattr(self, self.attr):
            x = blk(x)
        return x


class Decoder(nn.Module):
    """5 x (concat skip; gated deconv, stride 2 over F, last frame dropped;
    norm; PReLU), 64 channels then 1 -> Linear(161) over frequency, then
    softplus (stage 1) or nothing (stage 2): (B, T, F)."""

    def __init__(self, norm: str, attr: str = "de", softplus: bool = True):
        super().__init__()
        self.attr, self.softplus = attr, softplus
        levels = []
        for i in range(5):
            ch = 1 if i == 4 else 64
            levels.append(nn.ModuleDict({
                "0": GateConv2d(128, ch, (2, 5) if i == 4 else (2, 3),
                                deconv=True),
                "1": norm2d(norm, ch), "2": PReLU(ch)}))
        setattr(self, attr, nn.ModuleList(levels))
        self.de6 = nn.ModuleDict({"0": Linear(161, 161)})

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i, level in enumerate(getattr(self, self.attr)):
            x = run(level, torch.cat([x, skips[-(i + 1)]], dim=-1))
        x = self.de6["0"](x[..., 0])
        return F.softplus(x) if self.softplus else x


def tcm_bottleneck(x: torch.Tensor, stages) -> torch.Tensor:
    """(B, T, F = 4, C = 64) -> (B, T, 256), C outer as the reference
    flattens it, through each stage in turn; the stages' outputs summed
    and unflattened."""
    h = flatten_cf(x)
    acc = torch.zeros_like(h)
    for stage in stages:
        h = stage(h)
        acc = acc + h
    return unflatten_cf(acc, x.shape[2])


class Step1Net(nn.Module):
    """The magnitude stage: (B, T, F) -> (B, T, F)."""

    def __init__(self, norm: str = "cln"):
        super().__init__()
        self.en = GatedConvEncoder(1, norm, "en")
        for r in range(3):
            setattr(self, f"tcm{r + 1}", GluStack(norm))
        self.de = Decoder(norm, "de", softplus=True)

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        x, skips = self.en(mag[..., None])
        x = tcm_bottleneck(x, [self.tcm1, self.tcm2, self.tcm3])
        return self.de(x, skips)


class Step2Net(nn.Module):
    """The complex residual stage: (B, T, F, 4) -> (B, T, F, 2)."""

    def __init__(self, norm: str = "cln", num_stages: int = 3):
        super().__init__()
        self.en = GatedConvEncoder(4, norm, "en_module")
        self.tcm_list = nn.ModuleList(
            GluStack(norm, "glu_list", STEP2_BRANCHES)
            for _ in range(num_stages))
        self.de_r = Decoder(norm, "de_list", softplus=False)
        self.de_i = Decoder(norm, "de_list", softplus=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, skips = self.en(x)
        x = tcm_bottleneck(x, self.tcm_list)
        return torch.stack([self.de_r(x, skips), self.de_i(x, skips)], -1)


class CTSNet(nn.Module):
    """Both stages chained as the reference's decode driver chains them.
    Weights are drawn from `generator` (seed 0 when None) with torch's
    init; `device=None` means the card."""

    def __init__(self, *, norm: str = "cln",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        norm = check_norm(norm)
        self.step1 = Step1Net(norm)
        self.step2 = Step2Net(norm)
        finish(self, generator, device)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, T, F, 2) (re, im) -> (B, T, F, 2)."""
        re, im = spec[..., 0], spec[..., 1]
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re)
        s1_mag = self.step1(mag)
        s1 = torch.stack([s1_mag * torch.cos(phase),
                          s1_mag * torch.sin(phase)], dim=-1)
        return s1 + self.step2(torch.cat([spec, s1], dim=-1))


def _put_glu(sd: dict, prefix: str, tree: dict, branches) -> None:
    jt.put_conv1d(sd, f"{prefix}.in_conv", tree["in_conv"])
    for tag, name in zip(("left", "right"), branches):
        p = f"{prefix}.{name}"
        jt.put_channel_prelu(sd, f"{p}.0", tree[f"{tag}_act"])
        jt.put_tcm_norm(sd, f"{p}.1", tree[f"{tag}_norm"], 1)
        jt.put_share_sep(sd, f"{p}.2", tree[f"{tag}_ssc"])
        jt.put_conv1d(sd, f"{p}.4", tree[f"{tag}_conv"])
    jt.put_channel_prelu(sd, f"{prefix}.out_conv.0", tree["out_act"])
    jt.put_tcm_norm(sd, f"{prefix}.out_conv.1", tree["out_norm"], 1)
    jt.put_conv1d(sd, f"{prefix}.out_conv.2", tree["out_conv"])


def _put_decoder(sd: dict, prefix: str, tree: dict) -> None:
    for i in range(5):
        p = f"{prefix}.{i}"
        put_gate_conv(sd, f"{p}.0", tree[f"gd{i}"], deconv=True)
        put_norm_act(sd, p, tree[f"norm{i}"], tree[f"act{i}"], 1)


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's CTSNet {"params"} tree -> this port's state_dict."""
    prm = variables["params"]
    sd: dict = {}
    s1, s2 = prm["step1"], prm["step2"]
    put_gated_encoder(sd, "step1.en.en", s1["en"])
    put_gated_encoder(sd, "step2.en.en_module", s2["en"])
    for r in range(3):
        for i in range(6):
            _put_glu(sd, f"step1.tcm{r + 1}.tcm_list.{i}",
                     s1[f"tcm{r + 1}"][f"glu{i}"], STEP1_BRANCHES)
            _put_glu(sd, f"step2.tcm_list.{r}.glu_list.{i}",
                     s2[f"tcm_list{r}"][f"glu{i}"], STEP2_BRANCHES)
    for prefix, attr, tree in (("step1.de", "de", s1["de"]),
                               ("step2.de_r", "de_list", s2["de_r"]),
                               ("step2.de_i", "de_list", s2["de_i"])):
        _put_decoder(sd, f"{prefix}.{attr}", tree)
        jt.put_dense(sd, f"{prefix}.de6.0", tree["fc"])
    return sd


register(
    ModelEntry(
        name="ctsnet",
        make=CTSNet,
        stft=PRESET_320,
        io_kind="complex_map",
        from_jax_variables=from_jax_variables,
        variants=("cln", "in"),
        bf16=True,
    )
)
