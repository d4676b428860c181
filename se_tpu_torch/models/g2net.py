"""G2Net (GaGNet), glance-and-focus multi-stage enhancement: the port of
se_tpu/models/g2net.py.

(B, T, F = 161, 2) noisy (re, im) -> a U2Net encoder (nested mini-U-nets
behind two-conv gates; or with `encoder_type="UNet"` five gated convs) ->
(B, T, 256) features, flattened C outer -> `stage_num` glance-and-focus
stages, each on cat(features, the previous estimate flattened re block
then im block) = 578 channels: the glance branch (gated 1x1 convs, TCM
stacks, a sigmoid gain on the previous magnitude at its phase) beside the
focus branch (gated 1x1 convs, two TCM stacks, real and imaginary
residuals) -> their sum is the stage's estimate. With `tcm_type=
"sub-band"` the stacks are MsTCMs (4 sub-bands run forward then
backward); with `is_aux` an add-skip deconv decoder's output joins the
last stage. Returns the stages' estimates (stages, B, T, F, 2). Norm
variant "cln" (cumulative LN) or "in" (InstanceNorm).

Module names of the default configuration follow the reference state_dict
that se_tpu's `from_reference_state_dict` reads: `en.meta_unet_list.{i}`,
`en.last_conv`, `gafs.{s}.glance_branch.{in_conv_main, in_conv_gate.0,
mstcm_filter.{i}}` (the last entry the output conv),
`gafs.{s}.focus_branch.{in_conv_main, in_conv_gate.0, mstcm_r.{i},
mstcm_i.{i}}`. The options, which se_tpu's loader does not read, keep
se_tpu's names: `en.en.{i}` (UNet), an MsTCM's `en.{i}` / `de.{i}`,
`aux_de.de.{i}` and `aux_de.de6`.
"""

from __future__ import annotations

import torch
from torch import nn

from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.models.tcm_parts import (
    CH, D_FEAT, DILATIONS, GateConv2d, GatedConvEncoder, TcmList,
    U2NetEncoder, check_norm, count, finish, flatten_cf, norm1d, norm2d,
    put_gate_conv, put_gated_encoder, put_norm_act, put_tcm_list, put_unet,
    run, slot,
)
from se_tpu_torch.nn import Conv1d, Conv2d, PReLU
from se_tpu_torch.ops.stft import PRESET_320

ENCODERS = ("U2Net", "UNet")
TCM_TYPES = ("full-band", "sub-band")
BANDS = 4  # an MsTCM's sub-bands of CH channels each


class MsTCM(nn.Module):
    """Sub-band TCM on (B, T, BANDS * CH): a chain of causal conv units
    (conv k 3 at the i-th of DILATIONS, with bias; norm; PReLU) forward
    over the bands, each fed its band concatenated to the last unit's
    output, then backward the same way; the two passes' outputs summed per
    band."""

    def __init__(self, norm: str):
        super().__init__()

        def unit(i):
            return nn.ModuleDict({
                "conv": Conv1d(CH if i == 0 else 2 * CH, CH, 3,
                               dilation=DILATIONS[i]),
                "norm": norm1d(norm, CH), "act": PReLU(CH)})

        self.en = nn.ModuleList(unit(i) for i in range(BANDS))
        self.de = nn.ModuleList(unit(i) for i in range(BANDS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = BANDS
        b, t, _ = x.shape
        bands = x.reshape(b, t, g, CH)
        fwd, bwd = [None] * g, [None] * g
        h = None
        for i, unit in enumerate(self.en):
            inp = bands[:, :, i]
            h = run(unit, inp if i == 0 else torch.cat([h, inp], dim=-1))
            fwd[i] = h
        for i, unit in enumerate(self.de):
            if i > 0:
                h = torch.cat([h, bands[:, :, g - 1 - i]], dim=-1)
            h = run(unit, h)
            bwd[g - 1 - i] = h
        out = torch.stack(fwd, dim=2) + torch.stack(bwd, dim=2)
        return out.reshape(b, t, g * CH)


def _stacks(tcm_num: int, norm: str, tcm_type: str, bins: int):
    """`tcm_num` TCM stacks and then the output 1x1 conv (D_FEAT -> bins),
    as the reference's Sequential holds them."""
    stacks = [MsTCM(norm) if tcm_type == "sub-band"
              else TcmList(3, norm, gated=False) for _ in range(tcm_num)]
    return nn.ModuleList(stacks + [Conv1d(D_FEAT, bins)])


class _Branch(nn.Module):
    """main(x) * sigmoid(gate(x)) -> D_FEAT channels, then each stack list
    in `self.heads` run in turn, its last entry the output conv."""

    def __init__(self, ci: int, heads: tuple[str, ...], tcm_num: int,
                 norm: str, tcm_type: str, bins: int):
        super().__init__()
        self.heads = heads
        self.in_conv_main = Conv1d(ci, D_FEAT)
        self.in_conv_gate = slot(0, Conv1d(ci, D_FEAT))
        for name in heads:
            setattr(self, name, _stacks(tcm_num, norm, tcm_type, bins))

    def _outputs(self, x: torch.Tensor):
        h = self.in_conv_main(x) * torch.sigmoid(run(self.in_conv_gate, x))
        outs = []
        for name in self.heads:
            y = h
            for mod in getattr(self, name):
                y = mod(y)
            outs.append(y)
        return outs


class GlanceBranch(_Branch):
    """-> a sigmoid gain (B, T, bins)."""

    def __init__(self, ci, tcm_num, norm, tcm_type, bins):
        super().__init__(ci, ("mstcm_filter",), tcm_num, norm, tcm_type,
                         bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._outputs(x)[0])


class FocusBranch(_Branch):
    """-> a complex residual (B, T, bins, 2)."""

    def __init__(self, ci, tcm_num, norm, tcm_type, bins):
        super().__init__(ci, ("mstcm_r", "mstcm_i"), tcm_num, norm, tcm_type,
                         bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._outputs(x), dim=-1)


class AuxDecoder(nn.Module):
    """5 x (add skip; gated deconv, last frame dropped; norm; PReLU), then
    a 1x1 conv to 2 channels: (B, T, 161, 2)."""

    def __init__(self, norm: str):
        super().__init__()
        self.de = nn.ModuleList(nn.ModuleDict({
            "0": GateConv2d(CH, CH, (2, 5) if i == 4 else (2, 3),
                            deconv=True),
            "1": norm2d(norm, CH), "2": PReLU(CH)})
            for i in range(5))
        self.de6 = Conv2d(CH, 2, (1, 1))

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i, level in enumerate(self.de):
            if i > 0:
                x = x + skips[-(i + 1)]
            x = run(level, x)
        return self.de6(x)


class G2Net(nn.Module):
    """Constructor arguments as se_tpu's (its defaults: the reference's
    decode configuration). Weights are drawn from `generator` (seed 0 when
    None) with torch's init; `device=None` means the card."""

    def __init__(self, *, stage_num: int = 3, tcm_num: int = 2,
                 bins: int = 161, norm: str = "cln",
                 encoder_type: str = "U2Net", tcm_type: str = "full-band",
                 is_aux: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        norm = check_norm(norm)
        if encoder_type not in ENCODERS or tcm_type not in TCM_TYPES:
            raise ValueError(f"encoder_type one of {ENCODERS}, tcm_type one "
                             f"of {TCM_TYPES}")
        self.is_aux = is_aux
        if encoder_type == "U2Net":  # two-conv gates, inner convs (1, 3)
            self.en = U2NetEncoder(GateConv2d, [((2, 5), 4), ((2, 3), 3),
                                                ((2, 3), 2), ((2, 3), 1)],
                                   (1, 3), (2, 3), norm)
        else:
            self.en = GatedConvEncoder(2, norm, "en")
        ci = D_FEAT + 2 * bins
        self.gafs = nn.ModuleList(nn.ModuleDict({
            "glance_branch": GlanceBranch(ci, tcm_num, norm, tcm_type, bins),
            "focus_branch": FocusBranch(ci, tcm_num, norm, tcm_type, bins)})
            for _ in range(stage_num))
        if is_aux:
            self.aux_de = AuxDecoder(norm)
        finish(self, generator, device)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, T, F, 2) -> (stages, B, T, F, 2)."""
        feat, skips = self.en(spec)
        feat_flat = flatten_cf(feat)
        pre, outs = spec, []
        for s, gaf in enumerate(self.gafs):
            pre_mag = torch.sqrt(pre[..., 0] ** 2 + pre[..., 1] ** 2)
            pre_phase = torch.atan2(pre[..., 1], pre[..., 0])
            x = torch.cat([feat_flat, flatten_cf(pre)], dim=-1)
            mag = pre_mag * gaf["glance_branch"](x)
            est = torch.stack([mag * torch.cos(pre_phase),
                               mag * torch.sin(pre_phase)], dim=-1) \
                + gaf["focus_branch"](x)
            if s == len(self.gafs) - 1 and self.is_aux:
                est = est + self.aux_de(feat, skips)
            pre = est
            outs.append(est)
        return torch.stack(outs, dim=0)


# --------------------------------------------------------------- weights

def _put_gate(sd: dict, prefix: str, tree: dict) -> None:
    put_gate_conv(sd, prefix, tree, deconv=False)


def _put_stacks(sd: dict, prefix: str, tree: dict, stem: str,
                out: str) -> None:
    """se_tpu's `{stem}{i}` stacks and `out` conv -> `{prefix}.{i}` and
    `{prefix}.{tcm_num}`."""
    n = count(tree, stem)
    for i in range(n):
        stack, p = tree[f"{stem}{i}"], f"{prefix}.{i}"
        if "glu0" in stack:
            put_tcm_list(sd, p, stack, "glu")
            continue
        for part in ("en", "de"):  # MsTCM
            for j in range(count(stack, part)):
                unit, q = stack[f"{part}{j}"], f"{p}.{part}.{j}"
                jt.put_conv1d(sd, f"{q}.conv", unit["conv"])
                jt.put_tcm_norm(sd, f"{q}.norm", unit["norm"], 1)
                jt.put_channel_prelu(sd, f"{q}.act", unit["act"])
    jt.put_conv1d(sd, f"{prefix}.{n}", tree[out])


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's G2Net {"params"} tree (any of its options) -> this port's
    state_dict."""
    prm = variables["params"]
    sd: dict = {}
    en = prm["en"]
    if "gc0" in en:  # UNet
        put_gated_encoder(sd, "en.en", en)
    else:
        for i in range(4):
            put_unet(sd, f"en.meta_unet_list.{i}", en[f"unet{i}"], _put_gate,
                     1)
        _put_gate(sd, "en.last_conv.0", en["last_gc"])
        put_norm_act(sd, "en.last_conv", en["last_norm"], en["last_act"], 1)
    for s in range(count(prm, "glance")):
        p = f"gafs.{s}"
        for branch, tree in (("glance_branch", prm[f"glance{s}"]),
                             ("focus_branch", prm[f"focus{s}"])):
            jt.put_conv1d(sd, f"{p}.{branch}.in_conv_main",
                          tree["in_conv_main"])
            jt.put_conv1d(sd, f"{p}.{branch}.in_conv_gate.0",
                          tree["in_conv_gate"])
        _put_stacks(sd, f"{p}.glance_branch.mstcm_filter", prm[f"glance{s}"],
                    "tcm", "out_conv")
        for part in ("r", "i"):
            _put_stacks(sd, f"{p}.focus_branch.mstcm_{part}",
                        prm[f"focus{s}"], f"tcm_{part}", f"out_conv_{part}")
    if "aux_de" in prm:
        aux = prm["aux_de"]
        for i in range(5):
            put_gate_conv(sd, f"aux_de.de.{i}.0", aux[f"de{i}"], deconv=True)
            put_norm_act(sd, f"aux_de.de.{i}", aux[f"norm{i}"],
                         aux[f"act{i}"], 1)
        jt.put_conv(sd, "aux_de.de6", aux["de6"])
    return sd


register(
    ModelEntry(
        name="g2net",
        make=G2Net,
        stft=PRESET_320,
        io_kind="complex_map",
        from_jax_variables=from_jax_variables,
        variants=("cln", "in"),
        inverted_gain=True,
        bf16=True,
    )
)
