"""DeepXi's input/target family: the port of se_tpu/models/deepxi_inp_tgt.py
(ref DeepXi/deepxi/inp_tgt.py:22-962).

Each class pairs an observation (what the network sees), a training target
and an enhancement rule; `inp_tgt_selector` picks one by name (ref
inp_tgt.py:22-66):

- MagXi        magnitude in, mapped a-priori SNR out (the shipped default)
- MagGamma     magnitude in, mapped a-posteriori SNR out
- MagXiGamma   magnitude in, both SNRs out
- MagGain      magnitude in, a gain function as the target
- MagMag       magnitude in, mapped clean magnitude out
- MagSMM       magnitude in, spectral magnitude mask (clipped at 5)
- MagPhaXiPha  magnitude and phase in, mapped SNR and clean phase out
- STDCTXiCD    STDCT in, mapped SNR and constructive/destructive target

Pairs come pre-mixed as (clean, noisy): `mix` derives the noise d = x - s
(ref deepxi/sig.py:193-218). Waveforms are (B, n) tensors; on the card
`polar_analysis` runs the STFT kernel, which has no gradient: the
waveforms of a train step must not require grad (they do not).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from se_tpu_torch.eval.gains import gfunc
from se_tpu_torch.models.deepxi import (
    XiMap, instantaneous_xi, polar_analysis, polar_synthesis,
)
from se_tpu_torch.ops.stdct import inverse_stdct, stdct
from se_tpu_torch.ops.stft import PRESET_DEEPXI


def normalise_int(x) -> torch.Tensor:
    """int16-scale waveform -> [-1, 1) float (ref sig.py:220-231)."""
    return torch.as_tensor(x).to(torch.float32) / 32768.0


def n_frames(n: int, hop: int = PRESET_DEEPXI.hop) -> int:
    return -(-n // hop)


def instantaneous_gamma(x_spec, d_spec):
    return torch.square(x_spec) / torch.clamp(torch.square(d_spec),
                                              min=1e-12)


def constructive_deconstructive(s_spec, d_spec):
    """cd = S * D (ref sig.py:136-147)."""
    return s_spec * d_spec


def mix(s, x):
    """(clean, noisy) -> (s, d, x) with d = x - s (this fork's convention)."""
    return s, x - s, x


@dataclasses.dataclass
class MagXi:
    xi_map: XiMap

    n_feat: int = 257
    n_outp: int = 257

    def observation(self, x):
        return polar_analysis(x)

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_stms, _ = polar_analysis(s)
        d_stms, _ = polar_analysis(d)
        x_stms, _ = polar_analysis(x)
        return x_stms, self.xi_map.map(instantaneous_xi(s_stms, d_stms))

    def enhanced_speech(self, x_stms, x_stps, xi_bar_hat, gtype, length=None):
        xi_hat = self.xi_map.inverse(xi_bar_hat)
        g = gfunc(xi_hat, xi_hat + 1.0, gtype)
        return polar_synthesis(x_stms * g, x_stps, length=length)


@dataclasses.dataclass
class MagGamma:
    gamma_map: XiMap

    n_feat: int = 257
    n_outp: int = 257

    def observation(self, x):
        return polar_analysis(x)

    def example(self, s, x):
        s, d, x = mix(s, x)
        d_stms, _ = polar_analysis(d)
        x_stms, _ = polar_analysis(x)
        return x_stms, self.gamma_map.map(instantaneous_gamma(x_stms,
                                                              d_stms))

    def enhanced_speech(self, x_stms, x_stps, gamma_bar_hat, gtype,
                        xi_hat=None, length=None):
        """Takes an outside xi estimate (the reference loads it from .mat,
        ref inp_tgt.py:295-327); without one, xi = max(gamma - 1, eps)."""
        gamma_hat = self.gamma_map.inverse(gamma_bar_hat)
        if xi_hat is None:
            xi_hat = torch.clamp(gamma_hat - 1.0, min=1e-12)
        g = gfunc(xi_hat, gamma_hat, gtype)
        return polar_synthesis(x_stms * g, x_stps, length=length)


@dataclasses.dataclass
class MagXiGamma:
    xi_map: XiMap
    gamma_map: XiMap

    n_feat: int = 257
    n_outp: int = 514

    def observation(self, x):
        return polar_analysis(x)

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_stms, _ = polar_analysis(s)
        d_stms, _ = polar_analysis(d)
        x_stms, _ = polar_analysis(x)
        xi_bar = self.xi_map.map(instantaneous_xi(s_stms, d_stms))
        gamma_bar = self.gamma_map.map(instantaneous_gamma(x_stms, d_stms))
        return x_stms, torch.cat([xi_bar, gamma_bar], dim=-1)

    def enhanced_speech(self, x_stms, x_stps, pred, gtype, length=None):
        xi_bar_hat, gamma_bar_hat = torch.chunk(pred, 2, dim=-1)
        xi_hat = self.xi_map.inverse(xi_bar_hat)
        gamma_hat = self.gamma_map.inverse(gamma_bar_hat)
        g = gfunc(xi_hat, gamma_hat, gtype)
        return polar_synthesis(x_stms * g, x_stps, length=length)


@dataclasses.dataclass
class MagGain:
    gain: str = "mmse-lsa"

    n_feat: int = 257
    n_outp: int = 257

    def observation(self, x):
        return polar_analysis(x)

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_stms, _ = polar_analysis(s)
        d_stms, _ = polar_analysis(d)
        x_stms, _ = polar_analysis(x)
        xi = instantaneous_xi(s_stms, d_stms)
        gamma = instantaneous_gamma(x_stms, d_stms)
        return x_stms, gfunc(xi, gamma, self.gain)

    def enhanced_speech(self, x_stms, x_stps, g_hat, gtype=None, length=None):
        if self.gain == "ibm":
            g_hat = (g_hat > 0.5).to(torch.float32)
        return polar_synthesis(x_stms * g_hat, x_stps, length=length)


@dataclasses.dataclass
class MagMag:
    mag_map: XiMap

    n_feat: int = 257
    n_outp: int = 257

    def observation(self, x):
        return polar_analysis(x)

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_stms, _ = polar_analysis(s)
        x_stms, _ = polar_analysis(x)
        return x_stms, self.mag_map.map(s_stms)

    def enhanced_speech(self, x_stms, x_stps, s_stms_bar_hat, gtype=None,
                        length=None):
        s_stms_hat = self.mag_map.inverse(s_stms_bar_hat)
        return polar_synthesis(s_stms_hat, x_stps, length=length)


@dataclasses.dataclass
class MagSMM:
    n_feat: int = 257
    n_outp: int = 257
    clip: float = 5.0

    def observation(self, x):
        return polar_analysis(x)

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_stms, _ = polar_analysis(s)
        x_stms, _ = polar_analysis(x)
        smm = torch.clamp(s_stms / torch.clamp(x_stms, min=1e-12), 0.0,
                          self.clip)
        return x_stms, smm

    def enhanced_speech(self, x_stms, x_stps, smm_hat, gtype=None,
                        length=None):
        return polar_synthesis(smm_hat * x_stms, x_stps, length=length)


@dataclasses.dataclass
class MagPhaXiPha:
    """Magnitude and phase in; mapped SNR and mapped clean phase out (ref
    inp_tgt.py:675-806)."""

    xi_map: XiMap
    s_stps_map: XiMap

    n_feat: int = 514
    n_outp: int = 514

    def observation(self, x):
        stms, stps = polar_analysis(x)
        return torch.cat([stms, stps], dim=-1), None

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_stms, s_stps = polar_analysis(s)
        d_stms, _ = polar_analysis(d)
        x_stms, x_stps = polar_analysis(x)
        obs = torch.cat([x_stms, x_stps], dim=-1)
        xi_bar = self.xi_map.map(instantaneous_xi(s_stms, d_stms))
        s_stps_bar = self.s_stps_map.map(s_stps)
        return obs, torch.cat([xi_bar, s_stps_bar], dim=-1)

    def enhanced_speech(self, x_stms_stps, _dummy, pred, gtype, length=None):
        x_stms, _ = torch.chunk(x_stms_stps, 2, dim=-1)
        xi_bar_hat, s_stps_bar_hat = torch.chunk(pred, 2, dim=-1)
        xi_hat = self.xi_map.inverse(xi_bar_hat)
        y_stps = self.s_stps_map.inverse(s_stps_bar_hat)
        g = gfunc(xi_hat, xi_hat + 1.0, gtype)
        return polar_synthesis(x_stms * g, y_stps, length=length)


@dataclasses.dataclass
class STDCTXiCD:
    """STDCT in; mapped SNR and constructive/destructive target out (ref
    inp_tgt.py:808-962)."""

    xi_map: XiMap
    cd_map: XiMap
    frame_length: int = 512
    frame_step: int = 256
    k: int = 512

    n_feat: int = 512
    n_outp: int = 1024

    def _analysis(self, x):
        return stdct(x, self.frame_length, self.frame_step, self.k,
                     window="hamming", pad_end=True)

    def observation(self, x):
        return self._analysis(x), None

    def example(self, s, x):
        s, d, x = mix(s, x)
        s_c = self._analysis(s)
        d_c = self._analysis(d)
        x_c = self._analysis(x)
        xi_bar = self.xi_map.map(instantaneous_xi(s_c, d_c))
        cd_bar = self.cd_map.map(constructive_deconstructive(s_c, d_c))
        return x_c, torch.cat([xi_bar, cd_bar], dim=-1)

    def enhanced_speech(self, x_stdct, _dummy, pred, gtype, length=None):
        xi_bar_hat, cd_bar_hat = torch.chunk(pred, 2, dim=-1)
        xi_hat = self.xi_map.inverse(xi_bar_hat)
        cdm = self.cd_map.inverse(cd_bar_hat) > 0.0
        g = gfunc(xi_hat, xi_hat + 1.0, gtype, cdm=cdm)
        return inverse_stdct(x_stdct * g, self.frame_length, self.frame_step,
                             self.k, window="hamming", length=length)


def inp_tgt_selector(kind: str, **maps: Any):
    """(ref inp_tgt.py:22-66)."""
    table = {
        "MagXi": MagXi,
        "MagGamma": MagGamma,
        "MagXiGamma": MagXiGamma,
        "MagGain": MagGain,
        "MagMag": MagMag,
        "MagSMM": MagSMM,
        "MagPhaXiPha": MagPhaXiPha,
        "STDCTXiCD": STDCTXiCD,
    }
    if kind not in table:
        raise ValueError(f"unknown inp_tgt type {kind!r}")
    return table[kind](**maps)
