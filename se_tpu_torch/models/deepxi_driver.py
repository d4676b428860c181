"""DeepXi's train, infer and test driver: the port of
se_tpu/models/deepxi_driver.py (ref DeepXi/deepxi/model.py:34-711).

(clean, noisy) batches -> MagXi examples -> BCE with a frame mask;
elementwise gradient clipping and Adam (optax's `chain(clip(1.0),
adam(lr))`, `train.trainer.adam_update`'s arithmetic); inference predicts
the mapped xi and applies a statistical gain (`models.deepxi.enhance`);
test scores each utterance into CSVs (`eval.metrics`, a copy of
se_tpu's).

Everything runs where the driver's model lives: on the card unless the
driver is built with `device="cpu"`.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import pickle

import numpy as np
import torch

from se_tpu_torch.data.wav import read_wav, resample, write_wav
from se_tpu_torch.eval import metrics
from se_tpu_torch.models.deepxi import (
    DeepXi, XiMap, compute_xi_stats, enhance,
)
from se_tpu_torch.models.deepxi_inp_tgt import (
    MagXi, inp_tgt_selector, n_frames,
)
from se_tpu_torch.train.trainer import adam_state, adam_update


def snr_db(s: np.ndarray, d: np.ndarray) -> float:
    """SNR (dB) between speech and noise (ref deepxi/sig.py:358-374)."""
    p_s = float(np.mean(np.square(s)))
    p_d = float(np.mean(np.square(d)))
    return 10.0 * np.log10(p_s / max(p_d, 1e-12))


def masked_bce(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of `pred` (clipped to [1e-7, 1 - 1e-7]) against
    `target`, (B, T, F), summed over the frames where `mask` (B, T) is 1
    and divided by their count times F (at least 1)."""
    p = torch.clamp(pred, 1e-7, 1 - 1e-7)
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    m = mask[..., None]
    return torch.sum(bce * m) / torch.clamp(torch.sum(m) * pred.shape[-1],
                                            min=1.0)


def clipped_adam_step(model: torch.nn.Module, opt_state: dict, lr: float,
                      clip_value: float) -> None:
    """optax `chain(clip(clip_value), adam(lr))` on the gradients in the
    parameters' `.grad`: each entry clipped to [-clip_value, clip_value],
    then Adam, in place."""
    params = dict(model.named_parameters())
    grads = {n: torch.clamp(p.grad, -clip_value, clip_value)
             for n, p in params.items()}
    with torch.no_grad():
        adam_update(params, grads, opt_state, lr, None)


class Prelim:
    """Toy trainer that checks a network and the frame masking (ref
    DeepXi/deepxi/prelim.py:18-98): fit a constant 5-value frame target
    from uniform random inputs with BCE and per-utterance frame masks.
    `train()` returns the target and the prediction of its first frame."""

    def __init__(self, n_feat: int, network: str = "ResNet", *,
                 device=None, **net_kwargs):
        if n_feat < 5:
            raise ValueError("More input features are required for this "
                             "example.")
        if network == "ResNet":
            kw = dict(n_blocks=40, d_model=256, d_f=64, k=3, max_d_rate=16)
        elif network == "ResLSTM":
            kw = dict(n_blocks=3, d_model=256)
        else:
            raise ValueError("Invalid network type.")
        kw.update(net_kwargs)
        self.n_feat, self.network, self.kw = n_feat, network, kw
        self.device = device

    def _target_frame(self) -> np.ndarray:
        y = np.zeros(self.n_feat, np.float32)
        y[:5] = [0.05, 0.99, 0.5, 0.01, 0.75]
        return y

    def train(self, mbatch_size: int = 8, max_epochs: int = 20,
              batch_size: int = 100, max_seq_len: int = 75,
              min_seq_len: int = 45, lr: float = 1e-3, seed: int = 0):
        """The batches are drawn from numpy's generator at `seed` as
        se_tpu's; the weights from torch's at `seed`."""
        model = DeepXi(self.network, self.n_feat, tuple(self.kw.items()),
                       generator=torch.Generator().manual_seed(seed),
                       device=self.device)
        dev = next(model.parameters()).device
        opt_state = adam_state(dict(model.named_parameters()))
        rng = np.random.default_rng(seed)
        y_frame = self._target_frame()
        x = None
        for _ in range(max_epochs):
            for _ in range(math.ceil(batch_size / mbatch_size)):
                x = rng.random((mbatch_size, max_seq_len, self.n_feat),
                               dtype=np.float32)
                seq_len = rng.integers(min_seq_len, max_seq_len + 1,
                                       mbatch_size)
                mask = (np.arange(max_seq_len)[None] <
                        seq_len[:, None]).astype(np.float32)
                x *= mask[..., None]
                y = np.tile(y_frame, (mbatch_size, max_seq_len, 1)) \
                    * mask[..., None]
                model.zero_grad(set_to_none=True)
                loss = masked_bce(model(torch.from_numpy(x).to(dev)),
                                  torch.from_numpy(y).to(dev),
                                  torch.from_numpy(mask).to(dev))
                loss.backward()
                clipped_adam_step(model, opt_state, lr, 1.0)
        with torch.no_grad():
            pred = model(torch.from_numpy(x[:1]).to(dev))
        return y_frame, pred[0, 0].cpu().numpy()


@dataclasses.dataclass
class DeepXiArgs:
    """The reference's flags (ref DeepXi/deepxi/args_resnet.py:31-135 /
    config_resnet.py), as se_tpu's: what shapes the model, the features,
    the map and the run mode. `DeepXiDriver.from_args` consumes it."""

    # general (args_resnet.py:35-46)
    ver: str = "resnet-1.1c"
    test_epoch: int = 180
    train: bool = False
    infer: bool = False
    test: bool = False
    network_type: str = "ResNetV2"
    inp_tgt_type: str = "MagXi"
    # train (args_resnet.py:48-56)
    mbatch_size: int = 8
    sample_size: int = 1000
    max_epochs: int = 180
    resume_epoch: int = 0
    # inference (args_resnet.py:63-69)
    out_type: str = "y"
    gain: str = "mmse-lsa"
    # paths (args_resnet.py:80-89)
    model_path: str = "./model"
    set_path: str = "./set"
    log_path: str = "./log"
    data_path: str = "./data"
    out_path: str = "./out"
    # features (args_resnet.py:92-98)
    f_s: int = 16000
    T_d: int = 32
    T_s: int = 16
    # network parameters (args_resnet.py:101-122)
    d_model: int = 256
    n_blocks: int = 40
    d_f: int = 64
    k: int = 3
    max_d_rate: int = 16
    causal: bool = True
    unit_type: str = "ReLU->LN->W+b"
    loss_fnc: str = "BinaryCrossentropy"
    outp_act: str = "Sigmoid"
    # map (args_resnet.py:125-127)
    map_type: str = "DBNormalCDF"

    def network_kwargs(self) -> tuple:
        if self.network_type.startswith("ResNet"):
            return (("d_model", self.d_model), ("n_blocks", self.n_blocks),
                    ("d_f", self.d_f), ("k", self.k),
                    ("max_d_rate", self.max_d_rate),
                    ("outp_act", self.outp_act)) + (
                (("unit_type", self.unit_type),)
                if self.network_type != "ResNet" else ())
        if self.network_type.startswith("MHANet"):
            return (("d_model", self.d_model), ("n_blocks", self.n_blocks),
                    ("causal", self.causal), ("outp_act", self.outp_act))
        return (("d_model", self.d_model), ("n_blocks", self.n_blocks),
                ("outp_act", self.outp_act))


class DeepXiDriver:
    """The model (weights from torch's generator at seed 0, as se_tpu's
    from PRNGKey(0)), its xi map and the input/target; `ver` names the
    statistics file as the reference's data/<ver>_inp_tgt.p (ref
    model.py:84-96). `device=None` means the card. As se_tpu's, an
    `inp_tgt_type` other than MagXi is built with the keyword `xi=`, which
    no such class takes: it raises TypeError."""

    def __init__(self, network: str = "ResNetV2",
                 map_type: str = "DBNormalCDF", gain: str = "mmse-lsa",
                 data_path: str = "./data", ver: str = "resnet-1.1c",
                 network_kwargs: tuple = (), inp_tgt_type: str = "MagXi", *,
                 device=None):
        self.model = DeepXi(network=network, network_kwargs=network_kwargs,
                            device=device)
        self.device = next(self.model.parameters()).device
        self.gain = gain
        self.data_path = data_path
        self.ver = ver
        self.xi_map = XiMap(map_type)
        if inp_tgt_type == "MagXi":
            self.inp_tgt = MagXi(self.xi_map)
        else:
            self.inp_tgt = inp_tgt_selector(inp_tgt_type, xi=self.xi_map)

    @classmethod
    def from_args(cls, args: DeepXiArgs, device=None) -> "DeepXiDriver":
        return cls(network=args.network_type, map_type=args.map_type,
                   gain=args.gain, data_path=args.data_path, ver=args.ver,
                   network_kwargs=args.network_kwargs(),
                   inp_tgt_type=args.inp_tgt_type, device=device)

    # ----------------------------------------------------------- statistics
    def stats_path(self) -> str:
        return os.path.join(self.data_path, f"{self.ver}_inp_tgt.p")

    def sample_stats(self, clean_wavs, noise_wavs, save: bool = True):
        """Fit the per-bin xi statistics from a training sample (ref
        model.py:462-520 sample()); `save` pickles {"mu", "sigma"} (numpy)
        to `stats_path()`, the file se_tpu's driver writes and reads."""
        compute_xi_stats(clean_wavs, noise_wavs, self.xi_map,
                         device=self.device)
        if save:
            os.makedirs(self.data_path, exist_ok=True)
            with open(self.stats_path(), "wb") as f:
                pickle.dump({"mu": self.xi_map.mu,
                             "sigma": self.xi_map.sigma}, f)

    def load_stats(self) -> bool:
        """Read `stats_path()` (this driver's or se_tpu's) into the map;
        False where it is absent."""
        if not os.path.isfile(self.stats_path()):
            return False
        with open(self.stats_path(), "rb") as f:
            d = pickle.load(f)
        self.xi_map.mu, self.xi_map.sigma = d["mu"], d["sigma"]
        return True

    # ------------------------------------------------------------- training
    def _batch(self, clean, noisy):
        """(s, x, frames) on the model's device; frames as se_tpu counts
        them, from each row's (padded) length."""
        s = torch.as_tensor(np.asarray(clean, np.float32)).to(self.device)
        x = torch.as_tensor(np.asarray(noisy, np.float32)).to(self.device)
        frames = torch.tensor([n_frames(len(c)) for c in clean],
                              device=self.device)
        return s, x, frames

    def train_step(self, s, x, frames, opt_state: dict, lr: float = 1e-3,
                   clip_value: float = 1.0) -> torch.Tensor:
        """One step of se_tpu's: the input/target's example (no gradient),
        the model, BCE over the frames t < frames; its gradients (left in
        `.grad`, before the clip); the clipped Adam update of the weights
        in place. Returns the loss, detached."""
        self.model.zero_grad(set_to_none=True)
        with torch.no_grad():
            obs, target = self.inp_tgt.example(s, x)
        t = obs.shape[1]
        mask = (torch.arange(t, device=obs.device)[None, :]
                < frames[:, None]).to(obs.dtype)
        loss = masked_bce(self.model(obs), target, mask)
        loss.backward()
        clipped_adam_step(self.model, opt_state, lr, clip_value)
        return loss.detach()

    def train(self, pairs, epochs: int = 1, lr: float = 1e-3,
              clip_value: float = 1.0, log_every: int = 10):
        """`pairs` yields (clean, noisy) float waveform batches (B, N) of
        one padded length; BCE with the frame mask (ref model.py:203-230).
        Adam's state starts afresh each call (se_tpu's second call has
        none and fails). Returns the (step, loss) pairs every `log_every`
        steps."""
        opt_state = adam_state(dict(self.model.named_parameters()))
        history = []
        i = 0
        for _ in range(epochs):
            for clean, noisy in pairs:
                loss = self.train_step(*self._batch(clean, noisy), opt_state,
                                       lr, clip_value)
                if i % log_every == 0:
                    history.append((i, float(loss)))
                i += 1
        return history

    # ------------------------------------------------- training self-checks
    @torch.no_grad()
    def eval_example(self, clean, noisy, frames, out_dir: str = ".") -> list:
        """Dump one minibatch of examples and check the mixing SNRs (ref
        model.py:182-201 `eval_example`): the observation, target and
        frame mask arrays to .mat files; returns each pair's SNR (dB) on
        d = x - s."""
        from scipy.io import savemat

        s, x, _ = self._batch(clean, noisy)
        obs, target = self.inp_tgt.example(s, x)
        t = obs.shape[1]
        mask = (np.arange(t)[None, :] < np.asarray(frames)[:, None]).astype(
            np.float32)
        os.makedirs(out_dir, exist_ok=True)
        savemat(os.path.join(out_dir, "inp_batch.mat"),
                {"inp_batch": obs.cpu().numpy()})
        savemat(os.path.join(out_dir, "tgt_batch.mat"),
                {"tgt_batch": target.cpu().numpy()})
        savemat(os.path.join(out_dir, "seq_mask_batch.mat"),
                {"seq_mask_batch": mask})
        s_np = np.asarray(clean, np.float32)
        d = np.asarray(noisy, np.float32) - s_np
        return [float(snr_db(s_np[i], d[i])) for i in range(len(s_np))]

    # ------------------------------------------------------------ inference
    def infer_dir(self, mix_dir: str, out_dir: str, fs: int = 16000):
        """Enhance every wav in mix_dir (ref model.py:232-340 infer())."""
        os.makedirs(out_dir, exist_ok=True)
        for fid in sorted(os.listdir(mix_dir)):
            if not fid.endswith(".wav"):
                continue
            wav, sr = read_wav(os.path.join(mix_dir, fid))
            if wav.ndim > 1:
                wav = wav[:, 0]
            wav = resample(wav, sr, fs)
            y = enhance(self.model, wav[None], self.xi_map, gain=self.gain,
                        length=len(wav))
            write_wav(os.path.join(out_dir, fid), y[0].cpu().numpy(), fs)

    # ----------------------------------------------------------------- test
    def test_dir(self, est_dir: str, ref_dir: str, csv_dir: str,
                 fs: int = 16000) -> dict:
        """Score the estimates and write per-utterance and average CSVs
        (ref model.py:342-460 test())."""
        rows = []
        for fid in sorted(os.listdir(est_dir)):
            if not fid.endswith(".wav"):
                continue
            est, sr_e = read_wav(os.path.join(est_dir, fid))
            ref, sr_r = read_wav(os.path.join(ref_dir, fid))
            est = resample(est, sr_e, fs).astype(np.float64)
            ref = resample(ref, sr_r, fs).astype(np.float64)
            n = min(len(est), len(ref))
            rows.append({
                "utt": fid,
                "stoi": metrics.stoi(est[:n], ref[:n], fs),
                "estoi": metrics.estoi(est[:n], ref[:n], fs),
                "si_sdr": metrics.si_sdr(est[:n], ref[:n]),
                "seg_snr": metrics.seg_snr(est[:n], ref[:n]),
            })
        os.makedirs(csv_dir, exist_ok=True)
        with open(os.path.join(csv_dir, f"{self.ver}.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        avg = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k != "utt"}
        with open(os.path.join(csv_dir, "average.csv"), "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["ver"] + list(avg.keys()))
            if f.tell() == 0:
                w.writeheader()
            w.writerow({"ver": self.ver, **avg})
        return avg
