"""se_tpu_torch's DeepXi against se_tpu's on the CPU.

JAX variables come from a numpy seed (`deepxi_variables`: every kernel,
bias and LSTM weight drawn, every LayerNorm scale and bias off its
default, MHANetV3's positions N(0, 0.02)) and reach the port through
`from_jax_variables`; the same inputs go through both.
- Each of the nine `DeepXi.network` names at small widths on a ragged
  batch (one utterance's tail zero-padded, which MHANet masks), ResNetV2
  with both unit types, MHANet causal and not, RDLNet with both unit
  types and both paddings; the port's state_dict back through
  `to_se_tpu_tree` (the inverse map, a test helper) to the tree it came
  from; one forward at the shipped width (40 blocks, d_model 256, T = 40).
- `polar_analysis` / `polar_synthesis` (every hop, the first and last
  included), `compute_xi_stats`, `enhance` end to end with both MMSE
  gains, and every input/target class's `example` and `enhanced_speech`.
Tolerance 1e-4 absolute and relative, the absolute one scaled to outputs
below 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.models import deepxi as jdeepxi
from se_tpu.models import deepxi_inp_tgt as jinp
from se_tpu_torch.models import deepxi, deepxi_inp_tgt, get_model
from se_tpu_torch.ops.stft import PRESET_DEEPXI
from torch_kernel_inputs import fill_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_close(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


# ------------------------------------------------------- shared helpers

def deepxi_variables(jmodel, x: np.ndarray, seed: int) -> dict:
    """se_tpu's variables of `jmodel` (a DeepXi) for input x, drawn by
    fill_tree from `seed`, MHANetV3's `pos_embedding` N(0, 0.02)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
    net = dict(shapes["params"]["net"])
    pos = net.pop("pos_embedding", None)
    variables = fill_tree({"params": {"net": net}}, seed)
    if pos is not None:
        variables["params"]["net"]["pos_embedding"] = (
            np.random.default_rng(seed + 1).normal(0, 0.02, pos.shape)
            .astype(np.float32))
    return variables


def port_model(network: str, n_feat: int, kwargs: tuple, variables: dict,
               dtype=torch.float32):
    model = deepxi.DeepXi(network, n_feat, kwargs, device="cpu")
    model.load_state_dict(deepxi.from_jax_variables(variables))
    return model.to(dtype)


def to_se_tpu_tree(sd: dict, like: dict, grads: bool = False) -> dict:
    """The port's state_dict (or its gradients, `grads`) -> se_tpu's
    {"params": {"net": ...}} tree shaped as `like`: the inverse of
    `from_jax_variables`. The LSTM's combined bias is bias_ih + bias_hh,
    its gradient that of either."""
    def arr(key):
        return np.asarray(sd[key].detach().cpu().double().numpy())

    out = {}
    for name, node in like["params"]["net"].items():
        p = f"net.{name}"
        if not isinstance(node, dict):
            out[name] = arr(p)
        elif "kernel" in node:
            k = arr(f"{p}.weight").transpose(2, 1, 0)
            out[name] = {"kernel": k[0] if np.ndim(node["kernel"]) == 2
                         else k}
            if "bias" in node:
                out[name]["bias"] = arr(f"{p}.bias")
        elif any(key.endswith("_wx") for key in node):
            b = arr(f"{p}.bias_ih_l0")
            out[name] = {"l0_wx": arr(f"{p}.weight_ih_l0").T,
                         "l0_wh": arr(f"{p}.weight_hh_l0").T,
                         "l0_b": b if grads else b + arr(f"{p}.bias_hh_l0")}
        else:
            out[name] = {key: arr(f"{p}.{'weight' if key == 'scale' else key}")
                         for key in node}
    return {"params": {"net": out}}


def _feats(b, t, f, seed, pad_from=None):
    x = np.abs(np.random.default_rng(seed).standard_normal((b, t, f))
               ).astype(np.float32)
    if pad_from is not None:
        x[0, pad_from:] = 0.0  # one utterance zero-padded
    return x


# --------------------------------------------------------------- networks

NETWORKS = [
    ("ResNet", (("d_model", 32), ("n_blocks", 3), ("d_f", 8),
                ("max_d_rate", 4))),
    ("ResNetV2", (("d_model", 32), ("n_blocks", 3), ("d_f", 8),
                  ("max_d_rate", 4))),
    ("ResNetV2", (("d_model", 32), ("n_blocks", 3), ("d_f", 8),
                  ("max_d_rate", 4), ("unit_type", "LN->ReLU->W+b"))),
    ("ResNetV3", (("d_model", 32), ("n_blocks", 3), ("d_f", 8),
                  ("max_d_rate", 4))),
    ("MHANet", (("d_model", 32), ("n_blocks", 2), ("n_heads", 4))),
    ("MHANet", (("d_model", 32), ("n_blocks", 2), ("n_heads", 4),
                ("causal", False))),
    ("MHANetV2", (("d_model", 32), ("n_blocks", 2), ("n_heads", 4))),
    ("MHANetV2", (("d_model", 32), ("n_blocks", 2), ("n_heads", 4),
                  ("causal", False))),
    ("MHANetV3", (("d_model", 32), ("n_blocks", 2), ("n_heads", 4),
                  ("max_len", 64))),
    ("ResLSTM", (("d_model", 32), ("n_blocks", 2))),
    ("ResBiLSTM", (("d_model", 32), ("n_blocks", 2))),
    ("RDLNet", (("n_blocks", 2), ("length", 5), ("m_1", 16))),
    ("RDLNet", (("n_blocks", 2), ("length", 7), ("m_1", 16),
                ("unit_type", "scale*LN+center->ReLU->W+b"))),
    ("RDLNet", (("n_blocks", 2), ("length", 5), ("m_1", 16),
                ("padding", "same"))),
    ("RDLNet", (("n_blocks", 1), ("length", 7), ("m_1", 16),
                ("padding", "same"),
                ("unit_type", "scale*LN+center->ReLU->W+b"))),
]


def _net_id(case):
    name, kw = case
    extra = [f"{k}={v}" for k, v in kw if k in ("unit_type", "causal",
                                                "padding", "length")]
    return "-".join([name] + extra)


@pytest.mark.parametrize("network,kwargs", NETWORKS,
                         ids=[_net_id(c) for c in NETWORKS])
def test_network_matches_se_tpu(network, kwargs):
    """Every network on B = 2, T = 20, F = 33, utterance 0 zero from frame
    14; the state_dict maps back to se_tpu's tree."""
    x = _feats(2, 20, 33, seed=1, pad_from=14)
    jmodel = jdeepxi.DeepXi(network=network, n_feat=33,
                            network_kwargs=kwargs)
    variables = deepxi_variables(jmodel, x, seed=len(network))
    want = np.asarray(jmodel.apply(variables, x))
    model = port_model(network, 33, kwargs, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 20, 33)
    assert_close(got, want)
    back = to_se_tpu_tree(model.state_dict(), variables)
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(variables))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[path].astype(np.float32),
                                      leaf, err_msg=str(path))


@pytest.mark.parametrize("v2", [False, True])
def test_mhanet_padded_tail_leaves_valid_frames(v2):
    """Masking(0.0): a zero tail added to an utterance leaves its valid
    frames' outputs as they were, in the port as in se_tpu."""
    kwargs = (("d_model", 32), ("n_blocks", 2), ("n_heads", 4))
    name = "MHANetV2" if v2 else "MHANet"
    x = _feats(2, 15, 17, seed=2)
    x_pad = np.concatenate([x, np.zeros((2, 6, 17), np.float32)], axis=1)
    jmodel = jdeepxi.DeepXi(network=name, n_feat=17, network_kwargs=kwargs)
    model = port_model(name, 17, kwargs, deepxi_variables(jmodel, x, 9))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
        out_pad = model(torch.from_numpy(x_pad)).numpy()
    np.testing.assert_allclose(out_pad[:, :15], out, rtol=2e-5, atol=1e-6)


def test_resnetv2_at_the_shipped_width():
    """40 blocks, d_model 256, d_f 64, k 3, dilation to 16 (about 1.95 M
    parameters, as se_tpu's), on T = 40 frames of 257 bins."""
    x = _feats(1, 40, 257, seed=3)
    jmodel = jdeepxi.DeepXi()
    variables = deepxi_variables(jmodel, x, seed=4)
    model = port_model("ResNetV2", 257, (), variables)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(np.size(a) for a in jax.tree.leaves(variables))
    assert abs(n_params - 1.95e6) / 1.95e6 < 0.02
    want = np.asarray(jmodel.apply(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert_close(got, want)


def test_unknown_network_and_unit_type_raise():
    with pytest.raises(ValueError, match="network"):
        deepxi.DeepXi("NoSuchNet", device="cpu")
    with pytest.raises(ValueError, match="unit_type"):
        deepxi.DeepXi("ResNetV2", network_kwargs=(("unit_type", "x"),),
                      device="cpu")
    with pytest.raises(ValueError, match="outp_act"):
        deepxi.DeepXi("ResLSTM", 8, (("d_model", 8), ("n_blocks", 1),
                                     ("outp_act", "x")),
                      device="cpu")(torch.ones(1, 3, 8))


# -------------------------------------------------------- signal and glue

def _wavs(n=8192, seed=0):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    d = (rng.standard_normal((2, n)) * np.array([[0.05], [0.2]])
         ).astype(np.float32)
    return s, d


def test_polar_analysis_and_synthesis_match_se_tpu():
    """pad_end hamming 512/256: the magnitude, the phase (where the
    magnitude is not near 0), and the synthesis on every sample, the first
    and last hop included, where only one frame covers the signal and the
    periodized inverse window does not restore it (in either package)."""
    s, _ = _wavs(5000)
    jm, jp = jdeepxi.polar_analysis(jnp.asarray(s))
    pm, pp = deepxi.polar_analysis(torch.from_numpy(s))
    assert pm.shape == jm.shape == (2, 20, 257)
    assert_close(pm.numpy(), jm)
    ok = np.asarray(jm) > 1e-3 * float(np.abs(jm).max())
    assert_close(pp.numpy()[ok], np.asarray(jp)[ok])
    want = np.asarray(jdeepxi.polar_synthesis(jm, jp, length=5000))
    got = deepxi.polar_synthesis(pm, pp, length=5000).numpy()
    assert_close(got, want)
    hop = PRESET_DEEPXI.hop
    np.testing.assert_allclose(got[:, hop:-2 * hop], s[:, hop:-2 * hop],
                               atol=1e-5)
    assert np.abs(got[:, :hop // 2] - s[:, :hop // 2]).max() > 1e-3


def _fitted_maps(s, d):
    """(se_tpu's map, the port's), each fitted by its own
    compute_xi_stats on the same waveforms."""
    jmap, pmap = jdeepxi.XiMap("DBNormalCDF"), deepxi.XiMap("DBNormalCDF")
    jdeepxi.compute_xi_stats(list(s), list(d), jmap)
    deepxi.compute_xi_stats(list(s), list(d), pmap, device="cpu")
    return jmap, pmap


def test_compute_xi_stats_matches_se_tpu():
    s, d = _wavs()
    jmap, pmap = _fitted_maps(s, d)
    assert pmap.mu.shape == (257,) and pmap.mu.dtype == np.float32
    np.testing.assert_allclose(pmap.mu, jmap.mu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pmap.sigma, jmap.sigma, rtol=1e-4)


@pytest.mark.parametrize("gain", ["mmse-lsa", "mmse-stsa"])
def test_enhance_matches_se_tpu(gain):
    """The waveform pipeline at a narrow ResNetV2: STMS, network, the
    inverse map, the gain, the noisy phase, the inverse STFT."""
    s, d = _wavs()
    jmap, pmap = _fitted_maps(s, d)
    kwargs = (("d_model", 32), ("n_blocks", 4), ("d_f", 16))
    jmodel = jdeepxi.DeepXi(network_kwargs=kwargs)
    x = s + d
    stms, _ = jdeepxi.polar_analysis(jnp.asarray(x))
    variables = deepxi_variables(jmodel, np.asarray(stms), seed=6)
    want = np.asarray(jdeepxi.enhance(variables, jmodel, jnp.asarray(x),
                                      jmap, gain=gain, length=8192))
    model = port_model("ResNetV2", 257, kwargs, variables)
    got = deepxi.enhance(model, x, pmap, gain=gain, length=8192)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 8192)
    assert np.isfinite(got.numpy()).all()
    assert_close(got.numpy(), want)


def _family_maps():
    """se_tpu's and the port's maps with the same statistics."""
    s, d = _wavs(seed=7)
    jfit, pfit = _fitted_maps(s, d)
    pfit.mu, pfit.sigma = jfit.mu, jfit.sigma
    lin = (jdeepxi.XiMap("Linear"), deepxi.XiMap("Linear"))
    return {
        "MagXi": dict(xi_map=(jfit, pfit)),
        "MagGamma": dict(gamma_map=lin),
        "MagXiGamma": dict(xi_map=(jfit, pfit), gamma_map=lin),
        "MagGain": dict(gain=("mmse-lsa", "mmse-lsa")),
        "MagMag": dict(mag_map=lin),
        "MagSMM": {},
        "MagPhaXiPha": dict(xi_map=(jfit, pfit), s_stps_map=lin),
        "STDCTXiCD": dict(xi_map=lin, cd_map=lin),
    }


def _conditioned(kind: str, s: np.ndarray, d: np.ndarray,
                 shape) -> np.ndarray:
    """Where a target is well conditioned: the SNR targets divide by the
    noise's |D|^2 (its STMS, or its STDCT for STDCTXiCD), MagPhaXiPha's
    phase target is the angle of S; where |D| or |S| is near 0 the two
    packages' STFT round-off (~1e-7 of the spectrum) moves the ratio by
    percents and the angle by up to 2 pi. True where that magnitude is at
    least 1e-2 of its frame's largest for those target columns (a Linear
    map keeps the error; the fitted dB CDF of xi does not need it),
    everywhere else."""
    def good(w):
        if kind == "STDCTXiCD":
            mag = np.abs(np.asarray(jstdct_analysis(w)))
        else:
            mag = np.asarray(jdeepxi.polar_analysis(jnp.asarray(w))[0])
        return mag >= 1e-2 * mag.max(axis=-1, keepdims=True)

    cols = {"MagGamma": ("d",), "MagXiGamma": (None, "d"),
            "MagPhaXiPha": (None, "s"), "STDCTXiCD": ("d", None)}
    parts = [np.ones(shape[:-1] + (shape[-1] // len(c),), bool)
             if w is None else good(s if w == "s" else d)
             for c in [cols.get(kind, (None,))] for w in c]
    ok = np.concatenate(parts, axis=-1)
    assert ok.shape == shape
    return ok


def jstdct_analysis(x):
    return jinp.STDCTXiCD(None, None)._analysis(jnp.asarray(x))


@pytest.mark.parametrize("kind", ["MagXi", "MagGamma", "MagXiGamma",
                                  "MagGain", "MagMag", "MagSMM",
                                  "MagPhaXiPha", "STDCTXiCD"])
def test_inp_tgt_matches_se_tpu(kind):
    """`example` (observation and target; the target where it is well
    conditioned, `_conditioned`) and `enhanced_speech` from se_tpu's
    target (clipped into (0.01, 0.99) where it is a CDF or a gain) on the
    same waveforms."""
    maps = _family_maps()[kind]
    jit = jinp.inp_tgt_selector(kind, **{k: v[0] for k, v in maps.items()})
    pit = deepxi_inp_tgt.inp_tgt_selector(kind, **{k: v[1] for k, v in
                                                   maps.items()})
    assert (pit.n_feat, pit.n_outp) == (jit.n_feat, jit.n_outp)
    s, d = _wavs(6000, seed=8)
    x = s + d
    jobs, jtgt = jit.example(jnp.asarray(s), jnp.asarray(x))
    pobs, ptgt = pit.example(torch.from_numpy(s), torch.from_numpy(x))
    assert_close(pobs.numpy(), jobs)
    ok = _conditioned(kind, s, d, np.asarray(jtgt).shape)
    assert ok.mean() > 0.9
    assert_close(ptgt.numpy()[ok], np.asarray(jtgt)[ok])
    jfeat, pfeat = jit.observation(jnp.asarray(x)), \
        pit.observation(torch.from_numpy(x))
    assert_close(pfeat[0].numpy(), jfeat[0])
    pred = np.array(jtgt)
    if kind in ("MagXi", "MagGamma", "MagXiGamma", "MagGain"):
        pred = np.clip(pred, 0.01, 0.99)
    aux = (jfeat[1], None if pfeat[1] is None else pfeat[1])
    want = np.asarray(jit.enhanced_speech(jfeat[0], aux[0],
                                          jnp.asarray(pred), "mmse-lsa",
                                          length=6000))
    got = pit.enhanced_speech(pfeat[0], aux[1], torch.from_numpy(pred),
                              "mmse-lsa", length=6000).numpy()
    assert got.shape == want.shape == (2, 6000)
    assert np.isfinite(got).all()
    assert_close(got, want)


def test_inp_tgt_helpers():
    assert deepxi_inp_tgt.n_frames(64000) == 250
    assert deepxi_inp_tgt.n_frames(64001) == jinp.n_frames(64001) == 251
    ints = np.array([-32768, 0, 16384], np.int16)
    np.testing.assert_array_equal(deepxi_inp_tgt.normalise_int(ints).numpy(),
                                  np.asarray(jinp.normalise_int(ints)))
    s, x = torch.ones(3), torch.full((3,), 3.0)
    assert deepxi_inp_tgt.mix(s, x)[1].tolist() == [2.0, 2.0, 2.0]
    with pytest.raises(ValueError, match="inp_tgt"):
        deepxi_inp_tgt.inp_tgt_selector("NoSuchType")


# --------------------------------------------------------------- registry

def test_registry_entry():
    entry = get_model("deepxi")
    assert entry.make is deepxi.DeepXi and entry.io_kind == "hybrid"
    assert entry.stft == PRESET_DEEPXI
    assert (entry.stft.win_length, entry.stft.hop, entry.stft.window,
            entry.stft.convention) == (512, 256, "hamming", "pad_end")
    assert entry.variants == ("resnet", "reslstm")
    assert entry.from_jax_variables is deepxi.from_jax_variables


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("deepxi").make()
    s, d = _wavs(2048)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepxi.compute_xi_stats(list(s), list(d), deepxi.XiMap("DB"))
