"""se_tpu_torch's DeepXi driver against se_tpu's on the CPU: one train step
(the loss and every gradient against what se_tpu's `DeepXiDriver.train`
computes, then the updated weights and the next step's loss), the
statistics pickle read across the two packages, `infer_dir` and
`test_dir` on a directory of synthetic wavs, `eval_example`, the flag
surface, and `Prelim` converging.

se_tpu's train step is run as it is, with its jax module seen through a
recorder (`_Recorder`): its `jax.jit` runs the step eagerly and hands
`model.init` the test's variables, and its `jax.value_and_grad` keeps the
(loss, gradients) it returns. Tolerances: the loss within 1e-5 relative,
every gradient within 1e-5 of the step's largest |gradient| entry (as the
other families' train steps), the weights after the step within 1e-6
where the gradient is at least 1e-3 of the largest (Adam's first update
is lr sign(g), which round-off may flip where |g| is near 0); the
enhanced wavs 1e-4 absolute and relative, the absolute one scaled to
outputs below 1, plus one 16-bit step of the wav files.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.data.wav import write_wav
from se_tpu.models import deepxi_driver as jdriver
from se_tpu_torch.models import deepxi, deepxi_driver
from test_torch_deepxi import deepxi_variables, to_se_tpu_tree

N = 8192
KWARGS = {
    "ResNetV2": (("d_model", 32), ("n_blocks", 3), ("d_f", 16)),
    "ResLSTM": (("d_model", 32), ("n_blocks", 2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(seed=0):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((2, N)) * 0.1).astype(np.float32)
    noise = (rng.standard_normal((2, N)) * np.array([[0.05], [0.2]])
             ).astype(np.float32)
    return clean, noise


def _drivers(tmp_path, network="ResNetV2"):
    """se_tpu's driver and the port's (CPU) with the same statistics (the
    port's read from se_tpu's pickle) and the same weights (se_tpu's
    variables by seed, carried in by from_jax_variables)."""
    kw = KWARGS[network]
    clean, noise = _pairs()
    jdrv = jdriver.DeepXiDriver(network=network, network_kwargs=kw,
                                data_path=str(tmp_path / "data"), ver="t")
    jdrv.sample_stats(list(clean), list(noise))
    pdrv = deepxi_driver.DeepXiDriver(network=network, network_kwargs=kw,
                                      data_path=str(tmp_path / "data"),
                                      ver="t", device="cpu")
    assert pdrv.load_stats()
    stms, _ = deepxi.polar_analysis(torch.from_numpy(clean))
    variables = deepxi_variables(jdrv.model, stms.numpy(), seed=11)
    pdrv.model.load_state_dict(deepxi.from_jax_variables(variables))
    return jdrv, pdrv, variables


class _Recorder:
    """se_tpu's driver's view of jax: `jit` runs a function as it is (and
    `model.init` returns `variables`), `value_and_grad` keeps its
    results."""

    def __init__(self, variables):
        self.variables = jax.tree.map(jnp.asarray, variables)
        self.results = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        if getattr(fn, "__name__", "") == "init":
            return lambda *a, **k: self.variables
        return fn

    def value_and_grad(self, fn):
        def run(params):
            out = jax.value_and_grad(fn)(params)
            self.results.append(out)
            return out
        return run


@pytest.mark.parametrize("network", ["ResNetV2", "ResLSTM"])
def test_train_step_matches_se_tpu(monkeypatch, tmp_path, network):
    """Two steps on one batch, each driver from the same weights: step 0's
    loss and gradients, the weights after it, step 1's loss (1e-4)."""
    jdrv, pdrv, variables = _drivers(tmp_path, network)
    clean, noise = _pairs(1)
    batch = [(clean, clean + noise)]
    rec = _Recorder(variables)
    monkeypatch.setattr(jdriver, "jax", rec)
    jhist = jdrv.train(batch * 2, log_every=1)
    (jloss, jgrads), _ = rec.results

    # the port's first step alone, to read its gradients and weights
    first = deepxi_driver.DeepXiDriver(network=network,
                                       network_kwargs=KWARGS[network],
                                       device="cpu")
    first.xi_map.mu, first.xi_map.sigma = pdrv.xi_map.mu, pdrv.xi_map.sigma
    first.model.load_state_dict(pdrv.model.state_dict())
    hist = first.train(batch, log_every=1)
    np.testing.assert_allclose(hist[0][1], float(jloss), rtol=1e-5)
    grads = to_se_tpu_tree({k: p.grad for k, p in
                            first.model.named_parameters()},
                           variables, grads=True)
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    want = dict(jax.tree_util.tree_leaves_with_path({"params": jgrads}))
    assert got.keys() == want.keys()
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for path, g in want.items():
        np.testing.assert_allclose(got[path], np.asarray(g), rtol=0,
                                   atol=1e-5 * gmax, err_msg=str(path))

    after = dict(jax.tree_util.tree_leaves_with_path(
        to_se_tpu_tree(first.model.state_dict(), variables)))
    # se_tpu's weights after its first step: optax's clip and Adam, as
    # its driver chains them, on the recorded gradients
    import optax

    tx = optax.chain(optax.clip(1.0), optax.adam(1e-3))
    params = jax.tree.map(jnp.asarray, variables["params"])
    updates, _ = tx.update(jgrads, tx.init(params), params)
    stepped = dict(jax.tree_util.tree_leaves_with_path(
        {"params": optax.apply_updates(params, updates)}))
    for path, w in stepped.items():
        g = np.abs(np.asarray(want[path]))
        firm = g >= 1e-3 * gmax
        np.testing.assert_allclose(after[path][firm], np.asarray(w)[firm],
                                   rtol=0, atol=1e-6, err_msg=str(path))

    hist2 = pdrv.train(batch * 2, log_every=1)
    assert [i for i, _ in hist2] == [i for i, _ in jhist] == [0, 1]
    np.testing.assert_allclose(hist2[0][1], jhist[0][1], rtol=1e-5)
    np.testing.assert_allclose(hist2[1][1], jhist[1][1], rtol=1e-4)


def test_stats_pickle_reads_across_packages(tmp_path):
    """The port reads se_tpu's {"mu", "sigma"} pickle and se_tpu the
    port's; the port's own fit agrees with se_tpu's to 1e-4."""
    clean, noise = _pairs()
    pdrv = deepxi_driver.DeepXiDriver(data_path=str(tmp_path / "p"),
                                      ver="v", device="cpu")
    assert not pdrv.load_stats()
    pdrv.sample_stats(list(clean), list(noise))
    jdrv = jdriver.DeepXiDriver(data_path=str(tmp_path / "p"), ver="v")
    assert jdrv.load_stats()
    np.testing.assert_array_equal(jdrv.xi_map.mu, pdrv.xi_map.mu)
    np.testing.assert_array_equal(jdrv.xi_map.sigma, pdrv.xi_map.sigma)

    jdrv2 = jdriver.DeepXiDriver(data_path=str(tmp_path / "j"), ver="v")
    jdrv2.sample_stats(list(clean), list(noise))
    pdrv2 = deepxi_driver.DeepXiDriver(data_path=str(tmp_path / "j"),
                                       ver="v", device="cpu")
    assert pdrv2.load_stats()
    np.testing.assert_array_equal(pdrv2.xi_map.mu, jdrv2.xi_map.mu)
    np.testing.assert_allclose(pdrv.xi_map.mu, jdrv2.xi_map.mu, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pdrv.xi_map.sigma, jdrv2.xi_map.sigma,
                               rtol=1e-4)


def test_infer_and_test_dirs_match_se_tpu(tmp_path):
    """`infer_dir` on two wavs (one at 8 kHz, resampled), then `test_dir`:
    the same enhanced files and the same scores, per utterance and
    averaged."""
    from se_tpu_torch.data.wav import read_wav

    jdrv, pdrv, variables = _drivers(tmp_path)
    jdrv.variables = variables
    clean, noise = _pairs(2)
    mix, ref = tmp_path / "mix", tmp_path / "ref"
    mix.mkdir()
    ref.mkdir()
    for i in range(2):
        write_wav(str(mix / f"u{i}.wav"), clean[i] + noise[i], 16000)
        write_wav(str(ref / f"u{i}.wav"), clean[i], 16000)
    write_wav(str(mix / "u2.wav"), (clean[0] + noise[0])[::2], 8000)
    write_wav(str(ref / "u2.wav"), clean[0][::2], 8000)
    (mix / "notes.txt").write_text("not a wav")
    jdrv.infer_dir(str(mix), str(tmp_path / "jout"))
    pdrv.infer_dir(str(mix), str(tmp_path / "pout"))
    assert sorted(os.listdir(tmp_path / "pout")) == ["u0.wav", "u1.wav",
                                                     "u2.wav"]
    for fid in ("u0.wav", "u1.wav", "u2.wav"):
        got, sr = read_wav(str(tmp_path / "pout" / fid))
        want, _ = read_wav(str(tmp_path / "jout" / fid))
        assert sr == 16000 and got.shape == want.shape
        scale = min(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * scale + 2.0 ** -15)
    javg = jdrv.test_dir(str(tmp_path / "jout"), str(ref),
                         str(tmp_path / "jcsv"))
    avg = pdrv.test_dir(str(tmp_path / "pout"), str(ref),
                        str(tmp_path / "pcsv"))
    assert avg.keys() == javg.keys() == {"stoi", "estoi", "si_sdr",
                                         "seg_snr"}
    for key, val in javg.items():
        np.testing.assert_allclose(avg[key], val, rtol=1e-3, atol=1e-3)
    with open(tmp_path / "pcsv" / "t.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["utt"] for r in rows] == ["u0.wav", "u1.wav", "u2.wav"]
    with open(tmp_path / "pcsv" / "average.csv") as f:
        assert list(csv.DictReader(f))[0]["ver"] == "t"


def test_eval_example_matches_se_tpu(tmp_path):
    """The dumped observation, target and mask, and each pair's SNR."""
    from scipy.io import loadmat

    jdrv, pdrv, _ = _drivers(tmp_path)
    clean, noise = _pairs(3)
    for i, snr in enumerate([0.0, 5.0]):  # exact mixing SNRs
        noise[i] *= np.sqrt(np.mean(clean[i] ** 2) / (
            np.mean(noise[i] ** 2) * 10 ** (snr / 10)))
    frames = [deepxi_driver.n_frames(N), deepxi_driver.n_frames(N) - 5]
    jsnr = jdrv.eval_example(clean, clean + noise, frames,
                             out_dir=str(tmp_path / "j"))
    snr = pdrv.eval_example(clean, clean + noise, frames,
                            out_dir=str(tmp_path / "p"))
    np.testing.assert_allclose(snr, [0.0, 5.0], atol=1e-3)
    np.testing.assert_allclose(snr, jsnr, atol=1e-5)
    for name in ("inp_batch", "tgt_batch", "seq_mask_batch"):
        got = loadmat(str(tmp_path / "p" / f"{name}.mat"))[name]
        want = loadmat(str(tmp_path / "j" / f"{name}.mat"))[name]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert deepxi_driver.snr_db(clean[0], noise[0]) == pytest.approx(
        jdriver.snr_db(clean[0], noise[0]))


def test_args_surface_matches_se_tpu():
    """The flags thread through to the network as se_tpu's: the same
    parameter count; another input/target raises as se_tpu's does."""
    for args in (jdriver.DeepXiArgs(network_type="ResNetV2", d_model=32,
                                    n_blocks=2, d_f=8, max_d_rate=2),
                 jdriver.DeepXiArgs(network_type="MHANet", d_model=32,
                                    n_blocks=1, causal=False),
                 jdriver.DeepXiArgs(network_type="ResLSTM", d_model=16,
                                    n_blocks=1)):
        pargs = deepxi_driver.DeepXiArgs(**vars(args))
        assert pargs.network_kwargs() == args.network_kwargs()
        drv = deepxi_driver.DeepXiDriver.from_args(pargs, device="cpu")
        jdrv = jdriver.DeepXiDriver.from_args(args)
        x = jnp.zeros((1, 10, 257), jnp.float32)
        n_want = sum(np.size(a) for a in jax.tree.leaves(
            jax.eval_shape(jdrv.model.init, jax.random.PRNGKey(0), x)))
        assert sum(p.numel() for p in drv.model.parameters()) == n_want
        with torch.no_grad():
            assert drv.model(torch.zeros(1, 10, 257)).shape == (1, 10, 257)
    with pytest.raises(TypeError):
        jdriver.DeepXiDriver(inp_tgt_type="MagGamma")
    with pytest.raises(TypeError):
        deepxi_driver.DeepXiDriver(inp_tgt_type="MagGamma", device="cpu")


def test_prelim_converges():
    """The toy trainer (ref prelim.py) fits its 5-value frame target with a
    small ResNet to 0.15, as se_tpu's test asks of se_tpu's, in 40 steps
    where se_tpu's takes 20: the port draws torch's init (uniform, biases
    included, +-1/sqrt(fan_in)), which starts further from this target
    than flax's (lecun-normal kernels, zero biases); after 20 steps one of
    the five is 0.21 away."""
    prelim = deepxi_driver.Prelim(n_feat=8, network="ResNet", n_blocks=4,
                                  d_model=32, d_f=16, device="cpu")
    target, pred = prelim.train(mbatch_size=8, max_epochs=20, batch_size=16,
                                max_seq_len=24, min_seq_len=16)
    assert pred.shape == (8,)
    np.testing.assert_allclose(pred[:5], target[:5], atol=0.15)
    with pytest.raises(ValueError):
        deepxi_driver.Prelim(n_feat=3)
    with pytest.raises(ValueError):
        deepxi_driver.Prelim(n_feat=8, network="MHANet")


def test_driver_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepxi_driver.DeepXiDriver()
    with pytest.raises(RuntimeError, match="CUDA"):
        deepxi_driver.Prelim(n_feat=8, n_blocks=1, d_model=8,
                             d_f=4).train(max_epochs=1, batch_size=8)
