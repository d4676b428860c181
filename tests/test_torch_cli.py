"""se_tpu_torch's command line and its copies of se_tpu's numpy-only
modules, against se_tpu, on the CPU.

- The parser: every subcommand with se_tpu's options, defaults, choices
  and required flags, plus `--device` on enhance, stream and train.
- `enhance` from a port checkpoint of se_tpu's variables against se_tpu's
  `enhance_waveform` on those variables, in the vb and wsj layouts; both
  `stream` modes against the port's streamers called directly; `score`'s
  CSV and average.csv against se_tpu's CLI on the same directories, to
  1e-6 relative; `train` writes the checkpoints, the pointer and the loss
  curve that `enhance` restores; `train --data-parallel --device cpu`
  (one gloo rank) writes the plain `train`'s checkpoint, and so does
  chip_smoke.py's `CLI_DETERMINISTIC` launcher of `main`; without
  `--device` on a box without CUDA the command raises. A written wav holds 16-bit
  samples: outputs are compared within 1e-4 * max + one 16-bit step.
- The copies: PESQ, the composite measures and HASQI / HASPI equal
  se_tpu's; every preset equals se_tpu's and builds the port's model;
  `num_params` equals se_tpu's count for every family; `flops_estimate`
  of LSTMNet falls in se_tpu's band at 2 FLOPs a multiply-add; `trace`
  writes a Chrome trace with the port's spans on the profiler's clock.
"""

import argparse
import csv
import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import se_tpu.models as jmodels
from se_tpu import cli as jcli
from se_tpu.eval import composite as jcomposite
from se_tpu.eval import hasqi as jhasqi
from se_tpu.eval import pesq as jpesq
from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.utils import config as jconfig
from se_tpu.utils import profiling as jprofiling
from se_tpu_torch import cli
from se_tpu_torch.data import read_wav, write_wav
from se_tpu_torch.eval import composite, hasqi, pesq
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.eval.streaming import LstmStreamer, enhance_windowed
from se_tpu_torch.models import available_models, get_model
from se_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from se_tpu_torch.train.trainer import TrainConfig, make_train_step
from se_tpu_torch.utils import config, profiling
from torch_kernel_inputs import fill_tree

SR = 16000
STEP16 = 1.0 / 32768  # one 16-bit step of a written wav


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's intra-op threads would only contend with the other test
    workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus(root, n_utts=2, n=SR, seed=0):
    """noisy/ and clean/ wavs u{i}.wav and files.json, as the verify
    recipe makes them; returns the ids."""
    rng = np.random.default_rng(seed)
    for d in ("noisy", "clean"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ids = []
    for i in range(n_utts):
        c = (rng.standard_normal(n) * 0.1).astype(np.float32)
        d = (rng.standard_normal(n) * 0.03).astype(np.float32)
        write_wav(os.path.join(root, "clean", f"u{i}.wav"), c, SR)
        write_wav(os.path.join(root, "noisy", f"u{i}.wav"), c + d, SR)
        ids.append(f"u{i}")
    with open(os.path.join(root, "files.json"), "w") as f:
        json.dump(ids, f)
    return ids


def _close_16bit(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + STEP16)


# --------------------------------------------------------------------- parser

class _Parsed(Exception):
    pass


def _se_tpu_subparsers(monkeypatch) -> dict:
    """se_tpu's subparsers by name: its `main` builds the parser inside,
    so parse_args is stopped there and hands the parser over."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as got:
        jcli.main(["score"])
    monkeypatch.undo()
    return _subparsers(got.value.args[0])


def _subparsers(parser) -> dict:
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return dict(action.choices)


def _options(sub) -> dict:
    return {a.option_strings[0]: (tuple(a.option_strings), a.dest,
                                  a.default, a.choices, a.required,
                                  a.nargs, a.type)
            for a in sub._actions if a.option_strings and a.dest != "help"}


def test_parser_surface_matches_se_tpu(monkeypatch):
    want = _se_tpu_subparsers(monkeypatch)
    got = _subparsers(cli.build_parser())
    assert list(got) == list(want) == ["enhance", "stream", "score", "train"]
    for name, sub in got.items():
        mine = _options(sub)
        device = mine.pop("--device", None)
        assert mine == _options(want[name]), name
        assert (device is None) == (name == "score"), name
        if device is not None:
            assert device[2] is None  # the card by default


def test_help_lists_the_same_options(capsys):
    """Each subcommand's -h names se_tpu's option strings, and --device."""
    for name in ("enhance", "stream", "score", "train"):
        texts = []
        for main in (jcli.main, cli.main):
            with pytest.raises(SystemExit):
                main([name, "-h"])
            texts.append(capsys.readouterr().out)
        theirs, mine = (set(re.findall(r"--[a-z][a-z-]*", t)) for t in texts)
        assert mine - theirs == ({"--device"} if name != "score" else set())
        assert theirs <= mine


# -------------------------------------------------------------------- enhance

def _jax_variables(name: str, seed: int) -> dict:
    model = jmodels.get_model(name).make()
    x = np.zeros((1, 16, get_model(name).stft.bins, 2), np.float32)
    return fill_tree(jax.eval_shape(model.init, jax.random.PRNGKey(0), x),
                     seed)


def _port_checkpoint(name: str, variables: dict, ckpt: str) -> None:
    """se_tpu's variables as the port's checkpoint (step 0)."""
    model, init_fn, _, _ = make_train_step(TrainConfig(model=name),
                                           device="cpu")
    state = init_fn(0)
    model.load_state_dict(get_model(name).from_jax_variables(variables))
    save_checkpoint(ckpt, state, 0, 0)


@pytest.mark.parametrize("dataset", ["vb", "wsj"])
def test_enhance_matches_se_tpu(tmp_path, dataset):
    name = "dpcrn"
    variables = _jax_variables(name, 1)
    ckpt = str(tmp_path / "CP")
    _port_checkpoint(name, variables, ckpt)
    _corpus(str(tmp_path))
    if dataset == "vb":
        rels = [""]
        mix = str(tmp_path / "noisy")
        extra = []
    else:  # mix/{noise}/{seen|unseen}/{snr}/
        rels = [os.path.join("babble", "unseen", snr) for snr in ("0", "5")]
        mix = str(tmp_path / "mix")
        for rel in rels:
            os.makedirs(os.path.join(mix, rel))
            for fid in ("u0.wav", "u1.wav"):
                os.link(str(tmp_path / "noisy" / fid),
                        os.path.join(mix, rel, fid))
        extra = ["--dataset", "wsj", "--snrs", "0", "5"]
    out = tmp_path / "est"
    cli.main(["enhance", "--model", name, "--checkpoint", ckpt,
              "--mix-dir", mix, "--out-dir", str(out), "--device", "cpu"]
             + extra)
    jmodel = jmodels.get_model(name).make()
    for rel in rels:
        assert sorted(os.listdir(out / rel)) == ["u0.wav", "u1.wav"]
        for fid in ("u0.wav", "u1.wav"):
            wav, _ = read_wav(os.path.join(mix, rel, fid))
            got, sr = read_wav(str(out / rel / fid))
            assert sr == SR
            _close_16bit(got, j_enhance_waveform(name, variables, wav,
                                                  model=jmodel))


def test_enhance_without_checkpoint_warns_and_uses_seed_0(tmp_path, capsys):
    _corpus(str(tmp_path), n_utts=1, n=4000)
    cli.main(["enhance", "--model", "gcrn", "--mix-dir",
              str(tmp_path / "noisy"), "--out-dir", str(tmp_path / "est"),
              "--device", "cpu"])
    assert "no --checkpoint" in capsys.readouterr().err
    wav, _ = read_wav(str(tmp_path / "noisy" / "u0.wav"))
    got, _ = read_wav(str(tmp_path / "est" / "u0.wav"))
    _close_16bit(got, enhance_waveform("gcrn", get_model("gcrn").make(
        device="cpu"), wav, device="cpu"))


def test_enhance_without_a_checkpoint_found_exits(tmp_path):
    _corpus(str(tmp_path), n_utts=1, n=4000)
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["enhance", "--model", "gcrn", "--checkpoint",
                  str(tmp_path / "none"), "--mix-dir",
                  str(tmp_path / "noisy"), "--out-dir",
                  str(tmp_path / "est"), "--device", "cpu"])


def test_commands_run_on_the_card_by_default(tmp_path, monkeypatch):
    _corpus(str(tmp_path), n_utts=1, n=4000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["enhance", "--model", "gcrn"],
                 ["stream", "--model", "gcrn"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv + ["--mix-dir", str(tmp_path / "noisy"),
                             "--out-dir", str(tmp_path / "est")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--model", "dpcrn", "--mix-dir",
                  str(tmp_path / "noisy"), "--clean-dir",
                  str(tmp_path / "clean"), "--manifest",
                  str(tmp_path / "files.json")])


# --------------------------------------------------------------------- stream

def test_stream_both_modes_match_the_streamers(tmp_path):
    mix = tmp_path / "noisy"
    mix.mkdir()
    n = 12000
    write_wav(str(mix / "u0.wav"),
              (np.random.default_rng(3).standard_normal(n) * 0.1).astype(
                  np.float32), SR)
    wav, _ = read_wav(str(mix / "u0.wav"))

    cli.main(["stream", "--model", "lstm", "--mode", "exact", "--mix-dir",
              str(mix), "--out-dir", str(tmp_path / "e"), "--device", "cpu"])
    st = LstmStreamer(get_model("lstm").make(device="cpu"), device="cpu")
    parts = [st.push(wav[i:i + 1600]) for i in range(0, n, 1600)]
    want = np.concatenate(parts + [st.flush()])
    got, _ = read_wav(str(tmp_path / "e" / "u0.wav"))
    assert got.shape == (n,)
    _close_16bit(got, want)

    cli.main(["stream", "--model", "gcrn", "--mode", "windowed",
              "--mix-dir", str(mix), "--out-dir", str(tmp_path / "w"),
              "--chunk-seconds", "0.4", "--context-seconds", "0.2",
              "--device", "cpu"])
    want = enhance_windowed("gcrn", get_model("gcrn").make(device="cpu"),
                            wav, chunk_seconds=0.4, context_seconds=0.2,
                            device="cpu")
    got, _ = read_wav(str(tmp_path / "w" / "u0.wav"))
    assert got.shape == (n,)
    _close_16bit(got, want)


def test_stream_exact_takes_lstm_only(tmp_path):
    with pytest.raises(SystemExit, match="--model lstm"):
        cli.main(["stream", "--mode", "exact", "--model", "gcrn",
                  "--mix-dir", str(tmp_path), "--device", "cpu"])


# ---------------------------------------------------------------------- score

def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_score_matches_se_tpu(tmp_path):
    """The same est/ and clean/ through both CLIs: every column of the
    per-utterance CSV and of average.csv within 1e-6 relative."""
    _corpus(str(tmp_path), n_utts=2, n=SR)
    os.rename(tmp_path / "noisy", tmp_path / "est")
    args = ["score", "--est-dir", str(tmp_path / "est"), "--ref-dir",
            str(tmp_path / "clean"), "--tag", "t"]
    jcli.main(args + ["--csv", str(tmp_path / "j" / "r.csv")])
    cli.main(args + ["--csv", str(tmp_path / "p" / "r.csv")])
    for fname in ("r.csv", "average.csv"):
        want = _rows(tmp_path / "j" / fname)
        got = _rows(tmp_path / "p" / fname)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            key = "utt" if "utt" in w else "tag"
            assert g[key] == w[key]
            for k in w:
                if k != key:
                    assert np.isfinite(float(g[k])), k
                    np.testing.assert_allclose(float(g[k]), float(w[k]),
                                               rtol=1e-6, err_msg=k)


def test_score_of_an_empty_directory_exits(tmp_path):
    with pytest.raises(SystemExit, match="no wav"):
        cli.main(["score", "--est-dir", str(tmp_path), "--ref-dir",
                  str(tmp_path), "--csv", str(tmp_path / "r.csv")])


# ---------------------------------------------------------------------- train

def test_train_writes_checkpoints_that_enhance_restores(tmp_path, capsys):
    """DPCRN, 100 utterances of 1 s at batch 2: 50 steps, the first loss
    logged (se_tpu's CLI logs every 50 steps and passes no validation set,
    so there is no `best` pointer, as with se_tpu's). The utterances fill
    their 1 s bucket: a zero-padded frame makes DPCRN's estimate exactly 0
    there, where the com_mag_mse magnitude without a floor (se_tpu's,
    copied) has an infinite gradient that the frame mask turns into NaN."""
    _corpus(str(tmp_path), n_utts=100, n=SR)
    ckpt = str(tmp_path / "CP_dir")
    cli.main(["train", "--model", "dpcrn", "--mix-dir",
              str(tmp_path / "noisy"), "--clean-dir",
              str(tmp_path / "clean"), "--manifest",
              str(tmp_path / "files.json"), "--batch-size", "2",
              "--checkpoint-dir", ckpt, "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    assert set(os.listdir(ckpt)) == {"model.ckpt-0-50", "checkpoint",
                                     "loss_curve.csv"}
    with open(os.path.join(ckpt, "loss_curve.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "train_loss"] and len(rows) == 2
    assert rows[1][0] == "50" and np.isfinite(float(rows[1][1]))

    cli.main(["enhance", "--model", "dpcrn", "--checkpoint", ckpt,
              "--mix-dir", str(tmp_path / "noisy"), "--out-dir",
              str(tmp_path / "est"), "--device", "cpu"])
    model, init_fn, _, _ = make_train_step(TrainConfig(model="dpcrn"),
                                           device="cpu")
    state, found = restore_checkpoint(ckpt, init_fn(3))
    assert found and state["step"] == 50
    for fid in ("u0.wav", "u99.wav"):
        wav, _ = read_wav(str(tmp_path / "noisy" / fid))
        got, _ = read_wav(str(tmp_path / "est" / fid))
        _close_16bit(got, enhance_waveform("dpcrn", model, wav,
                                           device="cpu"))


def test_train_bf16_checkpoint_restores_fp32_weights(tmp_path):
    """`train --compute-dtype bf16`: one DPCRN step (two 1 s utterances at
    batch 2) whose checkpoint restores fp32 weights that moved from the
    init and are finite."""
    _corpus(str(tmp_path), n_utts=2, n=SR)
    ckpt = str(tmp_path / "CP")
    cli.main(["train", "--model", "dpcrn", "--mix-dir",
              str(tmp_path / "noisy"), "--clean-dir",
              str(tmp_path / "clean"), "--manifest",
              str(tmp_path / "files.json"), "--batch-size", "2",
              "--compute-dtype", "bf16", "--checkpoint-dir", ckpt,
              "--device", "cpu"])
    assert "model.ckpt-0-1" in os.listdir(ckpt)
    model, init_fn, _, _ = make_train_step(TrainConfig(model="dpcrn"),
                                           device="cpu")
    start = {k: v.clone() for k, v in init_fn(0)["model"].state_dict()
             .items()}
    state, found = restore_checkpoint(ckpt, init_fn(3))
    assert found and state["step"] == 1
    moved = 0
    for key, w in model.state_dict().items():
        assert w.dtype == torch.float32 and bool(torch.isfinite(w).all()), key
        moved += not torch.equal(w, start[key])
    assert moved > len(start) // 2
    for mu in state["opt_state"]["mu"].values():
        assert mu.dtype == torch.float32


def test_train_data_parallel_equals_plain_train(tmp_path, capsys):
    """`train --data-parallel --device cpu`: one gloo rank over a "data"
    mesh of one, whose checkpoint (weights, BN statistics, Adam's state,
    the generator) equals the plain `train`'s, bit for bit."""
    _corpus(str(tmp_path), n_utts=2, n=3200)
    args = ["train", "--model", "dpcrn", "--mix-dir",
            str(tmp_path / "noisy"), "--clean-dir", str(tmp_path / "clean"),
            "--manifest", str(tmp_path / "files.json"), "--batch-size", "2",
            "--device", "cpu", "--checkpoint-dir"]
    cli.main(args + [str(tmp_path / "CP")])
    cli.main(args + [str(tmp_path / "CP_dp"), "--data-parallel"])
    out = capsys.readouterr().out
    assert "data parallel: 1 rank(s) on cpu, backend gloo" in out
    assert not torch.distributed.is_initialized()
    plain, sharded = (torch.load(tmp_path / d / "model.ckpt-0-1",
                                 weights_only=False)
                      for d in ("CP", "CP_dp"))
    assert plain["step"] == sharded["step"] == 1
    for key, w in plain["model"].items():
        assert torch.equal(sharded["model"][key], w), key
    for part in ("mu", "nu"):
        for key, m in plain["opt_state"][part].items():
            assert torch.equal(sharded["opt_state"][part][key], m), key
    assert torch.equal(plain["generator"], sharded["generator"])


def test_deterministic_launcher_is_the_cli(tmp_path):
    """chip_smoke.py's `CLI_DETERMINISTIC` (its phase 9 trains: the CLI's
    `main` under cuDNN's deterministic algorithms) run as `python -c` on
    the CPU writes the checkpoint `python -m se_tpu_torch` writes, bit for
    bit."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        from chip_smoke import CLI_DETERMINISTIC
    finally:
        sys.path.remove(str(root))
    _corpus(str(tmp_path), n_utts=2, n=3200)
    args = ["train", "--model", "dpcrn", "--mix-dir", "noisy", "--clean-dir",
            "clean", "--manifest", "files.json", "--batch-size", "2",
            "--device", "cpu", "--checkpoint-dir"]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    for entry, ckpt in ((["-m", "se_tpu_torch"], "CP"),
                        (["-c", CLI_DETERMINISTIC], "CP_launcher")):
        run = subprocess.run([sys.executable, *entry, *args, ckpt],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True)
        assert run.returncode == 0, run.stderr[-2000:]
    plain, launched = (torch.load(tmp_path / d / "model.ckpt-0-1",
                                  weights_only=False)
                       for d in ("CP", "CP_launcher"))
    assert plain["step"] == launched["step"] == 1
    for key, w in plain["model"].items():
        assert torch.equal(launched["model"][key], w), key
    for part in ("mu", "nu"):
        for key, m in plain["opt_state"][part].items():
            assert torch.equal(launched["opt_state"][part][key], m), key
    assert torch.equal(plain["generator"], launched["generator"])


# --------------------------------------------------------------------- copies

def _signals(n=8000, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    ref = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
           + 0.05 * rng.standard_normal(n))
    deg = ref + 0.1 * rng.standard_normal(n)
    return ref, deg


@pytest.mark.parametrize("fs", [8000, 16000])
def test_pesq_equals_se_tpu(fs):
    ref, deg = _signals(fs)
    assert pesq.pesq(ref, deg, fs) == jpesq.pesq(ref, deg, fs)


def test_composite_equals_se_tpu():
    ref, deg = _signals()
    assert composite.llr_wss_segsnr(ref, deg, SR) == \
        jcomposite.llr_wss_segsnr(ref, deg, SR)
    assert composite.composite(ref, deg, SR, pesq_mos=2.5) == \
        jcomposite.composite(ref, deg, SR, pesq_mos=2.5)


@pytest.mark.parametrize("fs", [24000, 16000])
def test_hasqi_haspi_equal_se_tpu(fs):
    """At the model's own 24 kHz both are the same arithmetic; at 16 kHz
    se_tpu may resample through its native polyphase kernel, which matches
    scipy's (the port's) to ~2e-7."""
    ref, deg = _signals(fs // 2)
    for mine, theirs in ((hasqi.hasqi_v2, jhasqi.hasqi_v2),
                         (hasqi.haspi_v1, jhasqi.haspi_v1)):
        got, want = mine(ref, deg, fs), theirs(ref, deg, fs)
        if fs == 24000:
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)


def test_presets_equal_se_tpu_and_build_the_port_models():
    assert config.PRESETS.keys() == jconfig.PRESETS.keys()
    for name in config.PRESETS:
        mine, theirs = config.get_preset(name), jconfig.get_preset(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
        kw = mine.resolved_model_kwargs()
        assert kw == theirs.resolved_model_kwargs(), name
        model = get_model(mine.model).make(device="cpu", **kw)
        assert isinstance(model, torch.nn.Module)
    with pytest.raises(KeyError, match="available"):
        config.get_preset("nope")


def _se_tpu_param_count(name: str) -> int:
    entry = jmodels.get_model(name)
    model = entry.make()
    bins = get_model(name).stft.bins
    if entry.io_kind == "waveform":
        args = (np.zeros((1, 1600), np.float32),) * 2
    elif entry.io_kind == "hybrid":
        args = (np.zeros((1, 8, 257), np.float32),)
    elif entry.io_kind in ("mag_mask", "cirm"):
        args = (np.zeros((1, 16, bins), np.float32),)
    else:
        args = (np.zeros((1, 16, bins, 2), np.float32),)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return jprofiling.num_params(shapes)


@pytest.mark.parametrize("name", available_models())
def test_num_params_equals_se_tpu(name):
    model = get_model(name).make(device="cpu")
    assert profiling.num_params(model) == _se_tpu_param_count(name)


def test_flops_estimate_lstmnet_in_se_tpu_band():
    """se_tpu's band for one second of LSTMNet (0.7-1.5 x the published
    2.19 G MACs, tests/test_cli_config.py), at 2 FLOPs a multiply-add."""
    model = get_model("lstm").make(device="cpu")
    mag = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 101, 161)).astype(np.float32))
    fl = profiling.flops_estimate(model, mag)
    assert 0.7 < fl / (2 * 2.19e9) < 1.5, fl


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("test.sum"):
            torch.ones(64, 64).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    # the span on its own track, on the profiler's clock: around the op
    (span,) = [e for e in events if e.get("cat") == "se_tpu_torch"]
    assert span["name"] == "test.sum" and span["ph"] == "X"
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert ops
    for op in ops:
        assert span["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= span["ts"] + span["dur"]
    text = profiling.summary("lstm", get_model("lstm").make(
        hidden=8, device="cpu"))
    assert text.splitlines()[0] == "model: lstm"
