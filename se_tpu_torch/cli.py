"""Command-line drivers: enhance / stream / score / train, the port of
se_tpu/cli.py with its subcommands, options and defaults, plus `--device`
(the card unless `--device cpu`; without CUDA and without it the command
raises, it does not carry on on the CPU).

`enhance` replicates both reference decode layouts (ref SURVEY.md §2.2
"Decode drivers"):
- VB: flat directory of noisy wavs, resampled to 16 kHz
  (ref LSTM/lstm_decode_vb.py:25-65);
- WSJ: mix/{noise_type}/{seen,unseen}/{snr}/ tree driven by noise-type x
  seen x SNR combinations (ref LSTM/lstm_decode.py:26-36,69-381).

`score` computes PESQ, SI-SDR, SNR, segSNR, STOI and eSTOI per utterance
and writes a CSV plus a running average like DeepXi's test() driver
(ref DeepXi/deepxi/model.py:427-460).

A checkpoint is the port's (`train.checkpoint`, torch.save); se_tpu's
Orbax checkpoints do not load here. `main` turns TF32 off for cuDNN and
matmuls before anything runs: the card then computes in fp32 as the CPU
does (torch's cuDNN default is TF32 on).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch


def _load_model(args, entry, dev):
    """The model of `--model` on `dev`: the weights of the latest (or
    `--best`) checkpoint in `--checkpoint`, else, with a warning, the
    constructor's seed-0 weights (smoke and debug runs)."""
    if not args.checkpoint:
        print("[warn] no --checkpoint given; using the constructor's seed-0 "
              "weights", file=sys.stderr)
        return entry.make(device=dev)
    from se_tpu_torch.train.checkpoint import restore_checkpoint
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    model, init_fn, _, _ = make_train_step(TrainConfig(model=args.model),
                                           device=dev)
    _, found = restore_checkpoint(args.checkpoint, init_fn(0),
                                  best=args.best)
    if not found:
        raise SystemExit(f"no checkpoint found in {args.checkpoint}")
    return model.eval()


def _read(path: str, fs: int) -> np.ndarray:
    from se_tpu_torch.data import read_wav, resample

    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    return resample(wav, sr, fs)


def cmd_enhance(args):
    from se_tpu_torch.data import write_wav
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.models import get_model

    entry = get_model(args.model)
    dev = resolve_device(args.device)
    model = _load_model(args, entry, dev)

    def subdirs():
        if args.dataset == "vb":
            yield "", args.mix_dir
        else:  # wsj tree
            for noise in args.noise_types:
                for snr in args.snrs:
                    seen = "seen" if args.seen else "unseen"
                    rel = os.path.join(noise, seen, str(snr))
                    yield rel, os.path.join(args.mix_dir, rel)

    count = 0
    for rel, mix_dir in subdirs():
        out_dir = os.path.join(args.out_dir, rel)
        os.makedirs(out_dir, exist_ok=True)
        for fid in sorted(os.listdir(mix_dir)):
            if not fid.endswith(".wav"):
                continue
            wav = _read(os.path.join(mix_dir, fid), args.fs)
            est = enhance_waveform(args.model, model, wav,
                                   compressed=not args.uncompressed,
                                   device=dev)
            write_wav(os.path.join(out_dir, fid), est, args.fs)
            count += 1
            print(f" The {count} utterance has been decoded!")


def cmd_stream(args):
    """Streaming decode of a flat wav directory: `--mode exact` uses the
    state-carrying LstmStreamer (lstm model, frame + chunk latency),
    `--mode windowed` the zoo-wide windowed decode (bounded memory)."""
    from se_tpu_torch.data import write_wav
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.eval.streaming import LstmStreamer, enhance_windowed
    from se_tpu_torch.models import get_model

    if args.mode == "exact" and args.model != "lstm":
        raise SystemExit("--mode exact currently supports --model lstm")
    entry = get_model(args.model)
    dev = resolve_device(args.device)
    model = _load_model(args, entry, dev)
    os.makedirs(args.out_dir, exist_ok=True)
    count = 0
    for fid in sorted(os.listdir(args.mix_dir)):
        if not fid.endswith(".wav"):
            continue
        wav = _read(os.path.join(args.mix_dir, fid), args.fs)
        if args.mode == "exact":
            st = LstmStreamer(model, compressed=not args.uncompressed,
                              chunk_frames=args.chunk_frames, device=dev)
            step = max(entry.stft.hop, int(args.push_seconds * args.fs))
            parts = [st.push(wav[i:i + step])
                     for i in range(0, len(wav), step)]
            parts.append(st.flush())
            est = np.concatenate(parts)
        else:
            est = enhance_windowed(
                args.model, model, wav, chunk_seconds=args.chunk_seconds,
                context_seconds=args.context_seconds,
                compressed=not args.uncompressed, device=dev)
        write_wav(os.path.join(args.out_dir, fid), est, args.fs)
        count += 1
        print(f" The {count} utterance has been streamed!")


def cmd_score(args):
    from se_tpu_torch.eval import metrics
    from se_tpu_torch.eval.pesq import pesq

    rows = []
    for fid in sorted(os.listdir(args.est_dir)):
        if not fid.endswith(".wav"):
            continue
        ref_name = fid if args.dataset == "vb" else fid.split("_")[0] + ".wav"
        est = _read(os.path.join(args.est_dir, fid), args.fs)
        ref = _read(os.path.join(args.ref_dir, ref_name), args.fs)
        n = min(len(est), len(ref))
        est, ref = est[:n].astype(np.float64), ref[:n].astype(np.float64)
        row = {
            "utt": fid,
            "pesq_mos_lqo": pesq(ref, est, args.fs)
            if args.fs in (8000, 16000) else float("nan"),
            "si_sdr": metrics.si_sdr(est, ref),
            "snr": metrics.snr(est, ref),
            "seg_snr": metrics.seg_snr(est, ref),
            "stoi": metrics.stoi(est, ref, args.fs),
            "estoi": metrics.estoi(est, ref, args.fs),
        }
        if args.hasqi:
            from se_tpu_torch.eval.hasqi import hasqi_v2, haspi_v1

            row["hasqi"] = hasqi_v2(ref, est, args.fs)
            row["haspi"] = haspi_v1(ref, est, args.fs)
        rows.append(row)
    if not rows:
        raise SystemExit("no wav files scored")
    os.makedirs(os.path.dirname(os.path.abspath(args.csv)), exist_ok=True)
    keys = list(rows[0].keys())
    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    # running average CSV, like DeepXi's average.csv (model.py:446-460)
    avg_path = os.path.join(os.path.dirname(os.path.abspath(args.csv)),
                            "average.csv")
    avg = {k: float(np.mean([r[k] for r in rows])) for k in keys[1:]}
    exists = os.path.isfile(avg_path)
    with open(avg_path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["tag"] + keys[1:])
        if not exists:
            w.writeheader()
        w.writerow({"tag": args.tag or args.est_dir, **avg})
    for k, v in avg.items():
        print(f"{k}: {v:.4f}")


def cmd_train(args):
    from se_tpu_torch.device import resolve_device

    if args.data_parallel:
        _train_data_parallel(args)
    else:
        _train(args, resolve_device(args.device))


def _train(args, dev, mesh=None) -> None:
    """`train` on `dev`; under `mesh` this rank's part of the sharded
    run, rank 0 writing the checkpoints and printing the loss."""
    from se_tpu_torch.data import ManifestDataset
    from se_tpu_torch.models import get_model
    from se_tpu_torch.train.trainer import TrainConfig, train_epochs
    from se_tpu_torch.utils.config import get_preset

    preset = get_preset(args.preset) if args.preset else None
    model_name = preset.model if preset else args.model
    cfg = TrainConfig(
        model=model_name,
        learning_rate=args.lr if args.lr else (preset.lr if preset else 1e-3),
        compressed=not args.uncompressed,
        remat=args.remat,
        compute_dtype=args.compute_dtype,
        model_kwargs=preset.resolved_model_kwargs() if preset else {},
    )
    stft = get_model(model_name).stft
    ds = ManifestDataset(
        args.mix_dir, args.clean_dir, args.manifest,
        batch_size=args.batch_size, convention=args.dataset,
        win_size=stft.win_length, win_shift=stft.hop,
    )
    try:
        _, _, history = train_epochs(cfg, ds, epochs=args.epochs,
                                     checkpoint_dir=args.checkpoint_dir,
                                     device=dev, mesh=mesh)
    except NotImplementedError as err:  # the trainer's own (DeepXi's)
        raise SystemExit(str(err)) from err
    if history and (mesh is None or mesh.rank == 0):
        print(f"final loss: {history[-1][1]:.5f}")


def _train_data_parallel(args) -> None:
    """`train --data-parallel`: one rank a card over a "data" mesh. Under
    a launcher (torchrun: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT set) this process is its rank; otherwise it runs one rank
    a visible card, itself the only one on a single card; with `--device
    cpu`, one gloo rank."""
    import socket

    from se_tpu_torch.device import resolve_device

    kind = resolve_device(args.device).type
    if "WORLD_SIZE" in os.environ:
        _rank(None, None, None, args, kind)
        return
    with socket.socket() as sock:  # a free port on this host
        sock.bind(("localhost", 0))
        address = f"tcp://localhost:{sock.getsockname()[1]}"
    world = torch.cuda.device_count() if kind == "cuda" else 1
    if world == 1:
        _rank(0, 1, address, args, kind)
    else:
        torch.multiprocessing.spawn(_rank, (world, address, args, kind),
                                    nprocs=world)


def _rank(rank, world, address, args, kind: str) -> None:
    """One rank of `train --data-parallel`: join the group (`address`,
    `world`, `rank`; all None: the launcher's environment), train on this
    rank's device, leave the group."""
    import torch.distributed as dist

    from se_tpu_torch.parallel import (
        initialize_multihost, make_mesh, rank_device,
    )

    if rank is not None:
        torch.backends.cudnn.allow_tf32 = False  # a spawned rank's own
        torch.backends.cuda.matmul.allow_tf32 = False
    backend = initialize_multihost(address, world, rank, kind)
    mesh = make_mesh()
    dev = rank_device(kind, rank)
    if mesh.rank == 0:
        print(f"data parallel: {mesh.data} rank(s) on {kind}, backend "
              f"{backend}", flush=True)
    try:
        _train(args, dev, mesh)
    finally:
        dist.destroy_process_group()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("se_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "cuda (the default) or cpu"

    pe = sub.add_parser("enhance")
    pe.add_argument("--model", required=True)
    pe.add_argument("--mix-dir", dest="mix_dir", required=True)
    pe.add_argument("--out-dir", dest="out_dir", required=True)
    pe.add_argument("--checkpoint", default="")
    pe.add_argument("--best", action="store_true")
    pe.add_argument("--dataset", choices=["vb", "wsj"], default="vb")
    pe.add_argument("--noise-types", nargs="*", default=["babble"])
    pe.add_argument("--snrs", nargs="*", type=int, default=[-5, 0, 5, 10])
    pe.add_argument("--seen", action="store_true")
    pe.add_argument("--uncompressed", action="store_true")
    pe.add_argument("--fs", type=int, default=16000)
    pe.add_argument("--device", default=None, help=device_help)
    pe.set_defaults(func=cmd_enhance)

    pst = sub.add_parser("stream")
    pst.add_argument("--model", default="lstm")
    pst.add_argument("--mode", choices=["exact", "windowed"],
                     default="windowed")
    pst.add_argument("--mix-dir", dest="mix_dir", required=True)
    pst.add_argument("--out-dir", dest="out_dir", default="./streamed")
    pst.add_argument("--checkpoint", default="")
    pst.add_argument("--best", action="store_true")
    pst.add_argument("--uncompressed", action="store_true")
    pst.add_argument("--fs", type=int, default=16000)
    pst.add_argument("--chunk-seconds", type=float, default=4.0)
    pst.add_argument("--context-seconds", type=float, default=2.0)
    pst.add_argument("--chunk-frames", type=int, default=16)
    pst.add_argument("--push-seconds", type=float, default=0.1)
    pst.add_argument("--device", default=None, help=device_help)
    pst.set_defaults(func=cmd_stream)

    ps = sub.add_parser("score")
    ps.add_argument("--est-dir", dest="est_dir", required=True)
    ps.add_argument("--ref-dir", dest="ref_dir", required=True)
    ps.add_argument("--csv", default="./results/results.csv")
    ps.add_argument("--dataset", choices=["vb", "wsj"], default="vb")
    ps.add_argument("--tag", default="")
    ps.add_argument("--fs", type=int, default=16000)
    ps.add_argument("--hasqi", action="store_true",
                    help="also compute HASQI v2 / HASPI v1 (slower)")
    ps.set_defaults(func=cmd_score)

    pt = sub.add_parser("train")
    pt.add_argument("--model", default="lstm")
    pt.add_argument("--preset", default="")
    pt.add_argument("--mix-dir", dest="mix_dir", required=True)
    pt.add_argument("--clean-dir", dest="clean_dir", required=True)
    pt.add_argument("--manifest", required=True)
    pt.add_argument("--dataset", choices=["vb", "wsj"], default="vb")
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--epochs", type=int, default=1)
    pt.add_argument("--lr", type=float, default=0.0)
    pt.add_argument("--uncompressed", action="store_true")
    pt.add_argument("--checkpoint-dir", default="./CP_dir")
    pt.add_argument("--data-parallel", action="store_true",
                    help="shard each batch over one rank a card (under "
                    "torchrun: its ranks), a step equal to one device's "
                    "on the whole batch; --device cpu: one gloo rank")
    pt.add_argument("--remat", choices=["none", "dots", "full"],
                    default="none",
                    help="activation rematerialization policy")
    pt.add_argument("--compute-dtype", dest="compute_dtype",
                    choices=["fp32", "bf16"], default="fp32",
                    help="bf16 trains with fp32 master weights (every "
                    "family this command trains; DeepXi trains through "
                    "its driver, in fp32)")
    pt.add_argument("--device", default=None, help=device_help)
    pt.set_defaults(func=cmd_train)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args.func(args)


if __name__ == "__main__":
    main()
