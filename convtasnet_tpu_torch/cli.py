"""Command line of the PyTorch port.

    python -m convtasnet_tpu_torch.cli preprocess --data-dir WAVS --out-dir JSON
    python -m convtasnet_tpu_torch.cli train --train-dir JSON/tr \\
        --valid-dir JSON/cv --save-folder OUT [--device cuda]
    python -m convtasnet_tpu_torch.cli separate --model-path PKG \\
        --mix-dir DIR --out-dir OUT [--device cuda]
    python -m convtasnet_tpu_torch.cli evaluate --model-path PKG \\
        --data-dir JSON/tt [--cal-sdr 1] [--device cuda]
    python -m convtasnet_tpu_torch.cli stream-demo --model-path PKG \\
        --wav MIX.wav [--chunk-ms 8] [--device cuda]

Each subcommand takes the JAX package's flags (``convtasnet_tpu/cli.py``)
plus ``--device`` (default ``cuda``; it raises when CUDA is absent, and
``--device cpu`` runs the plain path on the CPU). ``--use-pallas`` keeps
its meaning: -1 runs the CUDA kernels on a CUDA device, 1 insists on them,
0 runs the plain ops. ``train`` trains either separator family, the TCN
or the dual-path one (``--separator dpt``); ``separate`` and ``evaluate``
take the model from the package; ``separate --streaming 1`` and
``stream-demo`` run a causal cLN or BN package through the streaming
separator. ``train --n-model m`` and ``separate --tensor-parallel m`` split
a TCN's hidden width, or a dual-path model's heads and FFN width, over m
shards (``parallel/``; all on one card where there is one, with the
placement printed on one line). Flags of what is
not ported yet raise and name the ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    from convtasnet_tpu_torch.config import ConvTasNetConfig

    g = p.add_argument_group("model")
    g.add_argument("--N", type=int, default=256, help="filters in autoencoder")
    g.add_argument("--L", type=int, default=20, help="filter length (samples)")
    g.add_argument("--B", type=int, default=256, help="bottleneck channels")
    g.add_argument("--H", type=int, default=512, help="conv block channels")
    g.add_argument("--P", type=int, default=3, help="dw conv kernel size")
    g.add_argument("--X", type=int, default=8, help="blocks per repeat")
    g.add_argument("--R", type=int, default=4, help="repeats")
    g.add_argument("--C", type=int, default=2, help="speakers")
    g.add_argument("--norm-type", default="gLN", choices=["gLN", "cLN", "BN"])
    g.add_argument("--causal", type=int, default=0)
    g.add_argument("--mask-nonlinear", default="relu",
                   choices=["relu", "softmax"])
    g.add_argument("--separator", default="tcn", choices=["tcn", "dpt"],
                   help="separator family: the paper's TCN or the dual-path "
                        "attention separator (dpt)")
    g.add_argument("--dpt-chunk", type=int, default=128)
    g.add_argument("--dpt-layers", type=int, default=4)
    g.add_argument("--dpt-heads", type=int, default=0)
    g.add_argument("--dpt-ff", type=int, default=1024)
    g.add_argument("--compute-dtype", default=ConvTasNetConfig.compute_dtype,
                   choices=["float32", "bfloat16"])
    g.add_argument("--use-pallas", type=int, default=-1, choices=[-1, 0, 1],
                   help="the model's CUDA kernels, forward and backward "
                        "(the TCN block's, or the DPT inter, intra and FFN "
                        "sublayers'): -1 auto (on for a CUDA device), 0 off, "
                        "1 on")


def _add_data_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("data")
    g.add_argument("--sample-rate", type=int, default=8000)
    g.add_argument("--segment", type=float, default=4.0)
    g.add_argument("--cv-maxlen", type=float, default=8.0)
    g.add_argument("--cv-skip-semantics", default="fixed",
                   choices=["fixed", "reference"],
                   help="over-long cv utterances: 'fixed' skips one at a "
                        "time, 'reference' the reference's whole window")
    g.add_argument("--batch-size", type=int, default=3)
    g.add_argument("--max-hours", type=float, default=None)
    g.add_argument("--num-workers", type=int, default=4)
    g.add_argument("--shuffle", type=int, default=1)
    g.add_argument("--segment-cache", type=int, default=1,
                   help="decode-once memmapped cache of planned train "
                        "batches; 0 decodes every epoch")


def _add_solver_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("solver")
    g.add_argument("--epochs", type=int, default=30)
    g.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    g.add_argument("--lr", type=float, default=1e-3)
    g.add_argument("--momentum", type=float, default=0.0)
    g.add_argument("--l2", type=float, default=0.0)
    g.add_argument("--max-norm", type=float, default=5.0)
    g.add_argument("--half-lr", type=int, default=1)
    g.add_argument("--early-stop", type=int, default=1)
    g.add_argument("--save-folder", default="exp/temp")
    g.add_argument("--enable-checkpoint", type=int, default=0)
    g.add_argument("--model-path", default="final.ckpt")
    g.add_argument("--continue-from", default="")
    g.add_argument("--print-freq", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--steps-per-call", type=int, default=1,
                   help="accepted for flag parity and ignored: the JAX "
                        "package scans N steps per device dispatch; here "
                        "each step is one call")
    g.add_argument("--train-batch-chunk", type=int, default=0,
                   help="accumulate gradients over this many batch rows at "
                        "a time (0 = full batch; same numbers)")
    g.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the first "
                        "epoch's steady-state steps to DIR")
    g.add_argument("--profile-steps", type=int, default=10)
    g.add_argument("--n-data", type=int, default=-1,
                   help="data-parallel devices (> 1: not ported yet)")
    g.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel shards: of the TCN's hidden "
                        "width, or of the dual-path model's heads and FFN "
                        "width")


def _check_ported(a: argparse.Namespace) -> None:
    if a.n_data > 1:
        raise NotImplementedError(
            "data-parallel training (--n-data > 1) is not ported yet "
            "(ROADMAP A8c)")


def _print_placement(n_model: int, device) -> None:
    from convtasnet_tpu_torch.parallel.mesh import (
        describe_placement,
        shard_devices,
    )

    if n_model > 1:
        print(describe_placement(shard_devices(n_model, device)), flush=True)


def _cfg_from_args(a: argparse.Namespace):
    from convtasnet_tpu_torch.config import (
        ConvTasNetConfig,
        DataConfig,
        MeshConfig,
        SolverConfig,
        TrainConfig,
    )

    return TrainConfig(
        model=ConvTasNetConfig(
            n_filters=a.N, kernel_size=a.L, bottleneck=a.B, hidden=a.H,
            conv_kernel=a.P, num_blocks=a.X, num_repeats=a.R,
            num_speakers=a.C, norm_type=a.norm_type, causal=bool(a.causal),
            mask_nonlinear=a.mask_nonlinear, sample_rate=a.sample_rate,
            separator=a.separator, dpt_chunk=a.dpt_chunk,
            dpt_layers=a.dpt_layers, dpt_heads=a.dpt_heads, dpt_ff=a.dpt_ff,
            compute_dtype=a.compute_dtype, use_pallas=a.use_pallas == 1),
        data=DataConfig(
            train_dir=a.train_dir, valid_dir=a.valid_dir,
            sample_rate=a.sample_rate, segment=a.segment,
            cv_maxlen=a.cv_maxlen, cv_skip_semantics=a.cv_skip_semantics,
            batch_size=a.batch_size, max_hours=a.max_hours,
            shuffle=bool(a.shuffle), num_workers=a.num_workers,
            segment_cache=bool(a.segment_cache)),
        solver=SolverConfig(
            epochs=a.epochs, optimizer=a.optimizer, lr=a.lr,
            momentum=a.momentum, l2=a.l2, max_grad_norm=a.max_norm,
            half_lr=bool(a.half_lr), early_stop=bool(a.early_stop),
            save_folder=a.save_folder,
            enable_checkpoint=bool(a.enable_checkpoint),
            model_path=a.model_path, continue_from=a.continue_from,
            print_freq=a.print_freq, seed=a.seed,
            train_batch_chunk=a.train_batch_chunk,
            profile_dir=a.profile, profile_steps=a.profile_steps),
        mesh=MeshConfig(data_axis=a.n_data, model_axis=a.n_model),
    )


def cmd_preprocess(a) -> int:
    from convtasnet_tpu_torch.data.manifest import build_manifests

    build_manifests(a.data_dir, a.out_dir, a.sample_rate, num_speakers=a.C)
    print(f"manifests written to {a.out_dir}")
    return 0


def cmd_train(a) -> int:
    from convtasnet_tpu_torch.config import SolverConfig, TrainConfig, exp_name
    from convtasnet_tpu_torch.data.dataset import SeparationDataset
    from convtasnet_tpu_torch.data.loader import BatchLoader
    from convtasnet_tpu_torch.data.segment_cache import maybe_cache
    from convtasnet_tpu_torch.infer.separate import resolve_device
    from convtasnet_tpu_torch.train.solver import Solver

    _check_ported(a)
    device = resolve_device(a.device)
    _print_placement(a.n_model, device)
    cfg = _cfg_from_args(a)
    if a.auto_exp_name:
        cfg = TrainConfig(
            model=cfg.model, data=cfg.data, mesh=cfg.mesh,
            solver=SolverConfig(**{**cfg.solver.to_dict(),
                                   "save_folder": os.path.join(
                                       a.save_folder, exp_name(cfg))}))
    d = cfg.data
    tr_ds = SeparationDataset(
        a.train_dir, d.batch_size, d.sample_rate, segment=d.segment,
        max_hours=d.max_hours, num_speakers=cfg.model.num_speakers)
    cv_ds = SeparationDataset(
        a.valid_dir, 1, d.sample_rate, segment=-1.0, cv_maxlen=d.cv_maxlen,
        num_speakers=cfg.model.num_speakers,
        cv_skip_semantics=d.cv_skip_semantics)
    tr = BatchLoader(maybe_cache(tr_ds, enable=d.segment_cache),
                     shuffle=d.shuffle, device=device,
                     num_workers=d.num_workers, seed=cfg.solver.seed)
    cv = BatchLoader(cv_ds, device=device, num_workers=d.num_workers,
                     pad_to_multiple=d.sample_rate)
    os.makedirs(cfg.solver.save_folder, exist_ok=True)
    with open(os.path.join(cfg.solver.save_folder, "config.json"), "w") as f:
        f.write(cfg.to_json())
    use_pallas = None if a.use_pallas < 0 else bool(a.use_pallas)
    result = Solver(cfg, tr, cv, device=device, use_pallas=use_pallas).train()
    print(f"best cv loss: {result['best_val_loss']:.3f}")
    return 0


def cmd_separate(a) -> int:
    from convtasnet_tpu_torch.infer.separate import resolve_device, separate

    _print_placement(a.tensor_parallel, resolve_device(a.device))
    n = separate(a.model_path, a.out_dir, mix_dir=a.mix_dir,
                 mix_json=a.mix_json, batch_size=a.batch_size,
                 sample_rate=a.sample_rate, streaming=bool(a.streaming),
                 chunk_seconds=a.chunk_seconds,
                 sequence_parallel=bool(a.sequence_parallel),
                 ring_attention=bool(a.ring_attention),
                 use_pallas=None if a.use_pallas < 0 else bool(a.use_pallas),
                 tensor_parallel=a.tensor_parallel, device=a.device)
    print(f"separated {n} utterances into {a.out_dir}")
    return 0


def cmd_evaluate(a) -> int:
    import json

    from convtasnet_tpu_torch.infer.evaluate import evaluate

    res = evaluate(a.model_path, a.data_dir, batch_size=a.batch_size,
                   sample_rate=a.sample_rate, cal_sdr=bool(a.cal_sdr),
                   max_batches=a.max_batches,
                   use_pallas=None if a.use_pallas < 0 else bool(a.use_pallas),
                   device=a.device)
    print(json.dumps(res))
    return 0


def cmd_stream_demo(a) -> int:
    import json

    from convtasnet_tpu_torch.infer.stream_demo import stream_demo

    print(json.dumps(stream_demo(a.model_path, a.wav, a.chunk_ms, a.out_dir,
                                 realtime=bool(a.realtime), device=a.device)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="convtasnet-tpu-torch",
        description="Conv-TasNet speech separation, PyTorch port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("preprocess", help="build JSON manifests")
    p.add_argument("--data-dir", required=True,
                   help="wav tree root: {tr,cv,tt}/{mix,s1..sC}/*.wav")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--C", type=int, default=2)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("train", help="train")
    p.add_argument("--train-dir", required=True,
                   help="json dir with tr manifests")
    p.add_argument("--valid-dir", required=True,
                   help="json dir with cv manifests")
    p.add_argument("--auto-exp-name", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when CUDA is absent")
    _add_model_flags(p)
    _add_data_flags(p)
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="SI-SNRi / SDRi evaluation")
    p.add_argument("--model-path", required=True,
                   help="inference package or training checkpoint")
    p.add_argument("--data-dir", required=True,
                   help="json dir with tt manifests")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--cal-sdr", type=int, default=0)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--use-pallas", type=int, default=-1, choices=[-1, 0, 1],
                   help="the model's CUDA kernels: -1 auto (on for a CUDA "
                        "device), 0 off, 1 on")
    p.add_argument("--batch-chunk", type=int, default=8,
                   help="accepted for flag parity and ignored: the JAX "
                        "package splits batches to fit TPU VMEM; here each "
                        "batch is one forward")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when CUDA is absent")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("separate", help="write separated wavs")
    p.add_argument("--model-path", required=True,
                   help="inference package or training checkpoint "
                        "(train/checkpoint.py)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--mix-dir", default=None)
    p.add_argument("--mix-json", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--streaming", type=int, default=0,
                   help="chunk-by-chunk causal streaming (a causal cLN or "
                        "BN package)")
    p.add_argument("--chunk-seconds", type=float, default=0.5)
    p.add_argument("--sequence-parallel", type=int, default=0,
                   help="shard each mixture's time axis (not ported yet)")
    p.add_argument("--ring-attention", type=int, default=0,
                   help="with --sequence-parallel (not ported yet)")
    p.add_argument("--use-pallas", type=int, default=-1, choices=[-1, 0, 1],
                   help="the model's CUDA kernels: -1 auto (on for a CUDA "
                        "device), 0 off, 1 on")
    p.add_argument("--batch-chunk", type=int, default=8,
                   help="accepted for flag parity and ignored: the JAX "
                        "package splits batches to fit TPU VMEM; here each "
                        "batch is one forward")
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="split a TCN package's hidden width, or a "
                        "dual-path package's heads and FFN width, over m > 1 "
                        "shards")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when CUDA is absent")
    p.set_defaults(fn=cmd_separate)

    p = sub.add_parser("stream-demo",
                       help="real-time chunked separation with latency stats")
    p.add_argument("--model-path", required=True,
                   help="causal (cLN or BN) package")
    p.add_argument("--wav", required=True)
    p.add_argument("--chunk-ms", type=float, default=8.0)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--realtime", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when CUDA is absent")
    p.set_defaults(fn=cmd_stream_demo)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
