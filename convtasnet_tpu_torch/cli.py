"""Command line of the PyTorch port.

    python -m convtasnet_tpu_torch.cli separate --model-path PKG \\
        --mix-dir DIR --out-dir OUT [--device cuda]

``separate`` takes the JAX package's ``separate`` flags plus ``--device``
(default ``cuda``; it raises when CUDA is absent, and ``--device cpu`` runs
the plain path on the CPU).
"""

from __future__ import annotations

import argparse
import sys


def cmd_separate(a) -> int:
    from convtasnet_tpu_torch.infer.separate import separate

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="convtasnet-tpu-torch",
        description="Conv-TasNet speech separation, PyTorch port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("separate", help="write separated wavs")
    p.add_argument("--model-path", required=True,
                   help="inference package (train/checkpoint.py)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--mix-dir", default=None)
    p.add_argument("--mix-json", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--streaming", type=int, default=0,
                   help="chunk-by-chunk causal streaming (not ported yet)")
    p.add_argument("--chunk-seconds", type=float, default=0.5)
    p.add_argument("--sequence-parallel", type=int, default=0,
                   help="shard each mixture's time axis (not ported yet)")
    p.add_argument("--ring-attention", type=int, default=0,
                   help="with --sequence-parallel (not ported yet)")
    p.add_argument("--use-pallas", type=int, default=-1, choices=[-1, 0, 1],
                   help="TCN-block CUDA kernel: -1 auto (on for a CUDA "
                        "device), 0 off, 1 on")
    p.add_argument("--batch-chunk", type=int, default=8,
                   help="accepted for flag parity and ignored: the JAX "
                        "package splits batches to fit TPU VMEM; here each "
                        "batch is one forward")
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="model-axis size m > 1 (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises when CUDA is absent")
    p.set_defaults(fn=cmd_separate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
