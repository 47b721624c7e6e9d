"""Typed configuration of the PyTorch port.

The port's own copy of the JAX package's configuration dataclasses
(``convtasnet_tpu/config.py``): the same classes, field names, defaults and
``to_dict``/``from_dict``, so the ``meta`` JSON of an inference package and
a ``config.json`` round-trip between the two packages. Every field is kept,
including those the port does not read yet (the TPU knobs, the mesh), so
``from_dict`` of a dict the JAX package wrote loses nothing.
``tests/test_torch_config.py`` holds the two copies to the same dicts.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


def _fromdict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class ConvTasNetConfig:
    """Model hyperparameters: N/L/B/H/P/X/R/C, norm_type in {gLN, cLN, BN},
    the causal flag and the mask nonlinearity in {relu, softmax}; the
    defaults are the paper config. ``separator`` picks the family: "tcn"
    (the paper's dilated TCN) or "dpt" (the dual-path attention
    separator, ``models/dual_path.py``), which alone reads the ``dpt_*``
    fields."""

    n_filters: int = 256        # N: autoencoder basis size
    kernel_size: int = 20       # L: encoder filter length in samples
    bottleneck: int = 256       # B: bottleneck channels
    hidden: int = 512           # H: conv block channels
    conv_kernel: int = 3        # P: depthwise conv kernel size
    num_blocks: int = 8         # X: blocks per repeat (dilation 2**0..2**(X-1))
    num_repeats: int = 4        # R: repeats
    num_speakers: int = 2       # C
    norm_type: str = "gLN"      # gLN | cLN | BN
    causal: bool = False
    mask_nonlinear: str = "relu"  # relu | softmax
    sample_rate: int = 8000
    separator: str = "tcn"      # tcn | dpt
    dpt_chunk: int = 128        # intra-chunk segment length (frames)
    dpt_layers: int = 4         # dual-path layer pairs
    # attention heads of the dual-path layers; 0 = auto (head-dim 32)
    dpt_heads: int = 0
    dpt_ff: int = 1024          # FFN hidden width
    compute_dtype: str = "float32"  # or bfloat16
    param_dtype: str = "float32"
    use_pallas: bool = False        # the hand-written kernels on the hot path
    remat: bool = False             # read by the JAX package only

    @property
    def stride(self) -> int:
        return self.kernel_size // 2

    @property
    def dpt_num_heads(self) -> int:
        """Resolved head count: explicit ``dpt_heads``, else head-dim 32."""
        return self.dpt_heads or max(1, self.bottleneck // 32)

    def receptive_field(self) -> int:
        """Receptive field of the TCN in encoder frames."""
        per_repeat = sum((self.conv_kernel - 1) * 2 ** x
                         for x in range(self.num_blocks))
        return 1 + self.num_repeats * per_repeat

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ConvTasNetConfig":
        return _fromdict(cls, d)


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline configuration."""

    train_dir: str = ""
    valid_dir: str = ""
    sample_rate: int = 8000
    segment: float = 4.0        # seconds; <0 => full utterances
    cv_maxlen: float = 8.0      # seconds; skip longer cv utts
    # "fixed" (skip one over-long utt at a time) or "reference" (skip the
    # whole batch_size window, as the original recipe does)
    cv_skip_semantics: str = "fixed"
    batch_size: int = 3         # segments per minibatch
    max_hours: Optional[float] = None
    shuffle: bool = True
    num_workers: int = 4
    segment_cache: bool = True  # decode-once memmapped train-batch cache

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataConfig":
        return _fromdict(cls, d)


@dataclass(frozen=True)
class SolverConfig:
    """Training-loop configuration."""

    epochs: int = 30
    optimizer: str = "adam"     # adam | sgd
    lr: float = 1e-3
    momentum: float = 0.0       # sgd only
    l2: float = 0.0             # weight decay
    max_grad_norm: float = 5.0
    half_lr: bool = True        # halve LR after `lr_patience` non-improving epochs
    lr_patience: int = 3
    early_stop: bool = True
    stop_patience: int = 7
    save_folder: str = "exp/temp"
    enable_checkpoint: bool = False   # per-epoch checkpoints
    model_path: str = "final.ckpt"    # best-model filename inside save_folder
    continue_from: str = ""
    print_freq: int = 10
    seed: int = 0
    steps_per_call: int = 1   # read by the JAX package only
    train_batch_chunk: int = 0  # gradient accumulation slice (0 = full batch)
    profile_dir: str = ""     # profiler trace directory (empty = off)
    profile_steps: int = 10
    probe_budget_s: float = 3600.0  # read by the JAX package only

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SolverConfig":
        return _fromdict(cls, d)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / parallelism configuration."""

    data_axis: int = -1   # -1 => all devices on the data axis
    model_axis: int = 1   # optional channel-sharded TP axis
    axis_names: tuple = ("data", "model")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MeshConfig":
        d = dict(d)
        if "axis_names" in d:
            d["axis_names"] = tuple(d["axis_names"])
        return _fromdict(cls, d)


@dataclass(frozen=True)
class TrainConfig:
    """Top-level bundle: model + data + solver + mesh."""

    model: ConvTasNetConfig = field(default_factory=ConvTasNetConfig)
    data: DataConfig = field(default_factory=DataConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_dict(self) -> dict:
        return {
            "model": self.model.to_dict(),
            "data": self.data.to_dict(),
            "solver": self.solver.to_dict(),
            "mesh": self.mesh.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        return cls(
            model=ConvTasNetConfig.from_dict(d.get("model", {})),
            data=DataConfig.from_dict(d.get("data", {})),
            solver=SolverConfig.from_dict(d.get("solver", {})),
            mesh=MeshConfig.from_dict(d.get("mesh", {})),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls.from_dict(json.loads(s))


def exp_name(cfg: TrainConfig) -> str:
    """Experiment directory name encoding the full config."""
    m, d, s = cfg.model, cfg.data, cfg.solver
    return (
        f"train_r{d.sample_rate}_seg{d.segment}_bs{d.batch_size}"
        f"_N{m.n_filters}_L{m.kernel_size}_B{m.bottleneck}_H{m.hidden}"
        f"_P{m.conv_kernel}_X{m.num_blocks}_R{m.num_repeats}_C{m.num_speakers}"
        f"_{m.norm_type}_causal{int(m.causal)}_{m.mask_nonlinear}"
        + ("" if m.separator == "tcn" else f"_{m.separator}")
        + f"_ep{s.epochs}_{s.optimizer}_lr{s.lr}_gn{s.max_grad_norm}"
    )
