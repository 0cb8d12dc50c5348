"""Config system.

The same ``key = value`` parameter files (``parameters/parameters_<ds>.txt``),
keys, dataclasses, defaults and validation as the JAX package's
``parallel_gcn_tpu/config.py``, so every file parses to the same values. The
``tpu`` section keeps its name because the parameter files use its keys; in
the port it holds the execution knobs of the GPU path (aggregation backend,
compute dtype, tile geometry, seed).

Compile-time flags of the reference become runtime booleans:
  -DNO_FEATURE            -> ``DataConfig.binarize_features``
  -DRESIDUAL_CONNECTIONS  -> ``GCNConfig.residual``
  -DNO_OUTPUT             -> ``TrainConfig.verbose``
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Sequence


def _parse_scalar(text: str):
    text = text.strip()
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    return text


def parse_keyvalue_file(path: str) -> dict:
    """Parse a GetPot-style ``key = value`` file (comments start with ``#``);
    values that contain commas are returned as lists."""
    out: dict = {}
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            val = val.strip()
            if "," in val:
                out[key] = [_parse_scalar(v) for v in val.split(",") if v.strip()]
            else:
                out[key] = _parse_scalar(val)
    return out


@dataclass
class GCNConfig:
    """Model hyperparameters (reference: include/gcn.cuh:40-49)."""

    n_layers: int = 2
    hidden_dims: Sequence[int] = (16,)
    dropouts: Sequence[float] = (0.5, 0.5)
    epochs: int = 100
    early_stopping: int = 0
    residual: bool = False
    # model family: gcn, gat, sage or gin (the port trains all four)
    model: str = "gcn"
    heads: int = 8
    attn_dropout: float = 0.0
    gin_eps: float = 0.0
    remat: bool = False

    def __post_init__(self):
        if self.model not in ("gcn", "gat", "sage", "gin"):
            raise ValueError(
                f"model must be gcn|gat|sage|gin, got {self.model!r}"
            )
        if self.heads < 1:
            raise ValueError(f"heads must be >= 1, got {self.heads}")
        if not 0.0 <= self.attn_dropout < 1.0:
            raise ValueError(
                f"attn_dropout must be in [0, 1), got {self.attn_dropout}"
            )
        if isinstance(self.hidden_dims, (int, float)):
            self.hidden_dims = (int(self.hidden_dims),)
        self.hidden_dims = tuple(int(h) for h in self.hidden_dims)
        if isinstance(self.dropouts, (int, float)):
            self.dropouts = (float(self.dropouts),)
        self.dropouts = tuple(float(d) for d in self.dropouts)
        if len(self.hidden_dims) != self.n_layers - 1:
            raise ValueError(
                f"need n_layers-1={self.n_layers - 1} hidden_dims, got {self.hidden_dims}"
            )
        if len(self.dropouts) != self.n_layers:
            raise ValueError(
                f"need n_layers={self.n_layers} dropouts, got {self.dropouts}"
            )


@dataclass
class AdamConfig:
    """Optimizer hyperparameters (reference: include/optim.cuh:16-19)."""

    learning_rate: float = 0.01
    weight_decay: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


@dataclass
class DataConfig:
    data_dir: str = ""  # resolved by data.parser.find_data_dir when empty
    binarize_features: bool = False  # -DNO_FEATURE (src/parser.cpp:100-104)


@dataclass
class TPUConfig:
    """Execution knobs (field names shared with the JAX package's config so
    the parameter files stay drop-in)."""

    backend: str = "auto"  # auto | dense | segment | bcsr | hybrid
    reorder: str = "none"  # none | rcm | community
    reorder_hub_block: int = 1024
    compute_dtype: str = "float32"  # float32 | bfloat16 (matmul inputs)
    # highest: no TF32 in f32 matmuls; default: TF32 allowed
    matmul_precision: str = "highest"
    dropout_impl: str = "auto"
    ce_impl: str = "auto"
    fuse_dropout_matmul: bool = False
    edge_chunk: int = 0  # segment-aggregation edge chunk (0 = auto)
    dense_threshold: int = 8192
    node_pad: int = 8
    # hoist the input layer's Â·X out of the epoch loop when input dropout
    # is 0 (exact rewrite; see train.preaggregate_input)
    input_preagg: bool = True
    tile_size: int = 128  # bcsr/hybrid tile rows (multiple of 128)
    tile_cols: int = 0  # tile columns (0 = square), multiple of tile_size
    # auto | float32 | bfloat16 | int8 (exact 0/1 pattern, scaled by d)
    tile_dtype: str = "auto"
    adj_dtype: str = "auto"  # dense-backend Â storage, same choices
    tile_budget_mb: int = 3072
    min_tile_nnz: int = 0
    n_devices: int = 0
    # the JAX package's guard of its whole-run GAT program; accepted, and
    # nothing to do in the port (a captured epoch holds the eager epoch's memory)
    gat_scan_check: bool = True
    halo: str = "all_gather"
    halo_fallback: bool = True
    tp: int = 1
    balance_slabs: bool = True
    seed: int = 19990304  # reference default seed (include/utils.cuh:22)

    def __post_init__(self):
        """Validate layout invariants; re-invoked by
        data.parser.prepare_device_dataset for configs mutated after
        construction."""
        if self.backend not in ("auto", "dense", "segment", "bcsr", "hybrid"):
            raise ValueError(
                "backend must be auto|dense|segment|bcsr|hybrid, "
                f"got {self.backend!r}"
            )
        if self.reorder not in ("none", "rcm", "community"):
            raise ValueError(
                f"reorder must be none|rcm|community, got {self.reorder!r}"
            )
        if self.tile_size % 128 != 0:
            raise ValueError(f"tile_size must be a multiple of 128, got {self.tile_size}")
        if self.tile_cols and self.tile_cols % self.tile_size != 0:
            raise ValueError(
                f"tile_cols ({self.tile_cols}) must be a multiple of "
                f"tile_size ({self.tile_size})"
            )
        if self.halo not in ("all_gather", "boundary", "adaptive", "ring"):
            raise ValueError(
                "halo must be all_gather|boundary|adaptive|ring, "
                f"got {self.halo!r}"
            )
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.edge_chunk < 0:
            raise ValueError(
                f"edge_chunk must be >= 0 (0 = auto/off), got {self.edge_chunk}"
            )
        if self.ce_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"ce_impl must be auto|xla|pallas, got {self.ce_impl!r}")
        if self.tile_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                "tile_dtype must be auto|float32|bfloat16|int8, "
                f"got {self.tile_dtype!r}"
            )
        if self.adj_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                "adj_dtype must be auto|float32|bfloat16|int8, "
                f"got {self.adj_dtype!r}"
            )


@dataclass
class TrainConfig:
    verbose: bool = True
    mode: str = "scan"  # scan (whole-run path, one CUDA graph an epoch) | eager
    checkpoint_dir: str = ""
    checkpoint_every: int = 0

    def __post_init__(self):
        if self.mode not in ("scan", "eager"):
            raise ValueError(
                f"train.mode must be 'scan' or 'eager', got {self.mode!r}"
            )


@dataclass
class Config:
    gcn: GCNConfig = field(default_factory=GCNConfig)
    adam: AdamConfig = field(default_factory=AdamConfig)
    data: DataConfig = field(default_factory=DataConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# reference CudaParams keys with no meaning here, accepted and ignored
_IGNORED_KEYS = {"num_blocks_factor", "num_threads"}

_KEYMAP = {
    "n_layers": ("gcn", "n_layers"),
    "hidden_dims": ("gcn", "hidden_dims"),
    "dropouts": ("gcn", "dropouts"),
    "epochs": ("gcn", "epochs"),
    "early_stopping": ("gcn", "early_stopping"),
    "residual": ("gcn", "residual"),
    "model": ("gcn", "model"),
    "heads": ("gcn", "heads"),
    "attn_dropout": ("gcn", "attn_dropout"),
    "gin_eps": ("gcn", "gin_eps"),
    "remat": ("gcn", "remat"),
    "learning_rate": ("adam", "learning_rate"),
    "weight_decay": ("adam", "weight_decay"),
    "beta1": ("adam", "beta1"),
    "beta2": ("adam", "beta2"),
    "eps": ("adam", "eps"),
    "seed": ("tpu", "seed"),
    "backend": ("tpu", "backend"),
    "reorder": ("tpu", "reorder"),
    "reorder_hub_block": ("tpu", "reorder_hub_block"),
    "tile_size": ("tpu", "tile_size"),
    "tile_budget_mb": ("tpu", "tile_budget_mb"),
    "tile_cols": ("tpu", "tile_cols"),
    "tile_dtype": ("tpu", "tile_dtype"),
    "adj_dtype": ("tpu", "adj_dtype"),
    "min_tile_nnz": ("tpu", "min_tile_nnz"),
    "n_devices": ("tpu", "n_devices"),
    "halo": ("tpu", "halo"),
    "halo_fallback": ("tpu", "halo_fallback"),
    "gat_scan_check": ("tpu", "gat_scan_check"),
    "tp": ("tpu", "tp"),
    "balance_slabs": ("tpu", "balance_slabs"),
    "input_preagg": ("tpu", "input_preagg"),
    "node_pad": ("tpu", "node_pad"),
    "compute_dtype": ("tpu", "compute_dtype"),
    "matmul_precision": ("tpu", "matmul_precision"),
    "dropout_impl": ("tpu", "dropout_impl"),
    "ce_impl": ("tpu", "ce_impl"),
    "fuse_dropout_matmul": ("tpu", "fuse_dropout_matmul"),
    "edge_chunk": ("tpu", "edge_chunk"),
    "dense_threshold": ("tpu", "dense_threshold"),
    "binarize_features": ("data", "binarize_features"),
    "data_dir": ("data", "data_dir"),
    "verbose": ("train", "verbose"),
    "mode": ("train", "mode"),
    "checkpoint_dir": ("train", "checkpoint_dir"),
    "checkpoint_every": ("train", "checkpoint_every"),
}

_SECTION_CLS = {
    "gcn": GCNConfig, "adam": AdamConfig, "data": DataConfig,
    "tpu": TPUConfig, "train": TrainConfig,
}


def _check_value_type(section: str, name: str, val):
    """Hard-error on type mismatches (``epochs=10O`` parses as a string);
    coerce accepted-but-mistyped values (``epochs=50.0`` becomes int 50).
    Field annotations are strings under ``from __future__ import
    annotations``, so match on the text."""
    ftype = {f.name: f.type for f in dataclasses.fields(_SECTION_CLS[section])}[name]
    is_num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
    if ftype == "int":
        ok = is_num(val) and float(val) == int(val)
        if ok:
            val = int(val)
    elif ftype == "float":
        ok = is_num(val)
        if ok:
            val = float(val)
    elif ftype == "bool":
        ok = isinstance(val, bool)
    elif ftype == "str":
        ok = isinstance(val, str)
    else:  # Sequence[int] / Sequence[float]: scalar or list of numbers
        vals = val if isinstance(val, (list, tuple)) else [val]
        ok = len(vals) > 0 and all(is_num(v) for v in vals)
    if not ok:
        raise ValueError(
            f"config key {name}={val!r} is not a valid {ftype}"
        )
    return val


def parse_override(value: str):
    """Parse one CLI override VALUE: a comma list becomes a list of
    scalars, otherwise one scalar."""
    if "," in value:
        return [_parse_scalar(v) for v in value.split(",")]
    return _parse_scalar(value)


def load_config(path: str, overrides: dict | None = None) -> Config:
    """Build a Config from a key=value file plus optional overrides."""
    raw = parse_keyvalue_file(path)
    if overrides:
        raw.update(overrides)

    sections = {"gcn": {}, "adam": {}, "data": {}, "tpu": {}, "train": {}}
    for key, val in raw.items():
        if key in _IGNORED_KEYS:
            continue
        if key not in _KEYMAP:
            raise KeyError(f"unknown config key {key!r} in {path}")
        section, name = _KEYMAP[key]
        sections[section][name] = _check_value_type(section, name, val)

    return Config(
        gcn=GCNConfig(**sections["gcn"]),
        adam=AdamConfig(**sections["adam"]),
        data=DataConfig(**sections["data"]),
        tpu=TPUConfig(**sections["tpu"]),
        train=TrainConfig(**sections["train"]),
    )


def default_params_path(dataset: str) -> str:
    """Locate parameters/parameters_<dataset>.txt at the repo root."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(here, "parameters", f"parameters_{dataset}.txt")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(f"no parameters file for dataset {dataset!r} at {cand}")
