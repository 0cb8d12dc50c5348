"""What the harnesses share: arguments, config, data and the device stamp."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

from parallel_gcn_tpu_torch.config import Config, default_params_path, load_config, parse_override
from parallel_gcn_tpu_torch.device import device_name


def add_common(ap: argparse.ArgumentParser) -> None:
    """``--device`` (cuda, the default, or cpu) and ``--out-dir``."""
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="output", help="where the results file goes")


def overrides(pairs: list[str]) -> dict:
    """``key=value`` arguments as config overrides."""
    out = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        out[key] = parse_override(val)
    return out


def config(dataset: str, over: dict | None = None) -> Config:
    """``parameters/parameters_<dataset>.txt`` with ``over`` applied."""
    return load_config(default_params_path(dataset), over)


def card(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (``cpu`` on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or device_name(dev)


def stamp(dev: torch.device) -> dict:
    """A row's device fields: ``device`` (cuda or cpu) and ``card``."""
    return {"device": dev.type, "card": card(dev)}


def write(out_dir: str, name: str, lines: list[str]) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return path


def unavailable(name: str) -> None:
    print(f"[{name}] dataset unavailable, skipping", file=sys.stderr)
