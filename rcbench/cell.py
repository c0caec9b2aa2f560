"""A cell of `BENCHMARK.json`: its configuration file, its traffic file
and its limits, found by name under this folder."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the MLP nonlinearity as a published config names it -> the port's
MLP_TYPES = {"silu": "swiglu", "relu2": "relu2"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[dict]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell `workload` of `BENCHMARK.json` (or of `bench`)."""
    if bench is None:
        bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(ROOT / cfg_entry["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    lim_path = HERE / "limits" / f"{workload}.json"
    limits = read_json(lim_path) if lim_path.exists() else None
    return Cell(workload, int(w["chips"]), config, traffic, limits)


def lm_config(config: dict):
    """The port's `LMConfig` for a configuration file."""
    from repro_torch.configs.base import LMConfig

    return LMConfig(
        name=config["name"], n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        mlp_type=MLP_TYPES[config["hidden_act"]], rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]), dtype=config["torch_dtype"],
        tie_embeddings=bool(config["tie_word_embeddings"]))
