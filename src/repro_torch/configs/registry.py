"""Architecture registry of the port: the four recsys architectures of the
JAX package's `configs/registry.py`, their input-shape cells, and
`make_batch`, which fills one cell's inputs (the shapes and dtypes of the
reference's `input_specs`) with seeded random values."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs import autoint, bert4rec, dien, wide_deep
from repro_torch.configs.base import RecsysConfig, reduced
from repro_torch.recsys.embedding import mega_table_rows, pad_rows

ARCHS: Dict[str, RecsysConfig] = {
    "dien": dien.CONFIG,
    "wide-deep": wide_deep.CONFIG,
    "autoint": autoint.CONFIG,
    "bert4rec": bert4rec.CONFIG,
}


def family_of(arch: str) -> str:
    if isinstance(ARCHS[arch], RecsysConfig):
        return "recsys"
    raise KeyError(arch)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str            # train | score | retrieval
    dims: Dict[str, int]


RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "score", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "score", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}


def get_config(arch: str, smoke: bool = False) -> RecsysConfig:
    cfg = ARCHS[arch]
    return reduced(cfg) if smoke else cfg


def retrieval_rows(cfg: RecsysConfig) -> int:
    """Rows of the table retrieval scores against: the mega-table for the
    CTR models, the item table for the sequential ones."""
    if cfg.kind == "dien":
        return pad_rows(cfg.n_items)
    if cfg.kind == "bert4rec":
        return pad_rows(cfg.n_items + 2)
    return mega_table_rows(cfg.field_vocabs)


def make_batch(cfg: RecsysConfig, shape_name: str, generator: torch.Generator,
               device="cuda", batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One cell's inputs, drawn from `generator` on its own device and
    moved to `device`: ids uniform over each field's vocabulary (or over
    the items and categories), ragged valid lengths of at least one
    position, candidates uniform over the retrieval table's rows.
    `batch` replaces the cell's batch size; nothing else changes."""
    spec = RECSYS_SHAPES[shape_name]
    if spec.step == "train":
        raise ValueError(f"{shape_name}: the train step waits for the training slice")
    b = spec.dims["batch"] if batch is None else batch
    kw = dict(generator=generator, device=generator.device)

    def ids(high: int, *shape: int) -> torch.Tensor:
        return torch.randint(0, high, shape, dtype=torch.int32, **kw)

    def prefix_mask(T: int) -> torch.Tensor:
        lens = torch.randint(1, T + 1, (b, 1), **kw)
        return torch.arange(T, device=generator.device)[None] < lens

    out: Dict[str, torch.Tensor] = {}
    if cfg.kind in ("wide_deep", "autoint"):
        out["dense"] = torch.randn(b, cfg.n_dense, **kw)
        out["sparse_ids"] = torch.stack([ids(v, b) for v in cfg.field_vocabs], dim=1)
    elif cfg.kind == "dien":
        T = cfg.seq_len
        out.update(hist_items=ids(cfg.n_items, b, T), hist_cates=ids(cfg.n_cates, b, T),
                   hist_mask=prefix_mask(T), target_item=ids(cfg.n_items, b),
                   target_cate=ids(cfg.n_cates, b))
    elif cfg.kind == "bert4rec":
        out.update(item_seq=ids(cfg.n_items, b, cfg.seq_len),
                   seq_mask=prefix_mask(cfg.seq_len))
    else:
        raise ValueError(cfg.kind)
    if spec.step == "retrieval":
        out["candidate_ids"] = ids(retrieval_rows(cfg), spec.dims["n_candidates"])
    return {k: v.to(device) for k, v in out.items()}
