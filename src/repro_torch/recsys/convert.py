"""Weight bridge: the JAX package's recsys parameter pytree (numpy leaves;
dicts, and lists of dicts for `deep`, `attn`, `blocks` and `mlp`, as
`repro.recsys.models.init_params` builds them) -> the port's
`RecsysModel`.

torch cannot reproduce JAX's PRNG, so parity tests build weights with the
reference and convert them here.  The tree arrives as plain numpy (the
caller does `jax.tree_util.tree_map(np.asarray, params)`)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.recsys import models as M


def _tensors(tree: Any, dtype: torch.dtype, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, dtype, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device=device, dtype=dtype)


def _shapes(model: torch.nn.Module) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def recsys_params_from_numpy(tree: Dict, cfg: RecsysConfig, device="cuda") -> M.RecsysModel:
    """The reference's parameters as the port's model on `device`; the
    tree must hold exactly the leaves, of exactly the shapes, that the
    port's init builds for `cfg`."""
    model = M.RecsysModel(cfg, _tensors(tree, getattr(torch, cfg.dtype), device))
    want = _shapes(M.init_params(cfg, None, device="meta"))
    if _shapes(model) != want:
        raise ValueError(f"{cfg.name}: parameter tree {_shapes(model)} does not match "
                         f"the config's {want}")
    return model
