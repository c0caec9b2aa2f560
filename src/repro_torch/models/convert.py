"""Weight bridge: the JAX package's parameter pytree (numpy leaves, layer
parameters stacked on a leading axis, as `repro.models.transformer.
init_params` builds them) -> the port's `Transformer` module.

torch cannot reproduce JAX's PRNG, so parity tests build weights with
the reference and convert them here.  The tree arrives as plain numpy
(the caller does `jax.tree_util.tree_map(np.asarray, params)`); bf16
leaves (numpy's ml_dtypes extension type) pass through fp32, exactly.
An MoE layer's stacked (L, E, ...) experts are split per layer; its
router stays fp32; a model with tied embeddings has no `lm_head`."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import Transformer


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


@torch.no_grad()
def params_from_numpy(tree: Mapping, cfg: LMConfig, device="cuda") -> Transformer:
    dt = cfg.torch_dtype
    model = Transformer(cfg, device=device)
    model.embed.copy_(_tensor(tree["embed"], dt, device))
    model.final_norm.copy_(_tensor(tree["final_norm"], dt, device))
    if model.lm_head is not None:
        model.lm_head.copy_(_tensor(tree["lm_head"], dt, device))
    layers = tree["layers"]
    for i, blk in enumerate(model.layers):
        for name in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo"):
            getattr(blk, name).copy_(_tensor(np.asarray(layers[name])[i], dt, device))
        ffn = "moe" if cfg.moe is not None else "mlp"
        for name, p in getattr(blk, ffn).items():
            p.copy_(_tensor(np.asarray(layers[ffn][name])[i], p.dtype, device))
    return model
