"""Weight bridge: the JAX package's SchNet parameter pytree (numpy leaves;
`interactions` a list of dicts, as `repro.gnn.schnet.init_params` builds
it) -> the port's `SchNet`.  torch cannot reproduce JAX's PRNG, so parity
tests build weights with the reference and convert them here (the caller
does `jax.tree_util.tree_map(np.asarray, params)`)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.gnn import schnet as G
from repro_torch.recsys.convert import _tensors


def schnet_params_from_numpy(tree: Dict, cfg: GNNConfig, device="cuda",
                             d_feat: Optional[int] = None,
                             n_classes: Optional[int] = None) -> G.SchNet:
    """The reference's parameters as the port's model on `device`; the tree
    must hold exactly the leaves, of exactly the shapes, that the port's
    init builds for `cfg` (graph regime when `d_feat` is given)."""
    model = G.SchNet(cfg, _tensors(tree, torch.float32, device))
    want = G.param_shapes(G.init_params(cfg, None, "meta", d_feat, n_classes))
    if G.param_shapes(model) != want:
        raise ValueError(f"{cfg.name}: parameter tree {G.param_shapes(model)} does not "
                         f"match the config's {want}")
    return model
