"""The model's weights, drawn on the device from the run's seed.

One `normal_` call fills one flat buffer of every matrix in the served
dtype, and each matrix is a view of it scaled to its init scale; the
norms' scales are a second, small buffer.  The benchmark hands the same
tensors to the port (`port_model`) and, once the port is freed, to the
plain reference."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MLP_MATS = {"silu": ("w_gate", "w_up", "w_down"), "relu2": ("w_up", "w_down")}
NORM_STD = 0.1


def shapes(config: dict) -> Tuple[List[Tuple[str, tuple, float]], List[str]]:
    """-> ([(name, shape, std)] of the matrices, [names of the norm scales])."""
    D, F = config["hidden_size"], config["intermediate_size"]
    H, Hkv, dh = (config["num_attention_heads"], config["num_key_value_heads"],
                  config["head_dim"])
    V, L = config["vocab_size"], config["num_hidden_layers"]
    mats = [("embed", (V, D), 1.0)]
    norms = []
    for i in range(L):
        p = f"layers.{i}."
        mats += [(p + "wq", (D, H, dh), D ** -0.5), (p + "wk", (D, Hkv, dh), D ** -0.5),
                 (p + "wv", (D, Hkv, dh), D ** -0.5), (p + "wo", (H, dh, D), (H * dh) ** -0.5)]
        for m in MLP_MATS[config["hidden_act"]]:
            shape = (F, D) if m == "w_down" else (D, F)
            mats.append((p + "mlp." + m, shape, F ** -0.5 if m == "w_down" else D ** -0.5))
        norms += [p + "attn_norm", p + "mlp_norm"]
    norms.append("final_norm")
    if not config["tie_word_embeddings"]:
        mats.append(("lm_head", (D, V), D ** -0.5))
    return mats, norms


@torch.no_grad()
def draw(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of `config` from `seed`, on `device`, in the config's
    dtype: {port parameter name: tensor}."""
    dtype = getattr(torch, config["torch_dtype"])
    mats, norms = shapes(config)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    n = sum(torch.Size(s).numel() for _, s, _ in mats)
    flat = torch.empty(n, dtype=dtype, device=device).normal_(generator=gen)
    out, off = {}, 0
    for name, shape, std in mats:
        k = torch.Size(shape).numel()
        out[name] = flat[off:off + k].view(shape)
        if std != 1.0:
            out[name].mul_(std)
        off += k
    D = config["hidden_size"]
    scales = torch.empty(len(norms) * D, dtype=dtype, device=device).normal_(generator=gen)
    scales.mul_(NORM_STD)
    for i, name in enumerate(norms):
        out[name] = scales[i * D:(i + 1) * D]
    return out


def port_model(cfg, weights: Dict[str, torch.Tensor]):
    """The port's `Transformer` over the drawn tensors (no copy)."""
    from torch import nn

    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device="meta")
    for name, t in weights.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = nn.Parameter(t, requires_grad=False)
        else:
            setattr(mod, leaf, nn.Parameter(t, requires_grad=False))
    left = [n for n, p in model.named_parameters() if p.device.type == "meta"]
    if left:
        raise ValueError(f"no drawn weight for {left[:4]}")
    return model
