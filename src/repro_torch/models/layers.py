"""Transformer building blocks for the port: RMSNorm, half-split RoPE and
the dense MLPs, with the JAX package's numerics (`repro/models/layers.py`):
fp32 normalisation with the `(1 + scale)` factor, fp32 rotation cast back
to the input dtype, and the same parameter layouts."""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  Half-split
    rotation (x1 = first half, x2 = second half), computed in fp32."""
    d = x.shape[-1]
    positions = torch.as_tensor(positions, device=x.device)
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_realign(k: torch.Tensor, delta, theta: float) -> torch.Tensor:
    """Rotate cached keys by a position delta (RcLLM §III-C3 'Alignment'):
    R(p+d) = R(d) R(p).  k: (..., S, H, D); delta: scalar or (...,)."""
    s = k.shape[-3]
    delta = torch.as_tensor(delta, dtype=torch.float32, device=k.device)
    pos = torch.zeros((s,), dtype=torch.float32, device=k.device) + delta[..., None]
    return apply_rope(k, pos, theta)


def mlp_apply(x: torch.Tensor, params: Mapping[str, torch.Tensor],
              mlp_type: str) -> torch.Tensor:
    if mlp_type in ("swiglu", "geglu"):
        g = x @ params["w_gate"]
        g = F.silu(g) if mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        return (g * (x @ params["w_up"])) @ params["w_down"]
    h = x @ params["w_up"]
    if mlp_type == "relu2":
        h = torch.square(F.relu(h))
    elif mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ params["w_down"]


def _normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device).mul_(std)


def mlp_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             mlp_type: str, dtype, device=None) -> dict:
    std_in = d_model ** -0.5
    std_out = d_ff ** -0.5
    p = {"w_up": _normal((d_model, d_ff), std_in, dtype, device, generator),
         "w_down": _normal((d_ff, d_model), std_out, dtype, device, generator)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _normal((d_model, d_ff), std_in, dtype, device, generator)
    return p
