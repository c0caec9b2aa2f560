"""Plain PyTorch versions of selective attention.

`selective_attention_ref` is the counterpart of the JAX oracle
(`repro/kernels/selective_attention/ref.py`): flattened (BH, R, D) heads,
one shared position/heavy-hitter row.  `selective_mha_ref` is the
function the CUDA kernel computes, in the wrapper's layout and with the
kernel's numerics (fp32 scores, finite mask constant, probabilities
rounded to the value dtype, output in the query dtype).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, mask_rows


def selective_attention_ref(q, q_positions, k, v, hh_mask, *,
                            window: int = 256) -> torch.Tensor:
    """q: (BH, R, D), q_positions: (R,), k/v: (BH, S, D), hh_mask: (S,).
    Attend where causal AND (within window OR heavy-hitter)."""
    d = q.shape[-1]
    s_len = k.shape[1]
    s = torch.einsum("brd,bkd->brk", q.float(), k.float()) / d ** 0.5
    k_pos = torch.arange(s_len, device=q.device)
    qp = q_positions.to(q.device)
    causal = qp[:, None] >= k_pos[None, :]
    in_window = causal & (qp[:, None] - k_pos[None, :] < window)
    valid = causal & (in_window | (hh_mask.to(q.device)[None, :] > 0))
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("brk,bkd->brd", p, v.float()).to(q.dtype)


def selective_mha_ref(q: torch.Tensor, q_positions: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, hh_mask: torch.Tensor,
                      *, window: int = 256) -> torch.Tensor:
    """q: (B, R, Hq, D); k, v: (B, S, Hkv, D); q_positions: (R,) or
    (NB, R) (-1 = pad row); hh_mask: (S,) or (NB, S); NB divides B*Hq.
    -> (B, R, Hq, D)."""
    B, R, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qp = q_positions if q_positions.dim() == 2 else q_positions[None]
    hh = hh_mask if hh_mask.dim() == 2 else hh_mask[None]
    rows = mask_rows(qp.shape[0], B, Hq, q.device)          # (B, Hq)
    qp = qp.to(q.device).long()[rows].reshape(B, Hkv, G, R, 1)
    hh = (hh.to(q.device)[rows] > 0).reshape(B, Hkv, G, 1, S)
    k_pos = torch.arange(S, device=q.device)
    causal = qp >= k_pos
    valid = causal & ((qp - k_pos < window) | hh)
    qr = q.float().reshape(B, R, Hkv, G, D)
    s = torch.einsum("brhgd,bkhd->bhgrk", qr, k.float()) * (1.0 / D ** 0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhgrk,bkhd->brhgd", p, v.float())
    return o.reshape(B, R, Hq, D).to(q.dtype)
