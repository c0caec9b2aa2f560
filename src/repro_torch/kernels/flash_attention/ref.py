"""Plain PyTorch versions of flash attention.

`flash_attention_ref` is the counterpart of the JAX oracle
(`repro/kernels/flash_attention/ref.py`): flattened (BH, S, D) heads, fp32
softmax.  `mha_flash_ref` is the function the CUDA kernel computes, in the
wrapper's layout, with the kernel's numerics: fp32 scores, the finite
mask constant, probabilities rounded to the value dtype before PV, fp32
accumulation, output in the query dtype.  GQA by index (a reshape of the
query heads), never by copying K/V.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Skv, D)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / d ** 0.5
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def mask_rows(nb: int, b: int, hq: int, device) -> torch.Tensor:
    """(B, Hq) index of the mask row each flattened head row b*Hq+h
    reads: (b*Hq + h) * NB // (B*Hq), as the TPU kernels' BlockSpecs."""
    flat = (torch.arange(b, device=device)[:, None] * hq
            + torch.arange(hq, device=device)[None, :])
    return flat * nb // (b * hq)


def mha_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  kv_valid: Optional[torch.Tensor] = None,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); kv_valid: optional
    (NB, Skv) key mask, NB dividing B*Hq.  -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qr = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * (1.0 / D ** 0.5)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
    mask = mask[None, None, None]
    if kv_valid is not None:
        rows = mask_rows(kv_valid.shape[0], B, Hq, q.device)
        km = kv_valid.bool()[rows]                          # (B, Hq, Skv)
        mask = mask & km.reshape(B, Hkv, G, 1, Skv)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
