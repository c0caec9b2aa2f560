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


def band_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) live pairs at these absolute positions, as the
    reference's `_flash_bwd.tile_mask`: causal `qpos >= kpos` and, with a
    window, `qpos - kpos < window`; not causal `|qpos - kpos| < window`."""
    d = qpos[:, None] - kpos[None, :]
    mask = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
    if window is not None:
        mask = mask & ((d if causal else d.abs()) < window)
    return mask


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, q_positions, kv_positions, *,
                  causal: bool = True, window: Optional[int] = None, q_chunk: int = 512,
                  kv_chunk: int = 1024):
    """The JAX package's `_flash_bwd` (`repro/models/layers.py:249`), tile
    for tile: q, out, dout (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); lse
    (B, Sq, Hq) fp32; positions (Sq,), (Skv,).  -> (dq, dk, dv) in the
    inputs' dtypes.

    delta = rowsum(dout * out) in fp32; per (q chunk, kv chunk) tile,
    p = exp(s * scale - lse) on the live pairs (0 elsewhere), dV += p cast
    to dout's dtype times dout, dS = p (dout . v - delta) scale, dQ += dS
    cast to k's dtype times k, dK += dS cast to q's dtype times q, all
    accumulated in fp32.  dQ sums its kv chunks and dK / dV their q chunks
    in the reference's order; a tile with no live pair adds exactly 0 and
    is skipped (the reference's `block_pairing` skips the same tiles).
    Every query row must see at least one key (causal self-attention
    does): the reference gives a row with none p = 1 on every key."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    qpos = torch.as_tensor(q_positions, device=dev).long()
    kpos = torch.as_tensor(kv_positions, device=dev).long()
    delta = (dout.float() * out.float()).sum(-1).reshape(B, Sq, Hkv, G)
    lse4 = lse.float().reshape(B, Sq, Hkv, G)
    qr = q.reshape(B, Sq, Hkv, G, D)
    dor = dout.reshape(B, Sq, Hkv, G, D)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for i0 in range(0, Sq, q_chunk):
        i1 = min(Sq, i0 + q_chunk)
        qc, doc = qr[:, i0:i1].float(), dor[:, i0:i1].float()
        lse_t = lse4[:, i0:i1].permute(0, 2, 3, 1)[..., None]        # (B, h, g, q, 1)
        dl_t = delta[:, i0:i1].permute(0, 2, 3, 1)[..., None]
        for j0 in range(0, Skv, kv_chunk):
            j1 = min(Skv, j0 + kv_chunk)
            mask = band_mask(qpos[i0:i1], kpos[j0:j1], causal, window)
            if not bool(mask.any()):
                continue
            kc, vc = k[:, j0:j1].float(), v[:, j0:j1].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            p = torch.where(mask, torch.exp(s - lse_t), torch.zeros_like(s))
            dv[:, j0:j1] += torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(), doc)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc)
            ds = p * (dp - dl_t) * scale
            dq[:, i0:i1] += torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), kc)
            dk[:, j0:j1] += torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qc)
            del s, p, dp, ds
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
