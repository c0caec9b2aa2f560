"""Plain PyTorch versions of the fused paged-decode attention.

`masked_decode_attention_ref` is the GQA masked-softmax decode attention
(the JAX package's `paged_attention/ref.py` body: fp32 scores, the finite
`NEG_INF` mask, probabilities in the value dtype).  `paged_decode_ref`
gathers the referenced physical pages, rotates the pre-RoPE keys to
their logical positions, rounds them to the query dtype as the TPU
kernel does (`kernel.py:84`), and runs that body over the flattened
(page, slot) axis — attention is permutation-invariant over keys.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.block_gather.ref import rope_rotate

# large enough that exp underflows to exactly 0.0 in fp32, small enough
# not to overflow to -inf when scores are added to it
NEG_INF = -1e30


def masked_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                kv_valid: torch.Tensor) -> torch.Tensor:
    """q: (N, Hq, Dh); k, v: (N, T, Hkv, Dh); kv_valid: (N, T) bool.
    -> (N, Hq, Dh) in q's dtype."""
    n, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qr = q.float().reshape(n, hkv, g, d)
    s = torch.einsum("nhgd,nshd->nhgs", qr, k.float())
    s = torch.where(kv_valid[:, None, None, :], s * (1.0 / d ** 0.5),
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("nhgs,nshd->nhgd", p, v.float())
    return o.reshape(n, hq, d).to(q.dtype)


def paged_decode_ref(q: torch.Tensor, arena_k: torch.Tensor,
                     arena_v: torch.Tensor, page_ids: torch.Tensor,
                     slot_pos: torch.Tensor, *, layer: int,
                     rope_theta: float) -> torch.Tensor:
    """q: (N, Hq, Dh) post-RoPE queries; arena_k/arena_v: (P, page, L,
    Hkv, Dh) (keys pre-RoPE); page_ids: (N, Pmax); slot_pos: (N, Pmax,
    page) logical position per slot or -1.  -> (N, Hq, Dh)."""
    n, pmax = page_ids.shape
    page = arena_k.shape[1]
    hkv, d = arena_k.shape[3], arena_k.shape[4]
    flat = page_ids.reshape(-1).long()
    kg = arena_k[:, :, layer][flat].reshape(n, pmax * page, hkv, d)
    vg = arena_v[:, :, layer][flat].reshape(n, pmax * page, hkv, d)
    pos = slot_pos.reshape(n, pmax * page)
    kg = rope_rotate(kg.float(), pos[:, :, None], rope_theta).to(q.dtype)
    return masked_decode_attention_ref(q, kg, vg, pos >= 0)
