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


def paged_decode_split_ref(q: torch.Tensor, arena_k: torch.Tensor,
                           arena_v: torch.Tensor, page_ids: torch.Tensor,
                           slot_pos: torch.Tensor, *, layer: int,
                           rope_theta: float,
                           pages_per_split: int) -> torch.Tensor:
    """The CUDA kernel's split-K arithmetic in plain PyTorch (for tests and
    the card checks; the wrapper never calls it).  The page columns run in
    splits of `pages_per_split`; each split s gives fp32 partials m_s (its
    largest live score, or NEG_INF), l_s (sum of e^(score - m_s) over live
    slots) and acc_s (those probabilities rounded to the arena dtype, times
    V), merged as m* = max m_s, l = sum l_s e^(m_s - m*), o = sum acc_s
    e^(m_s - m*) / max(l, 1e-30).  Keys, scores and masking are
    `paged_decode_ref`'s.  Probabilities are rounded relative to their
    split's maximum, not the row's.  -> (N, Hq, Dh) in q's dtype."""
    n, pmax = page_ids.shape
    page = arena_k.shape[1]
    hkv, d = arena_k.shape[3], arena_k.shape[4]
    g = q.shape[1] // hkv
    qr = q.float().reshape(n, hkv, g, d)
    ms, ls, accs = [], [], []
    for c0 in range(0, pmax, pages_per_split):
        cols = slice(c0, min(c0 + pages_per_split, pmax))
        flat = page_ids[:, cols].reshape(-1).long()
        t = flat.numel() // n * page
        kg = arena_k[:, :, layer][flat].reshape(n, t, hkv, d)
        vg = arena_v[:, :, layer][flat].reshape(n, t, hkv, d)
        pos = slot_pos[:, cols].reshape(n, t)
        kg = rope_rotate(kg.float(), pos[:, :, None], rope_theta).to(q.dtype)
        live = (pos >= 0)[:, None, None, :]
        s = torch.einsum("nhgd,nshd->nhgs", qr, kg.float()) * (1.0 / d ** 0.5)
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m = s.max(dim=-1).values                                   # (n, hkv, g)
        p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
        ls.append(p.sum(dim=-1))
        pr = p.to(vg.dtype).float()
        accs.append(torch.einsum("nhgs,nshd->nhgd", pr, vg.float()))
        ms.append(m)
    m = torch.stack(ms)                                            # (S, n, hkv, g)
    w = torch.exp(m - m.max(dim=0).values)
    l_tot = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
    o = acc / torch.clamp(l_tot, min=1e-30)[..., None]
    return o.reshape(n, hkv * g, d).to(q.dtype)
