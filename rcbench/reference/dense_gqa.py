"""Plain PyTorch reference of RcLLM serving on a dense decoder with
grouped-query attention (Qwen3-8B and Nemotron-4-15B as the port runs
them: pre-norm RMSNorm with (1 + scale), half-split RoPE, SwiGLU or
squared-ReLU MLP, untied head), in float32 with TF32 off.

It works out everything the served path derives for itself, from the
benchmark's inputs and weights alone:

- the offline KV: every needed item block ([ITEM_SEP] + the item's
  tokens at positions 0..) and corpus document prefix, pre-RoPE keys and
  values at every layer;
- layer 0 over the whole prompt, with Eq. 3's attention mass and K/V
  divergence against the cached layer-0 rows, and the recompute set;
- the assembly: cached rows at the tokens not recomputed, their keys
  rotated to the prompt positions;
- layers 1..L-1 over the recompute set and the served tokens (the decode
  steps: each served token attends over the assembled prompt and the
  served tokens before it);
- the logits at the prompt's last position and at each decode position.

Work runs layer by layer over every document and request at once, each
layer's weights cast to float32 when it runs, so the card holds the
served weights and one layer in float32.  `precision="fp8"` is the
control: every matrix product rounds its weights (per output column) and
its inputs (per row) to float8 e4m3 first."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from rcbench.reference import semantic as SEM

FP8_MAX = 448.0
KV0_ROWS = 64


def _fq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@dataclass
class Request:
    """One request to judge: its reference plan, the served tokens, and
    (optionally) a recompute mask to use instead of the reference's own."""
    plan: SEM.Plan
    served: np.ndarray
    mask: Optional[np.ndarray] = None


class Reference:
    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], device,
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.c = config
        self.w = weights
        self.dev = torch.device(device)
        self.fp8 = precision == "fp8"
        self.L = config["num_hidden_layers"]
        self.H = config["num_attention_heads"]
        self.Hkv = config["num_key_value_heads"]
        self.dh = config["head_dim"]
        self.eps = float(config["rms_norm_eps"])
        self.theta = float(config["rope_theta"])
        self.act = config["hidden_act"]
        self._layer: Dict[str, torch.Tensor] = {}
        self._at = -1

    # ------------------------------------------------------------ weights
    def _f32(self, name: str, cols: int) -> torch.Tensor:
        w = self.w[name].to(torch.float32).reshape(-1, cols)
        return _fq(w, 0) if self.fp8 else w

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer `l`'s weights as float32 matrices (cast once per layer)."""
        if l != self._at:
            p = f"layers.{l}."
            D = self.c["hidden_size"]
            self._layer = {
                "wq": self._f32(p + "wq", self.H * self.dh),
                "wk": self._f32(p + "wk", self.Hkv * self.dh),
                "wv": self._f32(p + "wv", self.Hkv * self.dh),
                "wo": self._f32(p + "wo", D),
                "attn_norm": self.w[p + "attn_norm"].float(),
                "mlp_norm": self.w[p + "mlp_norm"].float(),
            }
            for m in ("w_gate", "w_up", "w_down"):
                if p + "mlp." + m in self.w:
                    t = self.w[p + "mlp." + m]
                    self._layer[m] = self._f32(p + "mlp." + m, t.shape[1])
            self._at = l
        return self._layer

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fq(x, -1) if self.fp8 else x) @ w

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * (1.0 + scale)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Half-split rotation of x (S, h, dh) to positions `pos` (S,)."""
        half = self.dh // 2
        freqs = 1.0 / self.theta ** (torch.arange(0, self.dh, 2, dtype=torch.float64,
                                                  device=x.device) / self.dh)
        ang = pos.to(torch.float64)[:, None] * freqs[None, :]
        cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def mlp(self, h: torch.Tensor, lw) -> torch.Tensor:
        if self.act == "silu":
            return self.mm(F.silu(self.mm(h, lw["w_gate"])) * self.mm(h, lw["w_up"]), lw["w_down"])
        return self.mm(torch.square(F.relu(self.mm(h, lw["w_up"]))), lw["w_down"])

    def attend(self, q, k, v, qpos, kpos, kvalid=None, want_mass=None):
        """q (Sq, H, dh) against k, v (Sk, Hkv, dh), causal by position.
        -> (o (Sq, H * dh), attention mass each key gets from the queries
        `want_mass` selects, mean over heads (or None))."""
        G = self.H // self.Hkv
        qg = q.reshape(q.shape[0], self.Hkv, G, self.dh)
        s = torch.einsum("qhgd,khd->hgqk", qg, k) / self.dh ** 0.5
        ok = kpos[None, :] <= qpos[:, None]
        if kvalid is not None:
            ok = ok & kvalid[None, :]
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        mass = None
        if want_mass is not None:
            mass = p[:, :, want_mass].sum(dim=2).mean(dim=(0, 1))
        o = torch.einsum("hgqk,khd->qhgd", p, v)
        return o.reshape(q.shape[0], self.H * self.dh), mass

    def attend_batch(self, q, k, v, valid):
        """Causal attention of B padded documents: q (B, S, H, dh), k, v
        (B, S, Hkv, dh), valid (B, S).  -> (B, S, H * dh)."""
        B, S = q.shape[:2]
        G = self.H // self.Hkv
        qg = q.reshape(B, S, self.Hkv, G, self.dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / self.dh ** 0.5
        pos = torch.arange(S, device=q.device)
        ok = (pos[None, :] <= pos[:, None])[None] & valid[:, None, :]
        s = s.masked_fill(~ok[:, None, None], float("-inf"))
        o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
        return o.reshape(B, S, self.H * self.dh)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.rms(x, self.w["final_norm"].float())
        lm = self.w["lm_head"] if "lm_head" in self.w else self.w["embed"].T
        w = lm.float()
        return self.mm(x, _fq(w, 0) if self.fp8 else w)

    # ------------------------------------------------------------ layer 0
    def kv0(self, ids: torch.Tensor):
        """Pre-RoPE layer-0 K, V of token ids (any shape): functions of the
        id alone, from products of one fixed shape over the distinct ids
        (a product's row then does not depend on the other rows), so a
        token's rows are bitwise the same wherever it appears."""
        uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
        lw = self.layer(0)
        pad = F.pad(uniq, (0, (-len(uniq)) % KV0_ROWS))
        ks, vs = [], []
        for chunk in pad.split(KV0_ROWS):
            h = self.rms(self.w["embed"][chunk].float(), lw["attn_norm"])
            ks.append(self.mm(h, lw["wk"]))
            vs.append(self.mm(h, lw["wv"]))
        k = torch.cat(ks)[:len(uniq)].reshape(-1, self.Hkv, self.dh)
        v = torch.cat(vs)[:len(uniq)].reshape(-1, self.Hkv, self.dh)
        shape = tuple(ids.shape) + (self.Hkv, self.dh)
        return k[inv].reshape(shape), v[inv].reshape(shape)

    # --------------------------------------------------------- offline KV
    @torch.no_grad()
    def doc_kv(self, docs: List[np.ndarray], keep: List[np.ndarray]):
        """Each document's forward pass from position 0; -> (k, v) each
        (sum of len(keep), L, Hkv, dh): the pre-RoPE rows at every layer of
        the positions `keep[i]` of document i, in order."""
        dev = self.dev
        order = sorted(range(len(docs)), key=lambda i: len(docs[i]))
        groups = [order[i:i + 64] for i in range(0, len(order), 64)]
        state = []
        for g in groups:
            S = max(len(docs[i]) for i in g)
            toks = np.zeros((len(g), S), np.int64)
            valid = np.zeros((len(g), S), bool)
            for j, i in enumerate(g):
                toks[j, :len(docs[i])] = docs[i]
                valid[j, :len(docs[i])] = True
            t = torch.from_numpy(toks).to(dev)
            state.append((g, t, torch.from_numpy(valid).to(dev),
                          self.w["embed"][t].float()))
        n_keep = sum(len(k) for k in keep)
        K = torch.empty((n_keep, self.L, self.Hkv, self.dh), device=dev)
        V = torch.empty_like(K)
        start = np.cumsum([0] + [len(k) for k in keep])
        for l in range(self.L):
            lw = self.layer(l)
            for gi, (g, t, valid, x) in enumerate(state):
                B, S = t.shape
                pos = torch.arange(S, device=dev)
                h = self.rms(x, lw["attn_norm"])
                q = self.mm(h, lw["wq"]).reshape(B, S, self.H, self.dh)
                if l == 0:
                    k, v = self.kv0(t)
                else:
                    k = self.mm(h, lw["wk"]).reshape(B, S, self.Hkv, self.dh)
                    v = self.mm(h, lw["wv"]).reshape(B, S, self.Hkv, self.dh)
                for j, i in enumerate(g):
                    idx = torch.from_numpy(np.asarray(keep[i], np.int64)).to(dev)
                    K[start[i]:start[i + 1], l] = k[j, idx]
                    V[start[i]:start[i + 1], l] = v[j, idx]
                if l == self.L - 1:
                    continue
                o = self.attend_batch(self.rope(q, pos), self.rope(k, pos), v, valid)
                x = x + self.mm(o, lw["wo"])
                x = x + self.mlp(self.rms(x, lw["mlp_norm"]), lw)
                state[gi] = (g, t, valid, x)
        return K, V

    # ----------------------------------------------------------- serving
    @torch.no_grad()
    def serve(self, reqs: Sequence[Request], catalog, corpus: List[np.ndarray],
              protos: SEM.Prototypes, r_item: float, r_rev: float) -> List[dict]:
        """The logits the served path should give each request, at its
        prompt's last position and at each decode position.  -> per
        request {"logits": (n_out, V) fp32 on the device, "own_mask": the
        reference's own recompute set}."""
        dev = self.dev
        # the offline rows every request reads: item blocks, prototypes
        items = sorted({int(i) for r in reqs for i in np.unique(r.plan.item[r.plan.item >= 0])})
        pids = sorted({int(p) for r in reqs for p in np.unique(r.plan.proto[r.plan.proto >= 0])})
        docs, keep = [], []
        item_row = {}
        for it in items:
            d = np.concatenate([[2], catalog.item_tokens[it]]).astype(np.int64)
            item_row[it] = sum(len(k) for k in keep)
            docs.append(d)
            keep.append(np.arange(len(d)))
        proto_row = {}
        by_doc: Dict[int, List[int]] = {}
        for p in pids:
            by_doc.setdefault(int(protos.doc[p]), []).append(p)
        for doc, ps in sorted(by_doc.items()):
            offs = np.asarray([int(protos.offset[p]) for p in ps])
            base = sum(len(k) for k in keep)
            for j, p in enumerate(ps):
                proto_row[p] = base + j
            docs.append(np.asarray(corpus[doc][:offs.max() + 1], np.int64))
            keep.append(offs)
        CK, CV = self.doc_kv(docs, keep) if docs else (None, None)

        st = []
        for r in reqs:
            pl = r.plan
            n, n_dec = pl.n, len(r.served) - 1
            ext = np.concatenate([pl.tokens, r.served[:n_dec]]).astype(np.int64)
            rows = np.full(n, -1, np.int64)
            for j in np.where(pl.source == SEM.FROM_ITEM)[0]:
                rows[j] = item_row[int(pl.item[j])] + int(pl.offset[j])
            for j in np.where(pl.source == SEM.FROM_SEMANTIC)[0]:
                rows[j] = proto_row[int(pl.proto[j])]
            st.append(dict(n=n, ext=torch.from_numpy(ext).to(dev),
                           pos=torch.arange(len(ext), device=dev),
                           rows=torch.from_numpy(rows).to(dev), have=rows >= 0))

        # layer 0 over every token, with Eq. 3's terms
        lw = self.layer(0)
        for s, r in zip(st, reqs):
            n, pos = s["n"], s["pos"]
            x = self.w["embed"][s["ext"]].float()
            h = self.rms(x, lw["attn_norm"])
            q = self.rope(self.mm(h, lw["wq"]).reshape(-1, self.H, self.dh), pos)
            k0, v0 = self.kv0(s["ext"])
            prompt = pos < n
            o, mass = self.attend(q, self.rope(k0, pos), v0, pos, pos, want_mass=prompt)
            have = torch.from_numpy(s["have"]).to(dev)
            rows = s["rows"].clamp_min(0)
            div = ((k0[:n] - CK[rows, 0]).abs().sum(dim=(1, 2))
                   + (v0[:n] - CV[rows, 0]).abs().sum(dim=(1, 2))) if CK is not None \
                else torch.zeros(n, device=dev)
            div = torch.where(have, div, torch.zeros_like(div))
            x = x + self.mm(o, lw["wo"])
            x = x + self.mlp(self.rms(x, lw["mlp_norm"]), lw)
            own = SEM.select(r.plan, mass[:n].cpu().numpy(), div.cpu().numpy(), r_item, r_rev)
            mask = own if r.mask is None else np.asarray(r.mask, bool)
            qrows = np.concatenate([np.where(mask)[0], np.arange(n, len(s["ext"]))])
            s.update(own=own, q=torch.from_numpy(qrows).to(dev),
                     x=x[torch.from_numpy(qrows).to(dev)],
                     fresh=torch.from_numpy(np.concatenate([mask, np.ones(len(s["ext"]) - n, bool)])).to(dev))

        for l in range(1, self.L):
            lw = self.layer(l)
            for s in st:
                n, pos, qi = s["n"], s["pos"], s["q"]
                h = self.rms(s["x"], lw["attn_norm"])
                q = self.rope(self.mm(h, lw["wq"]).reshape(-1, self.H, self.dh), pos[qi])
                kf = self.mm(h, lw["wk"]).reshape(-1, self.Hkv, self.dh)
                vf = self.mm(h, lw["wv"]).reshape(-1, self.Hkv, self.dh)
                S = len(pos)
                K = torch.zeros((S, self.Hkv, self.dh), device=dev)
                V = torch.zeros_like(K)
                cached = torch.from_numpy(np.concatenate(
                    [s["have"], np.zeros(S - n, bool)])).to(dev) & ~s["fresh"]
                if CK is not None and bool(cached.any()):
                    src = s["rows"][cached[:n]]
                    K[cached] = CK[src, l]
                    V[cached] = CV[src, l]
                K[qi], V[qi] = kf, vf
                o, _ = self.attend(q, self.rope(K, pos), V, pos[qi], pos)
                x = s["x"] + self.mm(o, lw["wo"])
                s["x"] = x + self.mlp(self.rms(x, lw["mlp_norm"]), lw)

        finals = [s["x"][s["q"] >= s["n"] - 1] for s in st]
        logits = self.head(torch.cat(finals)).split([len(f) for f in finals])
        return [{"logits": lg, "own_mask": s["own"]} for lg, s in zip(logits, st)]


def gap(ref_logits: torch.Tensor, tokens: Sequence[int]) -> float:
    """The widest gap by which the given tokens' reference logits lie below
    each row's best: max over rows of max(row) - row[token]."""
    t = torch.as_tensor(np.asarray(tokens, np.int64), device=ref_logits.device)
    rows = torch.arange(len(t), device=ref_logits.device)
    return float((ref_logits.max(dim=-1).values - ref_logits[rows, t]).max())
