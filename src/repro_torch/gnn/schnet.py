"""SchNet [arXiv:1706.08566] for the port: continuous-filter convolutions
(the JAX package's `gnn/schnet.py`, with its parameter layout and init
scales).

Message passing is an edge-index gather and a scatter-add: the
reference's `jax.ops.segment_sum` is `index_add_` into (N, H).  Two
regimes share the interaction core:
  * molecules: atom types and 3-D positions, energy regression; the
    reference vmaps over B small graphs with edge masks, the port
    flattens them into one graph of B*N atoms (each molecule's edges
    offset by its first atom), which gives the same energies;
  * citation / product graphs (full_graph_sm, minibatch_lg): node
    features projected into the hidden space, synthetic 3-D positions
    for the radial geometry, a node-classification head.

Numerics as the reference's: fp32, the shifted softplus as logaddexp(x,
0) - log 2 (torch's softplus switches to x above its threshold), and the
radial centres as XLA computes `jnp.linspace(0, cutoff, n_rbf)` in fp32
(`rbf_centres`): gamma = 1 / (cutoff / n_rbf)^2 = 900 at the published
size amplifies any last-ulp difference in a centre.  Plain PyTorch: the
reference has no kernel here.

Edge-parallel on a mesh (`gnn_input_specs`: a graph's flat edge arrays
split over every axis, ``edge_axes``): a rank computes the messages of
its block of edges and each aggregation is summed over those ranks
(`sharding.ctx.all_reduce` over ``edge_axes``, backward the identity).
Everything that enters the edge region, the node states and the
parameters applied to edges (``w_in`` and the filter network), enters
through `sharding.ctx.copy_to_tp` over ``edge_axes``, whose backward sums the ranks' partial gradients: every rank then holds
the whole gradient of a loss all ranks share, and per-node gradients are
counted once.  Padded edges (`pad_edges`, the reference's ``_prep``:
``edge_dst = n_nodes``) are masked out before the scatter, which the
reference's ``segment_sum`` drops and ``index_add`` would refuse.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.recsys.models import ParamTree
from repro_torch.sharding import ctx as CTX

Batch = Dict[str, torch.Tensor]


class SchNet(ParamTree):
    """The reference's parameter pytree as modules: `interactions[i].w_in`
    reads as `params["interactions"][i]["w_in"]`; `atom_embed` and the
    energy head (`head_w1`, ...) for molecules, `in_proj` and `cls_w` /
    `cls_b` for graphs."""

    def __init__(self, cfg: GNNConfig, tree: Dict):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def init_params(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
                device="cuda", d_feat: Optional[int] = None,
                n_classes: Optional[int] = None) -> SchNet:
    """Random weights at the reference's scales from an explicit
    generator on `device` (none on "meta").  Graph regime when `d_feat`
    is given, molecule regime otherwise."""
    H, R = cfg.d_hidden, cfg.n_rbf
    kw = dict(dtype=torch.float32, device=device)

    def normal(shape, scale):
        return torch.empty(shape, **kw).normal_(generator=generator).mul_(scale)

    def zeros(n):
        return torch.zeros(n, **kw)

    tree: Dict = {"interactions": []}
    if d_feat is None:
        tree["atom_embed"] = normal((cfg.n_atom_types, H), 0.1)
    else:
        tree["in_proj"] = normal((d_feat, H), d_feat ** -0.5)
    for _ in range(cfg.n_interactions):
        tree["interactions"].append({
            "w_in": normal((H, H), H ** -0.5),
            "filt_w1": normal((R, H), R ** -0.5), "filt_b1": zeros(H),
            "filt_w2": normal((H, H), H ** -0.5), "filt_b2": zeros(H),
            "w_out1": normal((H, H), H ** -0.5), "b_out1": zeros(H),
            "w_out2": normal((H, H), H ** -0.5), "b_out2": zeros(H),
        })
    if n_classes is None:
        tree["head_w1"] = normal((H, H // 2), H ** -0.5)
        tree["head_b1"] = zeros(H // 2)
        tree["head_w2"] = normal((H // 2, 1), (H // 2) ** -0.5)
    else:
        tree["cls_w"] = normal((H, n_classes), H ** -0.5)
        tree["cls_b"] = zeros(n_classes)
    return SchNet(cfg, tree)


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus, SchNet's activation: logaddexp(x, 0) - log 2."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def rbf_centres(n_rbf: int, cutoff: float, device=None) -> torch.Tensor:
    """`jnp.linspace(0, cutoff, n_rbf)` as XLA computes it in fp32: i *
    (cutoff * (1 / (n_rbf - 1))), the last centre `cutoff` itself."""
    kw = dict(dtype=torch.float32, device=device)
    if n_rbf == 1:
        return torch.zeros(1, **kw)
    step = torch.tensor(cutoff, **kw) * (torch.tensor(1.0, **kw) / (n_rbf - 1))
    mu = torch.arange(n_rbf - 1, **kw) * step
    return torch.cat([mu, torch.tensor([cutoff], **kw)])


def rbf_expand(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis: (E,) -> (E, n_rbf)."""
    mu = rbf_centres(n_rbf, cutoff, d.device)
    gamma = 1.0 / ((cutoff / n_rbf) ** 2)
    return torch.exp(-gamma * (d[..., None] - mu) ** 2)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff, 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0),
                       torch.zeros_like(d))


def interactions(model: SchNet, h: torch.Tensor, positions: torch.Tensor,
                 edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_mask: Optional[torch.Tensor] = None, edge_axes: tuple = ()) -> torch.Tensor:
    """The cfconv stack: h (N, H), positions (N, 3), edges (E,) index
    tensors (and an optional (E,) mask: a masked edge's destination may be
    out of range, as a padded one's is) -> h (N, H).  Messages are summed
    into their destination rows by `index_add`, and over the ranks of
    `edge_axes` when the edges are this rank's block (the module
    docstring)."""
    cfg = model.cfg
    src, dst = edge_src.long(), edge_dst.long()
    if edge_mask is not None:
        dst = dst.clamp(max=h.shape[0] - 1)
    diff = positions[src] - positions[dst]                       # (E, 3)
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    rbf = rbf_expand(d, cfg.n_rbf, cfg.cutoff)                   # (E, R)
    env = cosine_cutoff(d, cfg.cutoff)                           # (E,)
    if edge_mask is not None:
        env = env * edge_mask.to(env.dtype)
    for ip in model.interactions:
        f1, b1, f2, b2, w_in, hin = (CTX.copy_to_tp(t, edge_axes) for t in (
            ip.filt_w1, ip.filt_b1, ip.filt_w2, ip.filt_b2, ip.w_in, h))
        w = ssp(rbf @ f1 + b1)
        w = (w @ f2 + b2) * env[:, None]                         # (E, H)
        msg = (hin @ w_in)[src] * w                              # gather (E, H)
        agg = CTX.all_reduce(torch.zeros_like(h).index_add(0, dst, msg), edge_axes)
        upd = ssp(agg @ ip.w_out1 + ip.b_out1)
        h = h + (upd @ ip.w_out2 + ip.b_out2)
    return h


def node_logits(model: SchNet, batch: Batch, edge_axes: tuple = ()) -> torch.Tensor:
    """Graph regime: node-classification logits (N, n_classes).  A padded
    batch (`pad_edges`) carries its edges' mask."""
    h = batch["node_feat"] @ model.in_proj
    h = interactions(model, h, batch["positions"], batch["edge_src"], batch["edge_dst"],
                     edge_mask=batch.get("edge_mask"), edge_axes=edge_axes)
    return h @ model.cls_w + model.cls_b


def pad_edges(batch: Batch, ranks: int, n_nodes: int) -> Batch:
    """The reference's ``_prep``: a graph's flat edges padded to a multiple
    of `ranks` (src with 0, dst with `n_nodes`, out of range), with the
    mask that drops the padded ones (``edge_mask``)."""
    e = batch["edge_src"].shape[0]
    pad = (-e) % ranks
    out = dict(batch)
    src, dst = batch["edge_src"], batch["edge_dst"]
    out["edge_src"] = torch.cat([src, src.new_zeros(pad)])
    out["edge_dst"] = torch.cat([dst, dst.new_full((pad,), n_nodes)])
    out["edge_mask"] = torch.arange(e + pad, device=src.device) < e
    return out


def molecule_energy(model: SchNet, atom_types: torch.Tensor, positions: torch.Tensor,
                    edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    edge_mask: torch.Tensor) -> torch.Tensor:
    """One molecule's energy (the atomwise readout summed): atom_types
    (N,), positions (N, 3), edges (E,) and their mask (E,) -> ()."""
    h = model.atom_embed[atom_types.long()]
    h = interactions(model, h, positions, edge_src, edge_dst, edge_mask=edge_mask)
    e_atom = ssp(h @ model.head_w1 + model.head_b1) @ model.head_w2
    return e_atom[:, 0].sum()


def batched_energy(model: SchNet, batch: Batch) -> torch.Tensor:
    """(B,) energies of the `molecule` cell: B molecules of N atoms and E
    edges as one graph of B*N atoms, each atom's energy summed into its
    molecule."""
    types = batch["atom_types"]
    B, N = types.shape
    offset = (torch.arange(B, device=types.device) * N)[:, None]
    h = model.atom_embed[types.reshape(-1).long()]
    h = interactions(model, h, batch["positions"].reshape(B * N, 3),
                     (batch["edge_src"].long() + offset).reshape(-1),
                     (batch["edge_dst"].long() + offset).reshape(-1),
                     edge_mask=batch["edge_mask"].reshape(-1))
    e_atom = ssp(h @ model.head_w1 + model.head_b1) @ model.head_w2
    return e_atom[:, 0].reshape(B, N).sum(-1)


def train_loss(model: SchNet, batch: Batch, edge_axes: tuple = ()) -> torch.Tensor:
    """The reference's `train_loss`: molecules, the energies' mean absolute
    error; graphs, the mean cross entropy of the labelled nodes (a
    minibatch's seeds, the first rows of its subgraph), with the edges
    this rank's block over `edge_axes` (every rank then computes the
    whole loss)."""
    if "atom_types" in batch:
        return (batched_energy(model, batch) - batch["targets"]).abs().mean()
    logits = node_logits(model, batch, edge_axes)
    if "seed_labels" in batch:
        labels = batch["seed_labels"]
        logits = logits[:labels.shape[0]]
    else:
        labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()


def param_shapes(model: nn.Module) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
