"""Per-family sharding rules of the port: params, optimizer state, inputs,
KV caches — the counterpart of the JAX package's `sharding/specs.py`.

The rules are spec data, as in the reference: each tensor gets a `P`, a
tuple naming per dimension the mesh axis (or axes) it is split over, in
the reference's parameter pytrees (an LM's layer parameters stacked on a
leading layer axis), so every tree here equals the reference's.  The
meshes need only ``.shape`` (axis -> size) and ``.axis_names``.

The rules are APPLIED in the port.  LM: `shard_lm_params` cuts one
rank's parameters out of a whole model (or the reference's numpy tree)
by `lm_param_specs` (mode "serve" for the serving steps, "train" for the
train step), and `init_sharded_params` draws a rank's parameters from a
seeded generator one whole parameter at a time.  Query heads are split
contiguously; where the model axis divides the kv heads each GQA group
stays with its kv head on one rank, and where it does not every rank
holds every kv head's ``head_dim / tp`` columns of wk / wv (the
reference's ``P(None, din, None, 'model')``), which the forward gathers
into whole heads.  An MoE's experts are split over the model axis (EP)
and its router stays whole.  `train_layout` turns `lm_opt_state_specs`
into where each rank's optimizer state lives.  Recsys:
`shard_recsys_params` / `init_sharded_recsys` give each rank its
contiguous block of rows of every table that `recsys_param_specs` splits
over every axis (the data axes, then ``model``), and
`recsys_train_layout` its AdamW moments (ZeRO-cut over the data axis,
the tables' with their rows).  GNN parameters replicate, and so do their
moments.

Entries over the DATA axes in a parameter's spec are cut too: an MoE's
expert-ff dimension (w_gate / w_up's last, w_down's middle) in both
modes, and in serve mode an MoE model's ``din``, the d_model input
dimension of wq / wk / wv (and wo's output).  A rank keeps its block over
the data axes (`block_index` over ``("data",)``, or ``("pod", "data")``
on a pod mesh), as it keeps its block over ``model``, and the model
gathers the whole dimension where it uses it, one layer (one chunk of
experts) at a time (`sharding.ctx.gather_data`; its backward sums the
gradient over the data axes and keeps the rank's block).  Such a
parameter is its own data block for the optimizer (`ParamLayout.
data_cut`): its moments lie with it, and ZeRO does not cut it again.
The 1T-parameter MoE only fits that way: kimi-k2's experts at 16-way EP
alone would be ~129 GB of bf16 per rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig, RecsysConfig
from repro_torch.launch.mesh import axis_size, data_axes


class P(tuple):
    """A partition spec: per dimension None (replicated), a mesh axis
    name, or a tuple of axis names.  A one-name tuple is that name, as
    `jax.sharding.PartitionSpec` normalises it."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d for d in dims))

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts / lists / tuples (a `P` is a
    leaf), with parallel trees `rest` of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_param_specs(cfg: LMConfig, mesh, *, mode: str = "train") -> Dict[str, Any]:
    """Spec tree matching the reference's `transformer.init_params`
    structure.  `mode='serve'` additionally shards an MoE model's
    attention / embedding weights over the data axis (ZeRO-3-style
    gather-on-use)."""
    m = "model"
    msz = mesh.shape[m]
    dax = data_axes(mesh)
    kv_heads_div = cfg.n_kv_heads % msz == 0

    din = dax if (mode == "serve" and cfg.is_moe) else None

    layer = {
        "attn_norm": P(None, None),
        "mlp_norm": P(None, None),
        "wq": P(None, din, m, None),
        "wk": P(None, din, m, None) if kv_heads_div else P(None, din, None, m),
        "wv": P(None, din, m, None) if kv_heads_div else P(None, din, None, m),
        "wo": P(None, m, None, din),
    }
    if cfg.moe is not None:
        # experts over model (EP) + expert-ff over data
        moe = {
            "router": P(None, None, None),
            "w_up": P(None, m, None, dax),
            "w_down": P(None, m, dax, None),
        }
        if cfg.mlp_type in ("swiglu", "geglu"):
            moe["w_gate"] = P(None, m, None, dax)
        layer["moe"] = moe
    else:
        mlp = {"w_up": P(None, None, m), "w_down": P(None, m, None)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            mlp["w_gate"] = P(None, None, m)
        layer["mlp"] = mlp

    specs: Dict[str, Any] = {
        "embed": P(m, None),
        "layers": layer,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, m)
    return specs


def serving_arena_spec() -> P:
    """Paged KV arena (n_pages, page_size, L, Hkv, Dh): kv heads over the
    model axis, the same head split as wk / wv, so the decode and the
    arena writes stay on each rank's heads.  Pages and slots replicate:
    the slot tables are host numpy and alike on every rank, so one
    logical page id addresses every rank's slice of that page."""
    return P(None, None, None, "model", None)


def check_serving_divisibility(cfg: LMConfig, mesh) -> None:
    """Serving tensor parallelism splits whole heads: both head counts
    must divide by the model-axis size (no padded shard — a config error
    here names the two knobs instead of degrading)."""
    msz = mesh.shape["model"]
    if cfg.n_heads % msz or cfg.n_kv_heads % msz:
        raise ValueError(
            f"mesh model axis of {msz} devices (mesh.tp={msz}) must divide "
            f"n_heads={cfg.n_heads} and n_kv_heads={cfg.n_kv_heads}: pick a "
            f"tp dividing both, or a model with more kv heads")


def kv_dh_cut(cfg: LMConfig, tp: int) -> bool:
    """Does a `tp`-way model axis cut each kv head's Dh (it does not divide
    the kv heads)?"""
    return tp > 1 and cfg.n_kv_heads % tp != 0


def _check_shardable(cfg: LMConfig, mesh) -> None:
    """What the port's rank-local model needs: whole query heads; where
    tp does not divide the kv heads, a Dh it divides and query heads that
    cover whole GQA groups or lie in one; MLP columns, experts and
    vocabulary rows that split evenly."""
    msz = mesh.shape["model"]
    if cfg.n_heads % msz:
        raise ValueError(f"mesh.tp={msz} must divide n_heads={cfg.n_heads} (a rank holds "
                         "whole query heads)")
    if kv_dh_cut(cfg, msz):
        dh, local, group = cfg.resolved_head_dim, cfg.n_heads // msz, \
            cfg.n_heads // cfg.n_kv_heads
        if dh % msz:
            raise ValueError(f"mesh.tp={msz} divides neither n_kv_heads={cfg.n_kv_heads} nor "
                             f"head_dim={dh}: the kv heads' Dh is cut over the model axis "
                             "(P(None, din, None, 'model')), which needs tp | head_dim")
        if local % group and group % local:
            raise ValueError(f"mesh.tp={msz}: a rank's {local} query heads and the GQA group "
                             f"of {group} (n_heads={cfg.n_heads}, n_kv_heads="
                             f"{cfg.n_kv_heads}) must divide one another, so that a rank's "
                             "heads read whole kv heads")
    sizes = [("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)]
    if cfg.moe is not None:
        sizes.append(("moe.n_experts", cfg.moe.n_experts))
    for name, n in sizes:
        if n % msz:
            raise ValueError(f"mesh.tp={msz} must divide {name}={n} (the rank-local "
                             "MLP, expert and vocabulary shards are whole)")
    dsz = axis_size(mesh, data_axes(mesh))
    if cfg.moe is not None:
        for name, n in (("moe.d_ff", cfg.moe.d_ff), ("d_model", cfg.d_model)):
            if n % dsz:
                raise ValueError(f"the data axes' {dsz} ranks must divide {name}={n} (an "
                                 "MoE's expert-ff dimension, and in serve mode d_model, "
                                 "are cut over the data axis)")


def data_cuts(cfg: LMConfig, mesh, mode: str) -> Dict[str, Any]:
    """How `lm_param_specs(mode=mode)` cuts a rank's model over the data
    axes: ``dp``, the data axes' size the cut dimensions divide by (1: no
    cut), and ``din``, whether the attention's d_model dimension is cut
    (serve mode of an MoE model) -> `transformer.Transformer`'s keywords."""
    dsz = axis_size(mesh, data_axes(mesh))
    return {"dp": dsz if cfg.moe is not None else 1,
            "din": mode == "serve" and cfg.is_moe and dsz > 1}


def _cut(x: torch.Tensor, spec: Tuple, mesh, coords: Mapping[str, int]) -> torch.Tensor:
    """This rank's block of `x` under `spec`: each dimension split over
    ``model`` (heads, a kv head's Dh, MLP columns, experts, vocabulary
    rows) or over the data axes (expert-ff, serve mode's ``din``) keeps
    the rank's contiguous slice, its block index over those axes
    (`block_index`)."""
    dax = data_axes(mesh)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if axes != ("model",) and not all(a in dax for a in axes):
            raise ValueError(f"spec {spec}: a parameter dimension over {ax}")
        n, c = block_index(mesh, axes, coords)
        step = x.shape[dim] // n
        x = x.narrow(dim, c * step, step)
    return x


def _layer_specs(cfg: LMConfig, mesh, mode: str = "serve") -> Dict[str, Tuple]:
    """Spec per parameter name of one port `Block` (the stacked layer
    axis dropped) and of the model's own parameters."""
    specs = lm_param_specs(cfg, mesh, mode=mode)
    layer = specs["layers"]
    out = {name: tuple(layer[name])[1:] for name in
           ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo")}
    ffn = "moe" if cfg.moe is not None else "mlp"
    out.update({f"{ffn}.{n}": tuple(s)[1:] for n, s in layer[ffn].items()})
    out.update(embed=tuple(specs["embed"]), final_norm=tuple(specs["final_norm"]))
    if "lm_head" in specs:
        out["lm_head"] = tuple(specs["lm_head"])
    return out


def _param_spec(specs: Dict[str, Tuple], name: str) -> Tuple:
    """A `Transformer.named_parameters` name -> its spec."""
    if name.startswith("layers."):
        name = name.split(".", 2)[2]
    return specs[name]


@torch.no_grad()
def shard_lm_params(source, cfg: LMConfig, mesh, coords: Optional[Mapping[str, int]] = None,
                    device=None, mode: str = "serve"):
    """One rank's `Transformer` (its heads, MLP columns, experts and
    vocabulary rows) cut out of `source` by `lm_param_specs(mode=mode)`.  `source`
    is a whole port `Transformer` or the reference's parameter tree as
    numpy (layers stacked, the tree `models.convert.params_from_numpy`
    takes); `coords` is the rank's mesh coordinate (default: the mesh's
    own rank), `device` where the shard lives (default: the source
    model's, else the CPU)."""
    from repro_torch.models.convert import _tensor
    from repro_torch.models.transformer import Transformer

    _check_shardable(cfg, mesh)
    coords = mesh.coords if coords is None else coords
    specs = _layer_specs(cfg, mesh, mode)
    if device is None:
        device = source.device if isinstance(source, torch.nn.Module) else "cpu"
    model = Transformer(cfg, device=device, tp=mesh.shape["model"], tp_rank=coords["model"],
                        **data_cuts(cfg, mesh, mode))
    for name, p in model.named_parameters():
        if isinstance(source, torch.nn.Module):
            full = source.get_parameter(name)
        elif name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            leaf = source["layers"]
            for part in rest.split("."):
                leaf = leaf[part]
            full = _tensor(np.asarray(leaf)[int(i)], p.dtype, device)
        else:
            full = _tensor(source[name], p.dtype, device)
        p.copy_(_cut(full, _param_spec(specs, name), mesh, coords))
    return model


def shares_card(mesh) -> bool:
    """Do several ranks of `mesh`'s world share one card (gloo ranks on
    fewer cards than ranks)?"""
    import torch.distributed as dist

    dev = getattr(mesh, "device", None)
    return (dev is not None and torch.device(dev).type == "cuda" and dist.is_initialized()
            and dist.get_world_size() > torch.cuda.device_count())


def init_sharded_params(cfg: LMConfig, mesh, generator: torch.Generator, device,
                        coords: Optional[Mapping[str, int]] = None, mode: str = "serve",
                        token_embed: bool = True):
    """One rank's parameters: `transformer.init_params` drawing the whole
    model's weights from `generator`, each parameter cut to the rank's
    block as soon as it is drawn, so the rank never holds the whole
    model: its peak is its shard plus the largest whole parameter, in the
    model's dtype (kimi-k2's w_up, 384 x 7168 x 2048: 11.3 GB in bf16).
    The draws are `init_params`' on the whole model, so every rank's
    blocks are cut from the same weights.  Where ranks share a card
    (`shares_card`) they draw in turn, rank by rank, so that the card
    holds one rank's whole parameter at a time besides the shards.  ->
    (the rank's `Transformer`, the whole embedding as fp32 numpy, which
    the semantic cache's token matching reads; None without
    `token_embed`)."""
    import torch.distributed as dist

    from repro_torch.models.transformer import init_params

    _check_shardable(cfg, mesh)
    coords = mesh.coords if coords is None else coords
    specs = _layer_specs(cfg, mesh, mode)
    embeds = []

    def keep(name: str, full: torch.Tensor) -> torch.Tensor:
        if name == "embed" and token_embed:
            embeds.append(full.float().cpu().numpy())
        return _cut(full, _param_spec(specs, name), mesh, coords)

    def draw():
        return init_params(cfg, generator, device, tp=mesh.shape["model"],
                           tp_rank=coords["model"], keep=keep, **data_cuts(cfg, mesh, mode))

    if not shares_card(mesh):
        return draw(), embeds[0] if embeds else None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            model = draw()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        dist.barrier()
    return model, embeds[0] if embeds else None


def zero_shard(spec_tree, shape_tree, mesh):
    """ZeRO-style sharding for optimizer moments: take each tensor's spec
    and shard the first still-replicated, divisible dim over the data
    axis.  `shape_tree` leaves have ``.shape``."""
    dax = data_axes(mesh)
    dsz = axis_size(mesh, dax)

    def one(spec: P, sds) -> P:
        dims = list(spec) + [None] * (len(sds.shape) - len(spec))
        used = set()
        for d in dims:
            for a in (d if isinstance(d, tuple) else (d,)):
                used.add(a)
        if any(a in used for a in dax):  # already data-sharded somewhere
            return P(*dims)
        for i, (ax, size) in enumerate(zip(dims, sds.shape)):
            if ax is None and size % dsz == 0 and size >= dsz:
                dims[i] = dax
                return P(*dims)
        return P(*dims)

    return tree_map(one, spec_tree, shape_tree)


def lm_opt_state_specs(opt_abstract, param_specs, params_abstract, mesh):
    """Specs of an optimizer state in the reference's layout
    (`optimizer.abstract_opt_state`): AdamW's moments ``{"m", "v"}`` take
    the parameters' specs ZeRO-sharded over the data axis (`zero_shard`);
    Adafactor's per-parameter ``v`` takes the parameter's spec, ``vr`` its
    dims but the last and ``vc`` its dims but the second-to-last.  SGD
    keeps no state, so its inner specs are ``()`` (the reference's rule
    raises on that empty state)."""
    from repro_torch.training.optimizer import OptState

    inner = opt_abstract.inner
    if isinstance(inner, tuple) and not inner:
        return OptState(step=P(), inner=())
    if isinstance(inner, dict) and inner and set(inner) <= {"m", "v"}:
        zspecs = zero_shard(param_specs, params_abstract, mesh)
        return OptState(step=P(), inner={k: zspecs for k in inner})

    def one(spec: P, sds, st):
        dims = list(spec) + [None] * (len(sds.shape) - len(spec))
        out = {}
        for key in st:
            if key == "v":
                out["v"] = P(*dims)
            elif key == "vr":
                out["vr"] = P(*dims[:-1])
            elif key == "vc":
                out["vc"] = P(*(dims[:-2] + dims[-1:]))
        return out

    return OptState(step=P(), inner=tree_map(one, param_specs, params_abstract, inner))


def lm_abstract_params(cfg: LMConfig) -> Dict[str, Any]:
    """The reference's parameter tree of `cfg` (layers stacked on a leading
    axis) with ``.shape`` leaves, from the port's model on the meta
    device."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device="meta")
    tree: Dict[str, Any] = {"layers": {}}
    for name, p in model.named_parameters():
        if not name.startswith("layers.0."):
            if not name.startswith("layers."):
                tree[name] = SimpleNamespace(shape=tuple(p.shape))
            continue
        node = tree["layers"]
        parts = name.split(".")[2:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = SimpleNamespace(shape=(cfg.n_layers,) + tuple(p.shape))
    return tree


@dataclass(frozen=True)
class ParamLayout:
    """Where one rank parameter's pieces live.  ``model_dims``: dims of the
    rank's tensor that are cut over the model axis (its sums and means
    along them are reduced over that axis).  Its optimizer moments are
    this rank's block over the data axis: the slice of ``data_dim``, or,
    where the reference's ZeRO cut falls on the stacked layer axis, the
    whole layer's moments on data rank ``data_owner`` and none elsewhere;
    both None: whole on every data rank.  ``data_cut``: the parameter
    itself is this rank's block over the data axis too (a recsys table's
    rows over every axis; an LM parameter the specs cut over the data
    axes, along ``data_dims``): its gradient is its own, not a share to
    average over the data axis, and its moments lie with it."""

    model_dims: Tuple[int, ...] = ()
    data_dim: Optional[int] = None
    data_owner: Optional[int] = None
    data_cut: bool = False
    data_dims: Tuple[int, ...] = ()

    @property
    def data_split(self) -> bool:
        return self.data_dim is not None or self.data_owner is not None


def _has(entry, axes) -> bool:
    names = entry if isinstance(entry, tuple) else (entry,)
    return any(a in names for a in axes)


def train_layout(cfg: LMConfig, mesh, optimizer: str) -> Dict[str, ParamLayout]:
    """Per `Transformer.named_parameters` name, its `ParamLayout` under
    `lm_param_specs(mode="train")` and `lm_opt_state_specs` for
    `optimizer`'s state (adamw | adafactor | sgd): a parameter cut over
    the data axes is its own data block (``data_cut``, its moments with
    it, as the reference's `zero_shard` leaves it), every other one's
    moments on its ZeRO block."""
    from repro_torch.training.optimizer import abstract_opt_state

    _check_shardable(cfg, mesh)
    dax = data_axes(mesh)
    dsz = axis_size(mesh, dax)
    pspecs = lm_param_specs(cfg, mesh, mode="train")
    abstract = lm_abstract_params(cfg)
    ospecs = lm_opt_state_specs(abstract_opt_state(optimizer, abstract), pspecs, abstract,
                                mesh).inner
    moment = ospecs["m"] if isinstance(ospecs, dict) and "m" in ospecs else None

    def layout(pspec, mspec, stacked: bool, layer: int) -> ParamLayout:
        off = 1 if stacked else 0
        pdims = tuple(pspec)[off:]
        model_dims = tuple(i for i, d in enumerate(pdims) if d == "model")
        data_dims = tuple(i for i, d in enumerate(pdims) if d is not None and _has(d, dax))
        if data_dims:                  # its own data block; ZeRO leaves it whole
            return ParamLayout(model_dims, data_cut=True, data_dims=data_dims)
        if mspec is None:
            return ParamLayout(model_dims)
        for i, d in enumerate(tuple(mspec)):
            if d is not None and _has(d, dax):
                if stacked and i == 0:
                    return ParamLayout(model_dims, data_owner=layer // (cfg.n_layers // dsz))
                return ParamLayout(model_dims, data_dim=i - off)
        return ParamLayout(model_dims)

    out = {}
    from repro_torch.models.transformer import Transformer
    for name, _ in Transformer(cfg, device="meta").named_parameters():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            ps, ms = pspecs["layers"], None if moment is None else moment["layers"]
            for part in rest.split("."):
                ps = ps[part]
                ms = None if ms is None else ms[part]
            out[name] = layout(ps, ms, True, int(i))
        else:
            out[name] = layout(pspecs[name], None if moment is None else moment[name],
                               False, 0)
    return out


def lm_input_specs(cfg: LMConfig, mesh, step: str, dims: Dict[str, int]):
    dax = data_axes(mesh)
    dsz = axis_size(mesh, dax)
    b = dims["batch"]
    if step == "train":
        return {"tokens": P(dax, None), "labels": P(dax, None)}
    if step == "prefill":
        return {"tokens": P(dax, None)}
    if step == "decode":
        return {
            "tokens": P(dax, None) if b % dsz == 0 else P(None, None),
            "cache": lm_cache_spec(cfg, mesh, b, dims["seq"]),
            "positions": P(dax) if b % dsz == 0 else P(None),
        }
    raise ValueError(step)


def lm_cache_spec(cfg: LMConfig, mesh, batch: int, seq: int):
    """KV cache (L, B, S, Hkv, Dh) sharding.  batch -> data when
    divisible; kv heads -> model when divisible, else sequence -> model
    (flash-decoding split-K, combined by an all-reduce)."""
    m = "model"
    msz = mesh.shape[m]
    dax = data_axes(mesh)
    dsz = axis_size(mesh, dax)
    if batch % dsz == 0:
        if cfg.n_kv_heads % msz == 0:
            spec = P(None, dax, None, m, None)
        else:
            spec = P(None, dax, m, None, None)  # shard sequence on model
    else:
        # tiny batch (long_500k): shard the sequence across everything
        all_ax = tuple(dax) + (m,)
        spec = P(None, None, all_ax, None, None)
    return {"k": spec, "v": spec}


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _param_tree(module) -> Any:
    """A `recsys.models.ParamTree` as nested dicts / lists of tensors (the
    reference's parameter pytree)."""
    children = dict(module.named_children())
    if isinstance(module, torch.nn.ModuleList):
        return [_param_tree(c) for c in module]
    out = {name: p for name, p in module.named_parameters(recurse=False)}
    out.update({name: _param_tree(c) for name, c in children.items()})
    return out


def recsys_param_specs(cfg: RecsysConfig, mesh) -> Dict[str, Any]:
    """Embedding tables of 4,096 rows or more split by rows over every
    axis; everything else replicated.  Shapes from the port's model built
    on the meta device."""
    from repro_torch.recsys import models as RM

    dax = data_axes(mesh)
    rows = tuple(dax) + ("model",)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        name = "/".join(path)
        if "table" in name and tree.ndim == 2 and tree.shape[0] >= 4096:
            return P(rows, None)
        return P(*([None] * tree.ndim))

    return walk(_param_tree(RM.init_params(cfg, device="meta")), ())


def _map_named(tree, fn, path: Tuple[str, ...] = ()):
    """`fn(name, leaf)` over a tree of dicts and lists, each leaf named as
    `named_parameters` names it (keys and indices joined by dots); ->
    a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(".".join(path), tree)


def _split_tables(cfg: RecsysConfig, mesh) -> Dict[str, bool]:
    """Per `RecsysModel.named_parameters` name: is it a table split by rows
    over every axis (`recsys_param_specs`)?"""
    out: Dict[str, bool] = {}
    _map_named(recsys_param_specs(cfg, mesh),
               lambda name, spec: out.__setitem__(name, spec[0] is not None))
    return out


def block_index(mesh, axes=None, coords: Optional[Mapping[str, int]] = None) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dimension split over `axes` (names;
    default every axis), counted in mesh order, the last axis fastest.
    `coords`: the rank's mesh coordinate (default the mesh's own)."""
    coords = mesh.coords if coords is None else coords
    n, c = 1, 0
    for a in mesh.axis_names:
        if axes is None or a in axes:
            n, c = n * mesh.shape[a], c * mesh.shape[a] + coords[a]
    return n, c


def row_block(rows: int, mesh, coords: Optional[Mapping[str, int]] = None) -> Tuple[int, int]:
    """(first row, rows) of this rank's block of a table of `rows` rows
    split over every axis (`block_index`)."""
    n, c = block_index(mesh, coords=coords)
    if rows % n:
        raise ValueError(f"a table of {rows} rows does not split over {n} ranks")
    return c * (rows // n), rows // n


def _recsys_shard(model, cfg: RecsysConfig, mesh, coords) -> None:
    """Record each split table's first global row (`RecsysModel.row0`)."""
    _, c = block_index(mesh, coords=coords)
    for name, split in _split_tables(cfg, mesh).items():
        if split:
            model.row0[name] = c * model.get_parameter(name).shape[0]


@torch.no_grad()
def shard_recsys_params(source, cfg: RecsysConfig, mesh,
                        coords: Optional[Mapping[str, int]] = None, device=None):
    """One rank's `RecsysModel`: `source` (a whole model) with each table
    that `recsys_param_specs` splits cut to the rank's block of rows, the
    rest whole; its ``row0`` maps each cut table to its first global row.
    `coords`: the rank's mesh coordinate (default the mesh's own)."""
    from repro_torch.recsys import models as RM

    coords = mesh.coords if coords is None else coords
    device = source.device if device is None else device
    split = _split_tables(cfg, mesh)

    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        if split[name]:
            r0, n = row_block(t.shape[0], mesh, coords)
            t = t[r0:r0 + n]
        return t.detach().to(device).clone()
    model = RM.RecsysModel(cfg, _map_named(_param_tree(source), cut))
    _recsys_shard(model, cfg, mesh, coords)
    return model


def init_sharded_recsys(cfg: RecsysConfig, mesh, generator: torch.Generator, device,
                        coords: Optional[Mapping[str, int]] = None):
    """One rank's `RecsysModel` drawn from `generator` as
    `recsys.models.init_params` draws the whole model: each table is drawn
    whole and cut to the rank's block of rows at once, so the rank holds
    one whole table at a time."""
    from repro_torch.recsys import models as RM

    coords = mesh.coords if coords is None else coords

    def keep(full: torch.Tensor) -> torch.Tensor:
        r0, n = row_block(full.shape[0], mesh, coords)
        return full[r0:r0 + n].clone()
    model = RM.init_params(cfg, generator, device, keep=keep)
    _recsys_shard(model, cfg, mesh, coords)
    cut = {n for n, _ in model.named_parameters() if n in model.row0}
    if cut != {n for n, s in _split_tables(cfg, mesh).items() if s}:
        raise AssertionError(f"tables cut {sorted(cut)} differ from recsys_param_specs'")
    return model


def recsys_opt_state_specs(cfg: RecsysConfig, mesh):
    """The recsys train bundle's AdamW state (the reference's
    `_recsys_bundle`): the moments take the parameters' specs ZeRO-cut
    over the data axis."""
    from repro_torch.recsys import models as RM
    from repro_torch.training.optimizer import OptState

    pspecs = recsys_param_specs(cfg, mesh)
    zspecs = zero_shard(pspecs, _param_tree(RM.init_params(cfg, device="meta")), mesh)
    return OptState(step=P(), inner={"m": zspecs, "v": zspecs})


def recsys_train_layout(cfg: RecsysConfig, mesh) -> Dict[str, "ParamLayout"]:
    """Per `RecsysModel.named_parameters` name, its `ParamLayout` under
    `recsys_opt_state_specs`: a split table is cut over the model axis on
    its rows and is its own data block (``data_cut``); every other
    parameter is whole, its moments on the data block ZeRO gives it."""
    dax = data_axes(mesh)
    split = _split_tables(cfg, mesh)
    out: Dict[str, ParamLayout] = {}

    def layout(name: str, mspec: P) -> None:
        if split[name]:
            out[name] = ParamLayout(model_dims=(0,), data_cut=True)
        else:
            out[name] = ParamLayout(data_dim=next(
                (i for i, d in enumerate(mspec) if d is not None and _has(d, dax)), None))
    _map_named(recsys_opt_state_specs(cfg, mesh).inner["m"], layout)
    return out


def _input_ndims(cfg: RecsysConfig, shape_name: str) -> Dict[str, int]:
    """Rank of each model input of one recsys cell (a two-row batch of
    the cell: only the ranks are read)."""
    from repro_torch.configs.registry import make_batch

    gen = torch.Generator().manual_seed(0)
    return {k: v.ndim for k, v in make_batch(cfg, shape_name, gen, device="cpu",
                                             batch=2).items()}


def recsys_input_specs(cfg: RecsysConfig, mesh, step: str, dims: Dict[str, int]):
    dax = data_axes(mesh)
    dsz = axis_size(mesh, dax)
    b = dims["batch"]
    bspec = dax if b % dsz == 0 else None
    out = {}
    for k, ndim in _input_ndims(cfg, _shape_name_of(cfg, step, dims)).items():
        if k in ("candidate_ids", "neg_samples"):
            # the id vectors replicate; the gather runs sharded via the
            # row-sharded table
            out[k] = P(None)
        else:
            out[k] = P(bspec, *([None] * (ndim - 1)))
    return out


def _shape_name_of(cfg, step, dims):
    from repro_torch.configs.registry import SHAPES

    for name, s in SHAPES["recsys"].items():
        if s.step == step and s.dims.get("batch") == dims.get("batch"):
            return name
    raise KeyError((step, dims))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def gnn_param_specs(params_abstract, mesh):
    """Every GNN parameter replicated.  Leaves have ``.shape``."""
    return tree_map(lambda leaf: P(*([None] * len(leaf.shape))), params_abstract)


def gnn_opt_state_specs(params_abstract, mesh):
    """The GNN train bundle's AdamW state (the reference's `_gnn_bundle`):
    the moments lie like the parameters, replicated, with no ZeRO cut."""
    from repro_torch.training.optimizer import OptState

    pspecs = gnn_param_specs(params_abstract, mesh)
    return OptState(step=P(), inner={"m": pspecs, "v": pspecs})


def gnn_input_specs(mesh, shape_name: str, spec_shapes: Dict[str, Any]):
    dax = data_axes(mesh)
    edge_ax = tuple(dax) + ("model",)
    esz = axis_size(mesh, edge_ax)
    out = {}
    for k, v in spec_shapes.items():
        if k.startswith("edge_"):
            if len(v.shape) == 1:
                # shard flat edge arrays only when divisible
                out[k] = P(edge_ax) if v.shape[0] % esz == 0 else P(None)
            else:  # molecule regime: (B, E)
                out[k] = P(dax, None)
        elif k in ("atom_types", "positions", "targets") and shape_name == "molecule":
            out[k] = P(*([dax] + [None] * (len(v.shape) - 1)))
        elif (
            k == "node_feat"
            and v.shape[0] * v.shape[1] > 2**27
            and v.shape[0] % axis_size(mesh, dax) == 0
        ):
            out[k] = P(dax, None)  # huge node features, if divisible
        else:
            out[k] = P(*([None] * len(v.shape)))
    return out
