"""Typed serving API of the port — the JAX package's `serving/api.py`:
`ServeConfig` with the tensor-parallel mesh (`MeshConfig`), the attention-backend seam
(`attn_backend`, `decode_kernel`, sliced onto the model's `LMConfig` by
`apply_to`), the block store's knobs
(`kv_reuse`, `StoreConfig`), the cluster's (`k`, `policy`),
disaggregation's (`DisaggConfig`) and the analytic simulator's
(``engine="sim"``, ``mode="prefix"``), the ``--config key=value,...``
grammar (`ServeConfig.parse` / `render`, `from_args` for launcher flags),
greedy/temperature sampling, stop sequences, the session protocol the
server speaks (`SubmitRequest`, `StreamEvent`, `Completion`), and the
sliced builders (engine -> backend -> batcher)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ATTN_BACKENDS, DECODE_KERNELS
from repro_torch.core.scheduler import POLICIES

ENGINES = ("sim", "torch")
MODES = ("rcllm", "prefix", "full")
SCHEDS = ("wave", "chunked")
FINISH_REASONS = ("length", "stop", "cancelled", "rejected")


@dataclass(frozen=True)
class MeshConfig:
    """The typed sharding surface: how the serving stack maps onto a
    device mesh of `torch.distributed` ranks (`launch.mesh`).

    ``tp`` splits attention heads, the MLP's hidden width, the vocabulary
    and the KV arena's kv-head axis over the mesh's ``model`` axis
    (Megatron-style tensor parallelism: each rank runs its shard and the
    partial products are all-reduced, `sharding.ctx`); ``dp`` sizes the
    ``data`` axis (replica sets: every replica serves the whole trace).
    ``mesh_shape=None`` derives the shape from ``tp``/``dp``; an explicit
    shape (``--config mesh.mesh_shape=2x4``) must agree with any
    explicitly-set ``tp``/``dp`` and fills them in otherwise.  The default
    ``MeshConfig()`` is *disabled*: the stack runs exactly as before, on
    one device, with no mesh anywhere.  ``tp=1`` with ``mesh_shape=(1,
    1)`` is the enabled-but-single-device mesh, bitwise the unsharded
    path."""

    tp: int = 1
    dp: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"invalid MeshConfig: {msg}")

        if self.mesh_shape is not None:
            object.__setattr__(self, "mesh_shape", tuple(self.mesh_shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.tp < 1 or self.dp < 1:
            bad(f"tp={self.tp}/dp={self.dp} must be >= 1")
        names = self.axis_names
        if (not names or len(set(names)) != len(names)
                or not all(isinstance(a, str) and a for a in names)):
            bad(f"axis_names={names!r} must be distinct non-empty strings")
        if "model" not in names:
            bad(f"axis_names={names!r} must include 'model' "
                "(the tensor-parallel axis every partition spec names)")
        if self.mesh_shape is None:
            if names != ("data", "model"):
                bad(f"axis_names={names!r} needs an explicit mesh_shape (only the "
                    "default ('data', 'model') layout can be derived from tp/dp)")
            return
        shape = self.mesh_shape
        if len(shape) != len(names):
            bad(f"mesh_shape={shape} has {len(shape)} dims but axis_names={names!r} "
                f"has {len(names)}")
        if any(int(s) < 1 for s in shape):
            bad(f"mesh_shape={shape} dims must be >= 1")
        shape = tuple(int(s) for s in shape)
        object.__setattr__(self, "mesh_shape", shape)
        derived_tp = shape[names.index("model")]
        derived_dp = 1
        for name, size in zip(names, shape):
            if name != "model":
                derived_dp *= size
        if self.tp not in (1, derived_tp):
            bad(f"mesh_shape={shape} puts {derived_tp} devices on the model axis but "
                f"tp={self.tp}: drop one of the two knobs or make them agree")
        if self.dp not in (1, derived_dp):
            bad(f"mesh_shape={shape} puts {derived_dp} devices on the data axes but "
                f"dp={self.dp}: drop one of the two knobs or make them agree")
        object.__setattr__(self, "tp", derived_tp)
        object.__setattr__(self, "dp", derived_dp)

    @property
    def enabled(self) -> bool:
        """Does this config ask for a mesh at all?"""
        return self.mesh_shape is not None or self.tp > 1 or self.dp > 1

    @property
    def resolved_shape(self) -> Tuple[int, ...]:
        if self.mesh_shape is not None:
            return self.mesh_shape
        return (self.dp, self.tp)

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.resolved_shape:
            n *= s
        return n

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a built mesh's ``shape``."""
        return dict(zip(self.axis_names, self.resolved_shape))

    def build(self):
        """This rank's `launch.mesh.Mesh`, or None when disabled.  Raises
        the explicit-shape error when the process group has fewer ranks
        than the shape needs (outside a launched run the world is this
        one process: only a one-device shape builds)."""
        if not self.enabled:
            return None
        from repro_torch.launch.mesh import make_production_mesh

        return make_production_mesh(shape=self.resolved_shape, axis_names=self.axis_names)


@dataclass(frozen=True)
class DisaggConfig:
    """How many cluster workers serve each role, and how migration routing
    trades affinity against bytes.

    ``prefill_workers`` / ``decode_workers`` split the cluster's ``k``
    workers: prefill workers admit and prefill (sampling each request's
    first token), then hand the finished (or chunk-partial) KV to a decode
    worker; decode workers never admit.  The default ``DisaggConfig()`` is
    disabled: every worker is ``unified``.  ``mig_gamma`` weights the
    migration-byte term added to the Eq. 2 score when choosing the decode
    worker (one already holding the request's store blocks by digest
    moves fewer bytes and scores higher)."""

    prefill_workers: int = 0
    decode_workers: int = 0
    mig_gamma: float = 0.25

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"invalid DisaggConfig: {msg}")

        if self.prefill_workers < 0 or self.decode_workers < 0:
            bad(f"prefill_workers={self.prefill_workers}/"
                f"decode_workers={self.decode_workers} must be >= 0")
        if (self.prefill_workers > 0) != (self.decode_workers > 0):
            bad(f"prefill_workers={self.prefill_workers} and "
                f"decode_workers={self.decode_workers}: both roles need at least "
                "one worker (0/0 disables disaggregation)")
        if self.mig_gamma < 0:
            bad(f"mig_gamma={self.mig_gamma} must be >= 0")

    @property
    def enabled(self) -> bool:
        return self.prefill_workers > 0

    @property
    def n_workers(self) -> int:
        return self.prefill_workers + self.decode_workers

    def role_of(self, wid: int) -> str:
        """Worker role by cluster index: the first ``prefill_workers`` ids
        prefill, the rest decode; 'unified' when disabled."""
        if not self.enabled:
            return "unified"
        return "prefill" if wid < self.prefill_workers else "decode"


@dataclass(frozen=True)
class StoreConfig:
    """How the shared block store holds its payloads and what happens to
    evicted blocks.

    ``kv_store_dtype='int8'`` quantizes user/item block payloads to
    symmetric per-(row, kv-head)-scaled int8 (the arena holds the
    dequantized bytes).  ``spill_mb`` bounds a host-RAM spill tier that
    device-tier evictions demote to instead of dropping; 0 drops.
    ``prefetch_pages_per_tick`` budgets the promotion of router-hinted
    spill blocks back to device pages, per engine tick (0: no prefetch;
    a spilled block then promotes when a request inserts it).  The
    default ``StoreConfig()`` is disabled: fp32 payloads, drop-on-evict,
    no prefetch."""

    kv_store_dtype: str = "fp32"
    spill_mb: int = 0
    prefetch_pages_per_tick: int = 0

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"invalid StoreConfig: {msg}")

        if self.kv_store_dtype not in ("fp32", "int8"):
            bad(f"kv_store_dtype={self.kv_store_dtype!r} not in ('fp32', 'int8')")
        if self.spill_mb < 0:
            bad(f"spill_mb={self.spill_mb} must be >= 0")
        if self.prefetch_pages_per_tick < 0:
            bad(f"prefetch_pages_per_tick={self.prefetch_pages_per_tick} must be >= 0")
        if self.prefetch_pages_per_tick > 0 and self.spill_mb == 0:
            bad(f"prefetch_pages_per_tick={self.prefetch_pages_per_tick} needs "
                "spill_mb > 0 (there is no spill tier to prefetch from)")

    @property
    def enabled(self) -> bool:
        """Does this config change the store at all?"""
        return self.kv_store_dtype != "fp32" or self.spill_mb > 0


@dataclass(frozen=True)
class ServeConfig:
    """Every serving knob the port has, validated once.  ``engine`` is
    ``"torch"`` (the port's engine) or ``"sim"`` (the analytic cluster
    simulator, `core.simulator`, whose ``mode="prefix"`` is the
    prefix-caching baseline it alone has).  ``k > 1`` serves a cluster of that many engine
    workers behind the ``policy`` router (`serving.cluster`), and
    ``disagg`` splits them into prefill and decode roles.  ``kv_reuse``
    turns on the shared block store and ``store`` configures its tiers.
    ``step_tokens=None`` resolves to ``max(4 * chunk_tokens, 512)``
    (`resolved_step_tokens`), the chunked scheduler's default budget.
    ``attn_backend`` (auto | plain | cuda) and ``decode_kernel`` (auto |
    gather | paged) pick the engine's kernels or their plain versions
    (`core.engine.attn_uses_kernels`, `decode_uses_paged`).  ``mesh``
    runs the engine as one rank of a tensor-parallel mesh.

    Under ``mesh.tp > 1`` the port keeps its kernels: ``attn_backend=
    'cuda'`` and ``decode_kernel='paged'`` stay valid and ``'auto'``
    resolves as without a mesh.  The reference rejects its Pallas
    kernels there because they are single-device programs under one
    controller; each rank of the port is a single-device program on its
    own heads, so the kernels run unchanged at the shard's shapes and
    compute the same function."""

    engine: str = "torch"
    k: int = 1
    mode: str = "rcllm"
    policy: str = "affinity"
    sched: str = "wave"
    attn_backend: str = "auto"
    decode_kernel: str = "auto"
    kv_reuse: bool = False
    chunk_tokens: int = 128
    step_tokens: Optional[int] = None
    max_batch_tokens: int = 4096
    max_decode_batch: int = 64
    page_size: int = 16
    n_pages: int = 512
    decode_steps: int = 4
    r_item: float = 0.3
    r_rev: float = 0.3
    mesh: MeshConfig = field(default_factory=MeshConfig)
    disagg: DisaggConfig = field(default_factory=DisaggConfig)
    store: StoreConfig = field(default_factory=StoreConfig)

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"invalid ServeConfig: {msg}")

        for name, val, choices in (
            ("engine", self.engine, ENGINES),
            ("mode", self.mode, MODES),
            ("policy", self.policy, POLICIES),
            ("sched", self.sched, SCHEDS),
            ("attn_backend", self.attn_backend, ATTN_BACKENDS),
            ("decode_kernel", self.decode_kernel, DECODE_KERNELS),
        ):
            if val not in choices:
                bad(f"{name}={val!r} not in {choices}")
        if self.engine == "sim":
            # the simulator runs no attention, has no pool and no
            # chunk-resumable prefill
            if self.attn_backend != "auto":
                bad(f"attn_backend={self.attn_backend!r} needs engine='torch' "
                    "(the simulator runs no attention)")
            if self.decode_kernel != "auto":
                bad(f"decode_kernel={self.decode_kernel!r} needs engine='torch' "
                    "(the simulator has no decode kernel)")
            if self.kv_reuse:
                bad("kv_reuse=True needs engine='torch' (no pool to share)")
            if self.sched == "chunked":
                bad("sched='chunked' needs engine='torch' (the simulator is wave-only)")
        elif self.mode == "prefix":
            bad("mode='prefix' is a simulator-only baseline; "
                "engine='torch' supports mode in ('rcllm', 'full')")
        if self.kv_reuse and self.mode != "rcllm":
            bad(f"kv_reuse=True needs mode='rcllm' (the shared block store holds "
                f"beyond-prefix blocks), got mode={self.mode!r}")
        if self.sched == "chunked" and self.mode != "rcllm":
            bad("sched='chunked' drives the beyond-prefix selective prefill; "
                f"mode={self.mode!r} has no chunk-resumable path")
        if self.k < 1:
            bad(f"k={self.k} must be >= 1")
        if self.chunk_tokens < 1:
            bad(f"chunk_tokens={self.chunk_tokens} must be >= 1")
        if self.step_tokens is not None and self.step_tokens < 1:
            bad(f"step_tokens={self.step_tokens} must be >= 1 (or None)")
        if self.page_size < 1 or self.n_pages < 2:
            bad(f"page_size={self.page_size} must be >= 1 and "
                f"n_pages={self.n_pages} >= 2 (page 0 is the scratch page)")
        if self.decode_steps < 1:
            bad(f"decode_steps={self.decode_steps} must be >= 1")
        if not (0.0 <= self.r_item <= 1.0 and 0.0 <= self.r_rev <= 1.0):
            bad(f"r_item={self.r_item}/r_rev={self.r_rev} must be in [0, 1]")
        if not isinstance(self.mesh, MeshConfig):
            bad(f"mesh must be a MeshConfig, got {type(self.mesh).__name__}")
        if self.mesh.enabled and self.engine != "torch":
            bad(f"mesh.tp={self.mesh.tp}/mesh.dp={self.mesh.dp} needs engine='torch' "
                f"(engine={self.engine!r} runs no devices)")
        if not isinstance(self.disagg, DisaggConfig):
            bad(f"disagg must be a DisaggConfig, got {type(self.disagg).__name__}")
        if self.disagg.enabled and self.engine != "torch":
            bad(f"disagg.prefill_workers={self.disagg.prefill_workers} needs "
                f"engine='torch' (engine={self.engine!r} has no KV to migrate)")
        if self.disagg.enabled and self.k != self.disagg.n_workers:
            bad(f"k={self.k} must equal disagg.prefill_workers + disagg.decode_workers "
                f"= {self.disagg.n_workers} (every cluster worker gets exactly one role)")
        if not isinstance(self.store, StoreConfig):
            bad(f"store must be a StoreConfig, got {type(self.store).__name__}")
        if self.store.enabled and self.engine != "torch":
            bad(f"store.kv_store_dtype={self.store.kv_store_dtype!r}/"
                f"store.spill_mb={self.store.spill_mb} needs engine='torch' "
                f"(engine={self.engine!r} has no block store)")
        if self.store.enabled and not self.kv_reuse:
            bad("store tiering configures the shared block store: set "
                "kv_reuse=on (the default store config is a no-op without it)")

    @property
    def resolved_step_tokens(self) -> int:
        if self.step_tokens is not None:
            return self.step_tokens
        return max(4 * self.chunk_tokens, 512)

    def replace(self, **kw) -> "ServeConfig":
        """A modified copy, re-validated."""
        return dataclasses.replace(self, **kw)

    def apply_to(self, lm_cfg):
        """The model-execution knobs (``attn_backend``, ``decode_kernel``)
        sliced onto an `LMConfig`.  The engine resolves them against the
        model's device when it is built."""
        return dataclasses.replace(lm_cfg, attn_backend=self.attn_backend,
                                   decode_kernel=self.decode_kernel)

    #: ``argparse`` attribute -> ServeConfig field for the launcher's
    #: per-knob flags (`--pages` is ``n_pages``; ``--kv-reuse off|on`` the
    #: bool)
    FLAG_FIELDS = {
        "engine": "engine", "k": "k", "mode": "mode", "policy": "policy", "sched": "sched",
        "attn_backend": "attn_backend", "decode_kernel": "decode_kernel",
        "kv_reuse": "kv_reuse", "chunk_tokens": "chunk_tokens",
        "step_tokens": "step_tokens", "max_batch_tokens": "max_batch_tokens",
        "page_size": "page_size", "pages": "n_pages", "decode_steps": "decode_steps",
        "r_item": "r_item", "r_rev": "r_rev",
    }
    SUBS = {"mesh": MeshConfig, "disagg": DisaggConfig, "store": StoreConfig}

    @classmethod
    def from_args(cls, args, base: Optional["ServeConfig"] = None) -> "ServeConfig":
        """Map a launcher's argparse namespace onto a config: only flags
        present and not None override `base` (the launcher declares them
        with ``default=None``, so ``--config`` holds where none is typed)."""
        overrides: Dict[str, object] = {}
        for attr, fld in cls.FLAG_FIELDS.items():
            val = getattr(args, attr, None)
            if val is None:
                continue
            if fld == "kv_reuse" and isinstance(val, str):
                val = val == "on"
            overrides[fld] = val
        base = base if base is not None else cls()
        return base.replace(**overrides) if overrides else base

    @classmethod
    def parse(cls, spec: str, base: Optional["ServeConfig"] = None) -> "ServeConfig":
        """A config from a ``key=value,key=value`` string (the launcher's
        ``--config``).  Values are coerced by the field's declared type;
        booleans accept on/off/true/false; sub-config fields nest with a
        dot (``mesh.tp=2``, ``mesh.mesh_shape=2x4``,
        ``mesh.axis_names=data+model``, ``disagg.prefill_workers=1``,
        ``store.spill_mb=64``).  The
        grammar is total: `render` emits a string that parses back to an
        equal config."""
        base = base if base is not None else cls()
        fields = {f.name: f for f in dataclasses.fields(cls)}
        sub_fields = {name: {f.name: f for f in dataclasses.fields(t)}
                      for name, t in cls.SUBS.items()}
        overrides: Dict[str, object] = {}
        sub_overrides: Dict[str, Dict[str, object]] = {n: {} for n in cls.SUBS}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"--config entry {part!r} is not key=value")
            key, val = (x.strip() for x in part.split("=", 1))
            prefix, _, sub = key.partition(".")
            if sub and prefix in cls.SUBS:
                flds = sub_fields[prefix]
                if sub not in flds:
                    raise ValueError(
                        f"--config key {key!r} is not a {cls.SUBS[prefix].__name__} "
                        f"field (choose from {sorted(prefix + '.' + f for f in flds)})")
                sub_overrides[prefix][sub] = _coerce(flds[sub], val)
                continue
            if key in cls.SUBS:
                raise ValueError(
                    f"--config {key} is a sub-config: set its fields as "
                    + ", ".join(f"{key}.{f}=..." for f in sub_fields[key]))
            if key not in fields:
                raise ValueError(f"--config key {key!r} is not a ServeConfig field "
                                 f"(choose from {sorted(fields)})")
            overrides[key] = _coerce(fields[key], val)
        for name, ov in sub_overrides.items():
            if ov:
                overrides[name] = dataclasses.replace(getattr(base, name), **ov)
        return base.replace(**overrides) if overrides else base

    def render(self) -> str:
        """The ``--config`` string of this config:
        ``ServeConfig.parse(cfg.render()) == cfg``."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in self.SUBS:
                parts += [f"{f.name}.{sf.name}={render_value(getattr(v, sf.name))}"
                          for sf in dataclasses.fields(v)]
            else:
                parts.append(f"{f.name}={render_value(v)}")
        return ",".join(parts)


def render_value(v) -> str:
    """One value in the ``--config`` grammar (`_coerce`'s inverse):
    booleans as on/off, None as none, int tuples ``x``-joined (mesh
    shapes, ``2x4``), string tuples ``+``-joined (axis names,
    ``data+model``)."""
    if isinstance(v, bool):
        return "on" if v else "off"
    if v is None:
        return "none"
    if isinstance(v, tuple):
        if all(isinstance(x, int) for x in v):
            return "x".join(str(x) for x in v)
        return "+".join(str(x) for x in v)
    return str(v)


def _coerce(fld: dataclasses.Field, val: str):
    t = fld.type        # a string: this module postpones annotations
    if "Tuple" in t:
        if val.lower() == "none" and "Optional" in t:
            return None
        if "int" in t:
            try:
                return tuple(int(x) for x in val.split("x"))
            except ValueError:
                raise ValueError(f"--config {fld.name}={val!r}: expected an "
                                 "'x'-separated int tuple like 2x4") from None
        return tuple(x for x in val.split("+") if x)
    if "bool" in t:
        low = val.lower()
        if low in ("on", "true", "1", "yes"):
            return True
        if low in ("off", "false", "0", "no"):
            return False
        raise ValueError(f"--config {fld.name}={val!r}: expected on/off")
    if val.lower() == "none" and "Optional" in t:
        return None
    try:
        if "int" in t:
            return int(val)
        if "float" in t:
            return float(val)
    except ValueError:
        raise ValueError(f"--config {fld.name}={val!r}: expected {t}") from None
    return val


# ------------------------------------------------------------- sampling
@dataclass(frozen=True)
class SamplingParams:
    """Per-sequence sampling.  ``temperature == 0`` is greedy argmax (the
    default, and the mode the parity tests pin); otherwise the token is
    drawn from softmax(logits / temperature), optionally top-k truncated,
    with a per-request numpy PRNG seeded from ``seed``."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def sample_token(logits: np.ndarray, params: SamplingParams = GREEDY,
                 rng: Optional[np.random.Generator] = None) -> int:
    """One token from one row of logits under `params`."""
    logits = np.asarray(logits, np.float64)
    if params.greedy or rng is None:
        return int(np.argmax(logits))
    z = logits / params.temperature
    if params.top_k and params.top_k < len(z):
        kth = np.partition(z, -params.top_k)[-params.top_k]
        z = np.where(z >= kth, z, -np.inf)
    z = z - np.max(z)
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


def match_stop(generated: Sequence[int], stops: Sequence[Tuple[int, ...]]) -> bool:
    """Does the generated stream end with any stop sequence?"""
    for s in stops:
        n = len(s)
        if n and len(generated) >= n and tuple(generated[-n:]) == tuple(s):
            return True
    return False


# ------------------------------------------------------ session protocol
@dataclass(frozen=True)
class SubmitRequest:
    """One client request to the session server (`serving.server`).

    ``tokens`` is the prompt (int32 ids).  ``max_tokens`` bounds the
    generated stream, prefill's first token included; ``stop`` is a tuple
    of token-id sequences, and generation ends the moment the stream ends
    with one of them (the matching tokens are kept).  ``context`` carries
    an rcllm request's ``(plan, block_table, positions, have)`` and
    ``reuse`` its `block_store.RequestReuse`; both are None for
    mode='full' prompts.
    """

    rid: int
    tokens: np.ndarray
    max_tokens: int = 4
    stop: Tuple[Tuple[int, ...], ...] = ()
    sampling: SamplingParams = GREEDY
    context: Optional[tuple] = field(default=None, repr=False)
    reuse: Optional[object] = field(default=None, repr=False)

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens={self.max_tokens} must be >= 1")
        if any(len(s) == 0 for s in self.stop):
            raise ValueError("empty stop sequence")


@dataclass(frozen=True)
class StreamEvent:
    """One element of a session's event stream.  Exactly one event per
    stream has ``finished=True`` (its ``token`` is None); ``reason`` is
    then one of `FINISH_REASONS`."""

    rid: int
    index: int  # 0-based position in the generated stream
    token: Optional[int]
    t_s: float  # server wall clock (seconds since the server was built)
    finished: bool = False
    reason: Optional[str] = None


@dataclass(frozen=True)
class Completion:
    """Terminal view of one session: every generated token and its
    latency split.  Not `batching.Completion`, the scheduling loop's
    record of a request."""

    rid: int
    tokens: Tuple[int, ...]
    reason: str
    submitted_s: float
    first_token_s: Optional[float]
    done_s: float

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submitted_s


# ------------------------------------------------------- sliced builders
def build_engine(model, lm_cfg, config: ServeConfig, pool=None, sel=None,
                 cache=None, batched_selective: bool = True):
    """`BatchEngine` on the model's device from the config's pool, reuse,
    execution and mesh slices (`ServeConfig.apply_to`); `cache` is the
    device pool of cached rows (`RcLLMSystem.rows`) that rcllm requests'
    block tables index.

    With ``config.mesh`` enabled this is one rank's engine: the mesh is
    built over the process group (`MeshConfig.build`), its model axis
    must divide both head counts, a whole `model` is cut to the rank's
    shard (`sharding.specs.shard_lm_params`; an rcllm `cache` must
    already hold the rank's kv heads: `core.rcllm.make_system(mesh=)`),
    and the pool holds the rank's kv heads.  The engine runs inside
    ``sharding.ctx.axes(mesh)``."""
    from repro_torch.core import engine as ENG
    from repro_torch.serving.batch_engine import BatchEngine
    from repro_torch.serving.block_store import SharedBlockStore
    from repro_torch.serving.kv_pool import pool_for
    from repro_torch.sharding import specs as SPECS

    lm_cfg = config.apply_to(lm_cfg)
    if config.mesh.enabled:
        SPECS.check_serving_divisibility(lm_cfg, config.mesh)
    mesh = config.mesh.build()
    if mesh is not None:
        if model.tp == 1 and mesh.shape["model"] > 1:
            model = SPECS.shard_lm_params(model, lm_cfg, mesh)
    if pool is None:
        pool = pool_for(lm_cfg, page_size=config.page_size,
                        n_pages=config.n_pages, device=model.device, mesh=mesh)
    if sel is None:
        sel = ENG.SelectiveConfig(r_item=config.r_item, r_rev=config.r_rev)
    store = None
    if config.kv_reuse:
        store = SharedBlockStore(
            pool, kv_store_dtype=config.store.kv_store_dtype,
            spill_mb=config.store.spill_mb,
            prefetch_pages_per_tick=config.store.prefetch_pages_per_tick)
    return BatchEngine(model, lm_cfg, pool=pool, sel=sel, cache=cache,
                       chunk_tokens=config.chunk_tokens, store=store,
                       batched_selective=batched_selective, mesh=mesh)


def build_backend(engine, config: ServeConfig, plans=None, reuse=None):
    """`TorchEngineBackend` over a built engine (mode slice); `reuse` is
    read only by a store-backed engine."""
    from repro_torch.serving.batching import TorchEngineBackend

    return TorchEngineBackend(engine, mode=config.mode, plans=plans, reuse=reuse)


def build_batcher(backend, config: ServeConfig):
    """`ContinuousBatcher` over a backend (scheduler slice)."""
    from repro_torch.serving.batching import ContinuousBatcher

    return ContinuousBatcher(backend, max_batch_tokens=config.max_batch_tokens,
                             max_decode_batch=config.max_decode_batch,
                             sched=config.sched, chunk_tokens=config.chunk_tokens,
                             step_tokens=config.resolved_step_tokens)
