"""The port's attention-backend seam (`LMConfig.attn_backend` /
`decode_kernel`, `ServeConfig.apply_to`, `core.engine.attn_uses_kernels`
/ `decode_uses_paged`, `BatchEngine(batched_selective=)`), the
counterpart of the reference's `tests/test_attn_backend.py`:

* backend parity: the port's plain backend (its kernels' plain PyTorch
  versions) decodes the reference jnp backend's greedy tokens through full
  and rcllm prefill and DECODE_STEPS paged decode steps, prefill logits
  within LOGIT_TOL, whichever decode path the reference pins;
* the resolution of every (backend, decode kernel, device) triple, and
  the ValueErrors of an invalid one;
* the plain backend never calls a kernel wrapper, on any device;
* path parity: the batched rcllm prefill equals the per-request loop
  (logits and pool contents within PATH_TOL, recompute masks and tokens
  equal).

Inputs are the reference's tiny system and trace; the port serves the
JAX init converted through numpy, fp32 on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JENG
from repro.serving.batch_engine import BatchEngine as JBatchEngine
from repro.serving.kv_pool import pool_for as jpool_for
from repro.serving.workload import rcllm_batch_requests as j_batch_requests
from repro_torch.configs.base import LMConfig
from repro_torch.core import engine as TENG
from repro_torch.core.rcllm import make_tiny_system, tiny_config
from repro_torch.data import synth as TSY
from repro_torch.kernels.block_gather import ops as BO
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import api as API
from repro_torch.serving import batch_engine as TBE
from repro_torch.serving.batching import TorchEngineBackend
from repro_torch.serving.kv_pool import pool_for
from repro_torch.serving.workload import rcllm_batch_requests

DECODE_STEPS = 3
LOGIT_TOL = 1e-4     # logits after the whole stack: summation order
PATH_TOL = 1e-5      # batched against per-request: one fp32 model, other batch shapes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread for this module: under pytest-xdist several
    test processes share the cores, and torch's threads a process then
    oversubscribe them, which slows these CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    from repro.core.rcllm import make_tiny_system as jax_tiny
    from repro.data import synth as JSY
    jsys, pool_rv, prof, _ = jax_tiny(n_items=60, n_requests_hist=30, k_instances=2,
                                      n_layers=2, d_model=32)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.params),
                              tiny_config(2, 32), device="cpu")
    tsys, _, _, _ = make_tiny_system(n_items=60, n_requests_hist=30, k_instances=2,
                                     n_layers=2, d_model=32, device="cpu", model=model)
    kw = dict(qps=2.0, n_users=3, n_candidates=8, reviews_per_user=1, seed=21)
    jreqs = j_batch_requests(jsys, JSY.make_trace(jsys.catalog, pool_rv, prof, 4, **kw),
                             n_reserve=DECODE_STEPS)
    treqs = rcllm_batch_requests(tsys, TSY.make_trace(tsys.catalog, pool_rv, prof, 4, **kw),
                                 n_reserve=DECODE_STEPS)
    return jsys, tsys, jreqs, treqs, (pool_rv, prof, kw)


def _greedy(eng, brs, mode):
    """Prefill + DECODE_STEPS greedy steps.  -> ({rid: tokens}, logits)."""
    logits = eng.prefill(brs, mode=mode)
    last = {r.rid: int(np.argmax(lg)) for r, lg in zip(brs, logits)}
    toks = {rid: [t] for rid, t in last.items()}
    rids = [r.rid for r in brs]
    for _ in range(DECODE_STEPS):
        out = eng.decode(rids, [last[r] for r in rids])
        for i, rid in enumerate(rids):
            last[rid] = int(np.argmax(out[i]))
            toks[rid].append(last[rid])
    return toks, logits


def _port(tsys, treqs, mode, backend="plain", decode_kernel="auto",
          batched_selective=True):
    cfg = dataclasses.replace(tsys.cfg, attn_backend=backend, decode_kernel=decode_kernel)
    eng = TBE.BatchEngine(tsys.model, cfg, pool=pool_for(cfg, n_pages=256, device="cpu"),
                          bucket=64, cache=tsys.rows, batched_selective=batched_selective)
    return (*_greedy(eng, treqs, mode), eng)


@pytest.fixture(scope="module")
def port_run(systems):
    """`_port` over the module's requests, each configuration served once
    (the tests only read what a run returns)."""
    _, tsys, _, treqs, _ = systems
    runs = {}

    def run(mode, **kw):
        key = (mode,) + tuple(sorted(kw.items()))
        if key not in runs:
            runs[key] = _port(tsys, treqs, mode, **kw)
        return runs[key]
    return run


def _reference(jsys, jreqs, mode, decode_kernel):
    cfg = dataclasses.replace(jsys.cfg, attn_backend="jnp", decode_kernel=decode_kernel)
    eng = JBatchEngine(jsys.params, cfg, pool=jpool_for(cfg, n_pages=256), bucket=64)
    return _greedy(eng, jreqs, mode)


@pytest.mark.parametrize("decode_kernel", ["gather", "paged"])
@pytest.mark.parametrize("mode", ["full", "rcllm"])
def test_plain_backend_decodes_the_reference_tokens(systems, port_run, mode, decode_kernel):
    """The port's plain backend against the reference's jnp backend with
    its decode on the gather path or pinned to the paged kernel
    (interpret mode): tokens equal, prefill logits within LOGIT_TOL."""
    jsys, _, jreqs, _, _ = systems
    toks_j, logits_j = _reference(jsys, jreqs, mode, decode_kernel)
    toks_t, logits_t, eng = port_run(mode)
    assert not eng.attn_kernels and not eng.paged
    np.testing.assert_allclose(logits_t, logits_j, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert toks_t == toks_j


@pytest.mark.parametrize("mode", ["full", "rcllm"])
def test_decode_pin_leaves_prefill_bitwise(port_run, mode):
    """decode_kernel touches decode only: on the CPU "auto" and "gather"
    give bitwise the same prefill logits and tokens, and "auto" resolves
    to the plain backend."""
    toks_a, logits_a, eng_a = port_run(mode, backend="auto")
    toks_g, logits_g, _ = port_run(mode, decode_kernel="gather")
    assert not eng_a.attn_kernels and not eng_a.paged
    np.testing.assert_array_equal(logits_a, logits_g)
    assert toks_a == toks_g


def test_engine_selective_plain_matches_the_reference_kv(systems):
    """Engine level: the plain backend's selective prefill returns the
    reference jnp backend's recompute mask, merged KV and logits."""
    jsys, tsys, jreqs, treqs, _ = systems
    j, t = jreqs[1], treqs[1]
    sel = JENG.SelectiveConfig()
    lj, sj, kj, vj = JENG.selective_prefill_with_kv(
        jsys.params, jsys.cfg, j.plan, j.cached_k, j.cached_v, j.have, sel, bucket=64)
    cfg = dataclasses.replace(tsys.cfg, attn_backend="plain")
    (lt, st, kt, vt), = TENG.selective_prefill_batch(
        tsys.model, cfg, [(t.plan, t.block_table, t.positions, t.have)],
        TENG.SelectiveConfig(), tsys.rows, bucket=64)
    np.testing.assert_array_equal(st.recompute_mask, sj.recompute_mask)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=PATH_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=PATH_TOL)
    np.testing.assert_allclose(lt, np.asarray(lj), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_batched_rcllm_matches_per_request(systems, port_run):
    """The bucketed batched selective prefill computes the per-request
    loop's function: logits and pool contents within PATH_TOL, recompute
    masks and greedy tokens equal."""
    treqs = systems[3]
    toks_b, logits_b, eng_b = port_run("rcllm")
    toks_l, logits_l, eng_l = port_run("rcllm", batched_selective=False)
    np.testing.assert_allclose(logits_l, logits_b, atol=PATH_TOL, rtol=PATH_TOL)
    assert toks_b == toks_l
    for r in treqs:
        np.testing.assert_array_equal(eng_b.last_stats[r.rid].recompute_mask,
                                      eng_l.last_stats[r.rid].recompute_mask)
        for a, b in zip(eng_b.pool.gather(r.rid), eng_l.pool.gather(r.rid)):
            np.testing.assert_allclose(b, a, atol=PATH_TOL, rtol=PATH_TOL)


# (attn_backend, decode_kernel, device) -> (kernels, paged), or the knob
# that raises
RESOLVED = {
    ("auto", "auto", "cpu"): (False, False), ("auto", "auto", "cuda"): (True, True),
    ("auto", "gather", "cpu"): (False, False), ("auto", "gather", "cuda"): (True, False),
    ("auto", "paged", "cpu"): "decode", ("auto", "paged", "cuda"): (True, True),
    ("plain", "auto", "cpu"): (False, False), ("plain", "auto", "cuda"): (False, False),
    ("plain", "gather", "cpu"): (False, False), ("plain", "gather", "cuda"): (False, False),
    ("plain", "paged", "cpu"): "decode", ("plain", "paged", "cuda"): (False, True),
    ("cuda", "auto", "cpu"): "attn", ("cuda", "auto", "cuda"): (True, True),
    ("cuda", "gather", "cpu"): "attn", ("cuda", "gather", "cuda"): (True, False),
    ("cuda", "paged", "cpu"): "attn", ("cuda", "paged", "cuda"): (True, True),
}


@pytest.mark.parametrize("backend,decode_kernel,device", sorted(RESOLVED))
def test_resolution_of_every_triple(backend, decode_kernel, device):
    """Resolution reads only the device's type: no card is needed to
    resolve for one."""
    cfg = dataclasses.replace(tiny_config(2, 32), attn_backend=backend,
                              decode_kernel=decode_kernel)
    dev = torch.device(device)
    want = RESOLVED[(backend, decode_kernel, device)]
    if want == "attn":
        with pytest.raises(ValueError, match="attn_backend='cuda'"):
            TENG.attn_uses_kernels(cfg, dev)
        return
    kernels = TENG.attn_uses_kernels(cfg, dev)
    if want == "decode":
        with pytest.raises(ValueError, match="decode_kernel='paged'"):
            TENG.decode_uses_paged(cfg, dev)
        return
    assert (kernels, TENG.decode_uses_paged(cfg, dev)) == want


def test_invalid_knobs_raise(systems):
    _, tsys, _, _, _ = systems
    base = tiny_config(2, 32)
    for kw in ({"attn_backend": "jnp"}, {"attn_backend": "pallas"},
               {"decode_kernel": "fused"}):
        with pytest.raises(ValueError):
            dataclasses.replace(base, **kw)
        with pytest.raises(ValueError, match="invalid ServeConfig"):
            API.ServeConfig(**kw)
    with pytest.raises(ValueError, match="needs engine='torch'"):
        API.ServeConfig(engine="sim", attn_backend="plain")
    with pytest.raises(ValueError, match="needs engine='torch'"):
        API.ServeConfig(engine="sim", decode_kernel="gather")
    # a CPU model cannot run the kernels: the engine refuses at construction
    for kw in ({"attn_backend": "cuda"}, {"decode_kernel": "paged"}):
        with pytest.raises(ValueError):
            API.build_engine(tsys.model, tsys.cfg, API.ServeConfig(**kw), cache=tsys.rows)
        with pytest.raises(ValueError):
            TBE.BatchEngine(tsys.model, dataclasses.replace(tsys.cfg, **kw),
                            pool=pool_for(tsys.cfg, n_pages=8, device="cpu"))
    with pytest.raises(ValueError):
        TENG.precompute_kv_batch(tsys.model, dataclasses.replace(tsys.cfg, attn_backend="cuda"),
                                 [np.arange(1, 9, dtype=np.int32)])
    assert LMConfig.__dataclass_fields__["attn_backend"].default == "auto"


def test_apply_to_slices_both_knobs_and_the_backend_reports_them(systems):
    _, tsys, _, _, _ = systems
    config = API.ServeConfig(attn_backend="plain", decode_kernel="gather")
    cfg = config.apply_to(tsys.cfg)
    assert (cfg.attn_backend, cfg.decode_kernel) == ("plain", "gather")
    assert dataclasses.replace(cfg, attn_backend="auto", decode_kernel="auto") == tsys.cfg
    engine = API.build_engine(tsys.model, tsys.cfg, config, cache=tsys.rows)
    assert engine.cfg.attn_backend == "plain" and engine.batched_selective
    backend = TorchEngineBackend(engine, mode="rcllm")
    assert (backend.attn_backend, backend.decode_kernel) == ("plain", "gather")
    assert API.ServeConfig.parse(config.render()) == config
    assert API.ServeConfig.parse("attn_backend=plain,decode_kernel=gather") == config


def test_plain_backend_calls_no_kernel_wrapper(systems, monkeypatch):
    """The seam picks the plain versions above the wrappers: with every
    wrapper made to raise, the plain backend still serves full and rcllm
    requests (prefill, decode and the chunked scan)."""
    _, tsys, _, treqs, (pool_rv, prof, kw) = systems
    trace = TSY.make_trace(tsys.catalog, pool_rv, prof, 3, **kw)
    reqs, plans, _ = PS.rcllm_requests(tsys, trace, decode_steps=2)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called under the plain backend")

    for mod, name in ((TENG, "mha_flash"), (TENG, "selective_mha"),
                      (TBE, "paged_decode_mha"), (BO.PoolGather, "__call__"),
                      (BO.PoolGather, "__init__")):
        monkeypatch.setattr(mod, name, refuse)
    for mode in ("full", "rcllm"):
        toks, logits, _ = _port(tsys, treqs[:2], mode)
        assert np.isfinite(logits).all() and all(len(t) == DECODE_STEPS + 1
                                                 for t in toks.values())
    config = API.ServeConfig(attn_backend="plain", sched="chunked", chunk_tokens=64,
                             decode_steps=2)
    _, backend, _, done = PS.serve(tsys.model, tsys.cfg, config, reqs, plans, tsys.rows)
    assert len(done) == len(reqs) and backend.attn_backend == "plain"


def test_launcher_reports_the_resolved_routes(capsys):
    import json
    PS.main(["--device", "cpu", "--requests", "2", "--decode-steps", "2",
             "--attn-backend", "plain", "--decode-kernel", "gather"])
    out = json.loads(capsys.readouterr().out)
    assert (out["attn_backend"], out["decode_kernel"]) == ("plain", "gather")
    assert out["requests"] == 2
