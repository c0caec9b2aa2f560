"""Port parity for the LM architectures' serving steps: `prefill` and
`decode_step` of every LM arch of the registry at reduced() size against
the JAX package's, a sliding window that binds in both, the port's own
decode-vs-prefill equivalence, and the launcher's prefill / decode cells.

Weights are the reference's init, carried across through numpy
(`params_from_numpy`); tokens are drawn with numpy.  Both run in fp32 on
the CPU, where only the order of sums differs: logits and caches are held
to atol = rtol = 1e-5 (TOL), greedy tokens must be equal."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro_torch.configs import registry as TR
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

LM_ARCHS = [a for a in JR.ARCHS if JR.family_of(a) == "lm"]
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _pair(arch, **replace):
    jcfg = dataclasses.replace(JR.get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(TR.get_config(arch, smoke=True), **replace)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, params, model


def _pad(cache, extra):
    return np.pad(np.asarray(cache), ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))


def _run_both(jcfg, params, model, toks, positions, steps, extra):
    """Prefill `toks` in both packages, then `steps` greedy decode steps
    at per-row `positions` in caches padded by `extra` slots; every
    output held to TOL.  -> the port's logits of each step."""
    jl, jc = jax.jit(JT.prefill, static_argnums=2)(params, jnp.asarray(toks), jcfg)
    tl, tc = TT.prefill(model, torch.from_numpy(toks))
    assert tl.shape == (toks.shape[0], jcfg.vocab_size)
    _close(tl.numpy(), jl)
    for n in "kv":
        assert tc[n].shape == jc[n].shape
        _close(tc[n].numpy(), jc[n])
    jcache = {n: jnp.asarray(_pad(jc[n], extra)) for n in "kv"}
    tcache = {n: torch.from_numpy(_pad(jc[n], extra)) for n in "kv"}
    dec = jax.jit(JT.decode_step, static_argnums=4)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    out = []
    for _ in range(steps):
        jl, jcache = dec(params, jnp.asarray(nxt[:, None]), jcache, jnp.asarray(pos), jcfg)
        tl, tcache = TT.decode_step(model, torch.from_numpy(nxt[:, None]), tcache,
                                    torch.from_numpy(pos))
        _close(tl.numpy(), jl)
        for n in "kv":
            _close(tcache[n].numpy(), jcache[n])
        assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))
        out.append(tl)
        nxt, pos = tl.argmax(-1).numpy().astype(np.int32), pos + 1
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """40-token prompts (chunks of 32: padded), then 3 decode steps at
    staggered positions 40 and 37 in a cache of capacity 48."""
    jcfg, params, model = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    _run_both(jcfg, params, model, toks, [40, 37], steps=3, extra=8)


def test_sliding_window_binds_in_prefill_and_decode():
    """starcoder2 at reduced() size with an 8-token window (reduced()
    itself has none): a 40-token prefill over two padded chunks, then
    decode steps 4 to 12 positions past the window; the window changes
    the logits, so it binds."""
    jcfg, params, model = _pair("starcoder2-15b", sliding_window=8)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    logits = _run_both(jcfg, params, model, toks, [12, 20], steps=3, extra=8)
    unwindowed = dataclasses.replace(model.cfg, sliding_window=None)
    model.cfg = unwindowed
    full, _ = TT.prefill(model, torch.from_numpy(toks))
    model.cfg = dataclasses.replace(unwindowed, sliding_window=8)
    windowed, _ = TT.prefill(model, torch.from_numpy(toks))
    assert float((full - windowed).abs().max()) > 1e-2
    assert all(torch.isfinite(lg).all() for lg in logits)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "starcoder2-15b", "gemma-7b"])
def test_decode_matches_prefill(arch):
    """The port's own equivalence (the reference's
    `test_decode_matches_forward`): decoding token 33 after a 32-token
    prefill gives the 33-token prefill's last logits (fp32: summation
    order only).  Dense archs: an MoE's capacity is per call (C = 1 at
    2 decode tokens), so its routes may drop at decode and not in the
    prefill, in the reference as in the port."""
    jcfg, _, model = _pair(arch)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32))
    want, _ = TT.prefill(model, toks)
    _, cache = TT.prefill(model, toks[:, :32])
    cache = {n: torch.from_numpy(_pad(cache[n], 8)) for n in "kv"}
    got, _ = TT.decode_step(model, toks[:, 32:], cache, torch.tensor([32, 32]))
    _close(got.numpy(), want.numpy(), 1e-4)


def test_decode_writes_the_caller_cache_in_place():
    _, _, model = _pair("starcoder2-15b")
    cfg = model.cfg
    batch = TR.make_batch(cfg, "decode_32k", torch.Generator().manual_seed(0), "cpu",
                          batch=2, seq=24)
    cache = batch["cache"]
    ptrs = {n: cache[n].data_ptr() for n in "kv"}
    before = {n: cache[n].clone() for n in "kv"}
    logits, out = TT.decode_step(model, batch["tokens"], cache, batch["positions"])
    assert out is cache and all(cache[n].data_ptr() == ptrs[n] for n in "kv")
    pos = batch["positions"].long()
    for n in "kv":
        changed = (cache[n] != before[n]).any(-1).any(-1)                # (L, B, S)
        want = torch.zeros_like(changed)
        want[:, torch.arange(2), pos] = True
        assert torch.equal(changed, want)
    assert logits.shape == (2, cfg.vocab_size)


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch,shape", [("moonshot-v1-16b-a3b", "decode_32k"),
                                        ("gemma-7b", "prefill_32k"),
                                        ("starcoder2-15b", "long_500k")])
def test_steps_run_the_lm_cells(arch, shape, capsys):
    rep = TS.main(["--device", "cpu", "--smoke", "--arch", arch, "--shape", shape,
                   "--batch", "2", "--seq", "48", "--repeats", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    step = JR.LM_SHAPES[shape].step
    assert rep["step"] == step and rep["batch"] == 2 and rep["seq"] == 48
    assert rep["device"] == "cpu" and rep["finite"] and rep["peak_gb"] is None
    assert rep["out_shape"] == [2, TR.get_config(arch, True).vocab_size]
    tokens = 2 * (48 if step == "prefill" else 1)
    assert rep["tokens_per_s"] == pytest.approx(tokens / (rep["ms_per_call"] / 1e3))


def test_steps_refuse_the_training_cell_and_other_families():
    with pytest.raises(ValueError, match="training slice"):
        TS.step_of("train_4k")
    for argv in (["--arch", "gemma-7b", "--shape", "serve_p99"],
                 ["--arch", "wide-deep", "--shape", "prefill_32k"],
                 ["--arch", "wide-deep", "--shape", "serve_p99", "--seq", "8"]):
        with pytest.raises(SystemExit):
            TS.main(["--device", "cpu", "--smoke"] + argv)
