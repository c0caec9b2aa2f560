"""Port parity for the planted-preference protocol
(`repro_torch.core.ranker_training`) against the JAX package's
`core/ranker_training.py`: the planted trace and its batches equal the
reference's exactly for the same seeds, and 20 `train_ranker` steps (a
2-layer tiny model, batches of 4) from the reference's weights
(converted through numpy) give the reference's loss history on the CPU
in fp32 (the first within 1e-5 relative; later ones within 1e-3: the
same data, with Adam's near-sign first steps amplifying the packages'
fp32 rounding differences step by step)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import LMConfig
from repro.core import ranker_training as JRT
from repro.data import synth as JSY
from repro.models import transformer as JT
from repro_torch.core import ranker_training as TRT
from repro_torch.core.rcllm import synthetic_world, tiny_config
from repro_torch.data import synth as TSY
from repro_torch.models.convert import params_from_numpy


# 4 candidates (the card's protocol has 8) keep the prompts near 400
# tokens; the training test also halves the tiny model's depth (2 layers)
# and its batch (4): the reference's CPU training of the full tiny model
# takes ~1 s a step
N_CANDIDATES = 4


def _reference_world(n_items=150, n_hist=60, seed=0):
    """The reference's `make_tiny_system` world, without its offline build."""
    prof = dataclasses.replace(JSY.PROFILES["amazon"], n_items=n_items,
                               n_clusters=max(6, n_items // 50),
                               mean_item_tokens=24, mean_review_tokens=20)
    catalog = JSY.make_catalog(prof, vocab_size=4096, seed=seed)
    pool = JSY.make_review_pool(vocab_size=4096, n_phrases=120, seed=seed + 1)
    return prof, catalog, pool


@pytest.fixture(scope="module")
def worlds():
    jprof, jcat, jpool = _reference_world()
    tprof, tcat, tpool, _, _ = synthetic_world("amazon", 150, 60, 0)
    jreq, jgold = JRT.make_planted_trace(jcat, jpool, jprof, n_requests=60,
                                         n_candidates=N_CANDIDATES, seed=5)
    treq, tgold = TRT.make_planted_trace(tcat, tpool, tprof, n_requests=60,
                                         n_candidates=N_CANDIDATES, seed=5)
    return (jcat, jreq, jgold), (tcat, treq, tgold)


def test_planted_trace_and_batches_equal_the_reference(worlds):
    (jcat, jreq, jgold), (tcat, treq, tgold) = worlds
    np.testing.assert_array_equal(tgold, jgold)
    assert len(treq) == len(jreq)
    for t, j in zip(treq, jreq):
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
    jins = JSY.make_instruction(207, 4096)
    tins = TSY.make_instruction(207, 4096)
    np.testing.assert_array_equal(tins, jins)
    for a, b in zip(TRT._batchify(treq, tgold, tcat, tins, 512),
                    JRT._batchify(jreq, jgold, jcat, jins, 512)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_twenty_train_steps_match_the_reference_loss_history(worlds):
    (jcat, jreq, jgold), (tcat, treq, tgold) = worlds
    tcfg = tiny_config(n_layers=2)
    jcfg = LMConfig(name="rcllm-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=4096, mlp_type="swiglu",
                    dtype="float32", attn_q_chunk=64, attn_kv_chunk=64, remat=False)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    ins = JSY.make_instruction(207, 4096)
    _, thist = TRT.train_ranker(model, tcfg, tcat, ins, treq[:24], tgold[:24], steps=20,
                                batch_size=4, log_every=1)
    _, jhist = JRT.train_ranker(params, jcfg, jcat, ins, jreq[:24], jgold[:24], steps=20,
                                batch_size=4, log_every=1)
    assert [s for s, _ in thist] == [s for s, _ in jhist] == list(range(20))
    t, j = np.array([v for _, v in thist]), np.array([v for _, v in jhist])
    assert t[0] == pytest.approx(j[0], rel=1e-5)
    np.testing.assert_allclose(t, j, rtol=1e-3)
    assert t[-1] < t[0]
    assert not any(p.requires_grad for p in model.parameters())
