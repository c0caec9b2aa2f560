"""The port's training infrastructure (`repro_torch.training.train_loop`,
`checkpoint`, `data.pipeline`) against the JAX package's:

* one jitted reference train step against the port's, on a small
  least-squares model fed the same numpy batches and weights: one
  microbatch and four, no compression, int8 and top-k with error
  feedback; losses, gradient norms and parameters after three steps
  within 1e-6 (fp32, the same formulas);
* compression functions against the reference's (int8 exact, top-k
  exact with its error);
* checkpoints: a round trip in the reference's `b"F"` format (bf16, int
  and nested leaves), `gc_old`, a `b"F"` file written by the reference
  read by the port, writing without msgpack or zstandard installed;
* the loop: auto-resume, retries, a restore from the latest checkpoint
  after injected failures whose loss history equals an uninterrupted
  run's, and the reference's own loop test mirrored;
* the pipeline's seeds and host slicing equal the reference's."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.checkpoint import checkpoint as JCK
from repro.data import pipeline as JP
from repro.training import optimizer as JO
from repro.training import train_loop as JTL
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.configs import registry as TR
from repro_torch.data import pipeline as TP
from repro_torch.models import transformer as TT
from repro_torch.training import train_loop as TTL
from repro_torch.training.train_loop import TrainConfig

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6


class LeastSquares(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w), requires_grad=False)
        self.b = nn.Parameter(torch.tensor(b), requires_grad=False)


def _ls_loss_jax(p, batch):
    return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)


def _ls_loss_torch(m, batch):
    return torch.mean((batch["x"] @ m.w + m.b - batch["y"]) ** 2)


def _ls_batches(rng, n=3, b=8):
    return [{"x": rng.standard_normal((b, 5)).astype(np.float32),
             "y": rng.standard_normal((b, 2)).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("compression", [None, "int8", "topk"])
def test_train_step_matches_the_reference(microbatches, compression):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 2)).astype(np.float32)
    b = rng.standard_normal((2,)).astype(np.float32)
    batches = _ls_batches(rng)
    cfg = TrainConfig(microbatches=microbatches, grad_compression=compression,
                      topk_frac=0.3, lr=0.05)
    init, update = JO.get("adamw", lr=cfg.lr)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    js = init(jp)
    jerr = {k: jnp.zeros(v.shape) for k, v in jp.items()} if compression == "topk" else ()
    jstep = JTL.make_train_step(_ls_loss_jax, cfg, update)
    model = LeastSquares(w, b)
    with TTL.trainable(model) as named:
        opt = TTL.OPT.get("adamw", named, lr=cfg.lr)
        err = ([torch.zeros_like(p) for _, p in named] if compression == "topk" else None)
        step = TTL.make_train_step(_ls_loss_torch, cfg, model, opt, err)
        for batch in batches:
            jp, js, jerr, jm = jstep(jp, js, jerr, jax.tree_util.tree_map(jnp.asarray, batch))
            tm = step(batch)
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL)
            assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)
    np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(jp["w"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(jp["b"]), rtol=TOL,
                               atol=TOL)
    assert not model.w.requires_grad


def test_compression_matches_the_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((64, 8)).astype(np.float32)
    e = (rng.standard_normal((64, 8)) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(TTL.compress_int8(torch.tensor(g)).numpy(),
                                  np.asarray(JTL.compress_int8(jnp.asarray(g))))
    sent, err = TTL.compress_topk(torch.tensor(g), 0.25, torch.tensor(e))
    jsent, jerr = JTL.compress_topk(jnp.asarray(g), 0.25, jnp.asarray(e))
    np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0, atol=1e-7)
    cos = float((sent * torch.tensor(g)).sum() / (sent.norm() * np.linalg.norm(g)))
    assert cos > 0.5 and int((sent != 0).sum()) == 128


def test_checkpoint_round_trip_gc_and_format(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.zeros(4), {"c": torch.ones((2, 2), dtype=torch.bfloat16)}],
            "n": TTL.OPT.OptState(step=7, inner={"w": {"m": torch.full((3,), 0.5)}}),
            "i": np.arange(5, dtype=np.int32)}
    for s in (1, 2, 3, 4, 5):
        TCK.save(str(tmp_path), s, tree)
    TCK.gc_old(str(tmp_path), keep=2)
    assert sorted(int(f[5:13]) for f in os.listdir(tmp_path) if f.endswith(".ckpt")) == [4, 5]
    assert TCK.latest_step(str(tmp_path)) == 5
    assert (tmp_path / "step_00000005.ckpt").read_bytes()[:1] == b"F"
    out = TCK.restore(str(tmp_path), 5, tree)
    assert out["n"].step == 7 and isinstance(out["n"], TTL.OPT.OptState)
    assert out["b"][1]["c"].dtype == torch.bfloat16
    for (ka, a), (kb, b) in zip(TCK.flatten(out), TCK.flatten(tree)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(torch.as_tensor(a).float()),
                                      np.asarray(torch.as_tensor(b).float()))


def test_reads_a_reference_flat_checkpoint(tmp_path, monkeypatch):
    """A `b"F"` file written by the JAX package (its fallback format)
    restores in the port, leaf for leaf."""
    monkeypatch.setattr(JCK, "_HAVE_MSGPACK", False)
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "layers": [{"k": np.full((2,), 3, np.int32)}]}
    JCK.save(str(tmp_path), 3, tree)
    like = {"w": torch.zeros(3, 4), "layers": [{"k": torch.zeros(2, dtype=torch.int32)}]}
    out = TCK.restore(str(tmp_path), 3, like)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(out["layers"][0]["k"].numpy(), tree["layers"][0]["k"])


def test_checkpoint_needs_neither_msgpack_nor_zstandard(tmp_path):
    code = ("import sys; sys.modules['msgpack'] = None; sys.modules['zstandard'] = None\n"
            "import torch\n"
            "from repro_torch.checkpoint import checkpoint as C\n"
            f"d = {str(tmp_path)!r}\n"
            "ck = C.AsyncCheckpointer(d, keep=1)\n"
            "ck.save_async(1, {'x': torch.ones(3)})\n"
            "ck.save_async(2, {'x': torch.full((3,), 2.)})\n"
            "ck.close()\n"
            "print(C.latest_step(d), C.restore(d, 2, {'x': torch.zeros(3)})['x'].tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2 [2.0, 2.0, 2.0]"


def test_async_checkpoint_snapshots_before_the_update(tmp_path):
    """save_async copies the tensors before returning: an in-place update
    right after does not reach the file."""
    x = torch.zeros(4)
    ck = TCK.AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, {"x": x})
    x.add_(5.0)
    ck.close()
    assert TCK.restore(str(tmp_path), 1, {"x": x})["x"].tolist() == [0.0] * 4


def _lm(seed=0):
    cfg = TR.get_config("gemma-7b", smoke=True)
    return TT.init_params(cfg, torch.Generator().manual_seed(seed), "cpu"), cfg


def _lm_loss(m, b):
    return TT.loss_fn(m, b["tokens"], b["labels"])[0]


def _fixed(batch):
    while True:
        yield batch


def test_restore_after_failures_repeats_the_uninterrupted_history(tmp_path):
    """Step 5 fails more often than the retries allow: the loop restores
    the step-4 checkpoint and runs on, so its history is the
    uninterrupted run's with step 4 run twice, equal on the CPU."""
    batch = TR.make_batch(_lm()[1], "train_4k", torch.Generator().manual_seed(3), "cpu",
                          batch=2, seq=16)
    clean = TTL.train(_lm()[0], _lm_loss, _fixed(batch),
                      TrainConfig(steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=2))[2]
    fails = {"n": 0}

    def inject(step):
        if step == 5 and fails["n"] < 4:
            fails["n"] += 1
            raise RuntimeError("node failure")

    faulty = TTL.train(_lm()[0], _lm_loss, _fixed(batch),
                       TrainConfig(steps=8, ckpt_dir=str(tmp_path / "b"), ckpt_every=2,
                                   max_retries=3), fail_injector=inject)[2]
    assert fails["n"] == 4
    assert faulty == clean[:5] + clean[4:]
    assert clean[-1]["loss"] < clean[0]["loss"]


def test_train_loop_resume_and_failures(tmp_path):
    """The reference's own loop test: two failures at step 3 are retried,
    8 steps and a checkpoint at 8; a second run to 12 resumes at 8."""
    model, cfg = _lm()
    pipe = TP.BatchPipeline(TP.lm_synthetic_batches(cfg.vocab_size, 4, 16))
    fails = {3: 0}

    def inject(step):
        if step in fails and fails[step] < 2:
            fails[step] += 1
            raise RuntimeError("node failure")

    try:
        tc = TrainConfig(steps=8, ckpt_dir=str(tmp_path), ckpt_every=2, lr=1e-3)
        model, _, hist = TTL.train(model, _lm_loss, iter(pipe), tc, fail_injector=inject)
        assert len(hist) == 8 and TCK.latest_step(str(tmp_path)) == 8
        _, opt, hist2 = TTL.train(model, _lm_loss, iter(pipe),
                                  TrainConfig(steps=12, ckpt_dir=str(tmp_path), ckpt_every=4,
                                              lr=1e-3))
        assert len(hist2) == 4 and opt.t == 12
    finally:
        pipe.close()


def test_pipeline_seeds_and_host_slicing_equal_the_reference():
    make_t = TP.lm_synthetic_batches(100, 8, 4)
    make_j = JP.lm_synthetic_batches(100, 8, 4)
    for host in (0, 1):
        t = TP.BatchPipeline(make_t, seed=4, host_index=host, n_hosts=2)
        j = JP.BatchPipeline(make_j, seed=4, host_index=host, n_hosts=2)
        try:
            bt, bj = next(iter(t)), next(iter(j))
        finally:
            t.close()
            j.close()
        assert bt["tokens"].shape == (4, 4)
        for k in bt:
            np.testing.assert_array_equal(bt[k], bj[k])
