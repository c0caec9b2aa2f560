"""The plain reference against the port at a tiny width through the
kernels' plain versions, and the comparison that decides `correct`
failing on a control and on faults planted in the served path."""
import numpy as np
import pytest
import torch

from rcbench import correct as CORRECT
from rcbench import run as R  # noqa: F401  (puts the port's `src` on the path)
from rcbench import tiny
from rcbench import weights as W


@pytest.fixture(scope="module")
def sound():
    return tiny.run()


def test_a_sound_run_is_correct(sound):
    assert sound["correct"] is True
    assert sound["checks"]["logit_gap"]["value"] == 0.0
    assert sound["checks"]["tokens_compared"]["value"] == 24
    assert sound["failed"] == 0 and sound["attempted"] >= 6
    # the reference's own Eq. 3 selection is the port's, token for token
    assert sound["_verdict"]["mask_diff"] == [0, 0, 0]


def test_reference_offline_kv_matches_the_port():
    from repro_torch.core.engine import precompute_kv_batch

    from rcbench.reference.dense_gqa import Reference

    c = tiny.cell()
    w = W.draw(c.config, 5, "cpu")
    from rcbench import cell as C
    cfg = C.lm_config(c.config)
    model = W.port_model(cfg, w)
    docs = [np.asarray([2, 90, 91, 92, 93], np.int32), np.asarray([3] + list(range(3000, 3040)), np.int32)]
    port = precompute_kv_batch(model, cfg, docs)
    ref = Reference(c.config, w, "cpu")
    k, v = ref.doc_kv([d.astype(np.int64) for d in docs], [np.arange(len(d)) for d in docs])
    np.testing.assert_allclose(k.numpy(), np.concatenate([p[0] for p in port]), atol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.concatenate([p[1] for p in port]), atol=2e-5)


def test_the_float8_control_is_not_correct(sound):
    run = sound["_run"]
    w = W.draw(run.cell.config, run.seed, "cpu")
    ref32 = sound["_verdict"]["logits"]
    ctrl = CORRECT.judge(run, w, "cpu", precision="fp8", logits_of=ref32)
    assert ctrl["logit_gap"] > 10 * run.cell.limits["logit_gap"]["limit"]


def _faulty(monkeypatch, fault):
    from repro_torch.core import engine as ENG
    from repro_torch.serving import batch_engine as BE
    from repro_torch.serving import batching as BT

    if fault == "token":
        # a token altered where it is produced: the second-best logit
        monkeypatch.setattr(BT.TorchEngineBackend, "_pick",
                            lambda self, rid, lg: int(np.argsort(np.asarray(lg))[-2]))
    elif fault == "stale_step":
        # a decode step that returns its state unchanged: no KV written,
        # the request's last logits again
        last = {}
        real = BE.BatchEngine.decode

        def stale(self, rids, toks):
            fresh = [r for r in rids if r not in last]
            if fresh:
                for r, lg in zip(fresh, real(self, fresh, [t for r2, t in zip(rids, toks)
                                                          if r2 in fresh])):
                    last[r] = lg
            return np.stack([last[r] for r in rids])
        monkeypatch.setattr(BE.BatchEngine, "decode", stale)
    elif fault == "half_batch":
        # half of each decode batch left out; those rows get the first's
        real = BE.BatchEngine.decode

        def half(self, rids, toks):
            k = max(1, (len(rids) + 1) // 2)
            lg = real(self, rids[:k], toks[:k])
            return np.concatenate([lg, np.repeat(lg[:1], len(rids) - k, axis=0)])
        monkeypatch.setattr(BE.BatchEngine, "decode", half)
    elif fault == "selection":
        # Eq. 3 inverted: the lowest scores recomputed
        real = ENG.select_recompute
        monkeypatch.setattr(ENG, "select_recompute",
                            lambda plan, have, a, d, sel: real(plan, have, -np.asarray(a),
                                                               -np.asarray(d), sel))


@pytest.mark.parametrize("fault", ["token", "stale_step", "half_batch", "selection"])
def test_a_broken_served_path_is_not_correct(monkeypatch, fault):
    _faulty(monkeypatch, fault)
    res = tiny.run()
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    import time

    from rcbench import run as R

    res = R.run_cell(tiny.cell(limit=2e-4), tiny.BENCH, 11, 1.5, False, "cuda",
                     time.perf_counter())
    assert res["correct"] is True, res["checks"]


def test_the_result_line_has_the_contracts_schema(sound, capsys):
    import json

    from rcbench import run as R

    R.emit(sound)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and isinstance(line["attempted"], int)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    assert {"ttft_p50_ms", "ttft_p90_ms", "tbt_p95_ms", "setup_s"} <= set(line["metrics"])
    assert line["checks"]["logit_gap"] == {"value": 0.0, "limit": 1e-3}
    assert err.strip().splitlines()[-3].startswith("check logit_gap: 0.0 (limit 0.001)")
