"""The hillclimbs (`launch.perf_iterations`) and `lm_analytic`'s
five knobs against the JAX package.

* Knob parity: under every knob set, for the six LM archs x train /
  prefill / decode at 256 cards with 16 and 64 of them data parallel,
  `lm_analytic`'s FLOPs, bytes and collective bytes equal the
  reference's exactly; its times are the reference's scaled by the ratio
  of the two packages' constants within 1e-12 relative; ``serial_s`` and
  ``overlapped_s`` follow from the terms.
* The cells: the reference's cells, iteration ids, names and per-device
  counts; the reference's `confirmed` tests at H100 rates (B's
  iteration 2 fails: the step is compute-bound there) and the final
  speedups, pinned.  No hypothesis or selection string quotes a figure
  that the reference's strings state at its own chip's rates.
* The probes: the argument bytes of each probe's cell, world and config
  (uncut) equal the reference's specs (`tests/test_torch_dryrun.py`'s
  `reference_lm`), and so do the committed record's
  (`results/perf_torch/hillclimbs.json`, whose analytic part a fresh
  run reproduces); at a cut (1 layer, a short sequence) a probe counts
  the closed-form FLOPs, a raising override leaves `registry.ARCHS` as
  it was, and a (64, 4) world traces.
* Block pairing: the port has no `causal_block_pairing` flag because
  its attention is banded; its logits are within 1e-5 of the
  reference's forward with the flag on (and off).

Importing `repro.launch.perf_iterations` sets ``XLA_FLAGS`` (512 host
devices); the reference module is imported inside a fixture that
restores the variable, so no later test of the worker inherits it."""
import dataclasses
import json
import math
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.launch import roofline as JRF
from repro.launch import roofline_analytic as JRA
from repro.models import transformer as JT
from repro_torch.configs import registry as TR
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import perf_iterations as PI
from repro_torch.launch import roofline as TRF
from repro_torch.launch import roofline_analytic as TRA
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from test_torch_dryrun import _mesh, reference_lm

LM_ARCHS = ("nemotron-4-15b", "starcoder2-15b", "gemma-7b", "kimi-k2-1t-a32b",
            "moonshot-v1-16b-a3b", "rcllm-qwen3-8b")
STEPS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
KNOBS = {
    "none": {},
    "pairing": {"causal_block_pairing": True},
    "seq_parallel": {"seq_parallel": True},
    "overlap": {"overlap_collectives": True},
    "recompute": {"selective_recompute": 0.37},
    "decode_read": {"selective_decode_read": 0.0505},
    "all": {"causal_block_pairing": True, "seq_parallel": True, "overlap_collectives": True,
            "selective_recompute": 0.37, "selective_decode_read": 0.0505},
}
COUNTS = ("flops_per_device", "bytes_per_device", "collective_bytes_per_device")
SCALE = {"compute_s": JRF.PEAK_FLOPS / TRF.PEAK_FLOPS, "memory_s": JRF.HBM_BW / TRF.HBM_BW,
         "collective_s": JRF.ICI_BW / TRF.NVLINK_BW}
REL = 1e-12
CELLS = ("A_nemotron_prefill_32k", "B_kimi_train_4k", "C_moonshot_train_4k",
         "D_gemma_long_500k")
# modelled at H100 SXM peaks on 256 cards
CONFIRMED = {"A_nemotron_prefill_32k": [True, True, True],
             "B_kimi_train_4k": [True, False, True],
             "C_moonshot_train_4k": [True, True, True],
             "D_gemma_long_500k": [True]}
SPEEDUP = {"A_nemotron_prefill_32k": 4.97, "B_kimi_train_4k": 1.70,
           "C_moonshot_train_4k": 2.20, "D_gemma_long_500k": 8.81}
# numbers the two packages share as knob arguments, mesh and shape sizes
# (r, the pairing factor, halves, mesh axes, S, d_model, window, HH %)
SHARED_NUMBERS = {0.37, 37.0, 0.55, 0.5, 0.65, 1.0, 4.0, 16.0, 64.0, 128.0, 256.0, 2048.0,
                  4096.0, 524288.0, 5.0}
NUMBER = re.compile(r"\d+(?:\.\d+)?")


# ----------------------------------------------------------- knob parity
@pytest.mark.parametrize("data_par", [16, 64])
@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_lm_analytic_knobs_equal_the_reference(knobs, arch, step, data_par):
    dims = TR.LM_SHAPES[STEPS[step]].dims
    kw = dict(n_chips=256, data_par=data_par, **KNOBS[knobs])
    got = TRA.lm_analytic(TR.ARCHS[arch], step, dims, **kw)
    want = JRA.lm_analytic(JR.ARCHS[arch], step, dims, **kw)
    for key in COUNTS:
        assert got[key] == want[key], key
    for key, r in SCALE.items():
        assert math.isclose(got[key], want[key] * r, rel_tol=REL), key
    terms = {k: got[k + "_s"] for k in ("compute", "memory", "collective")}
    assert got["bottleneck"] == max(terms, key=terms.get)
    assert got["serial_s"] == terms["compute"] + terms["memory"] + terms["collective"]
    overlap = KNOBS[knobs].get("overlap_collectives", False)
    assert got["overlapped_s"] == (max(terms.values()) if overlap else got["serial_s"])


# ------------------------------------------------------------- the cells
@pytest.fixture(scope="module")
def reference_cells():
    """The reference's four cells without probes, and `XLA_FLAGS` as it was
    before the import (restored after it)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf_iterations as JPI
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    out = {}
    JPI.cell_A(out, False)
    JPI.cell_B(out, False)
    JPI.cell_C(out, False)
    JPI.cell_D(out)
    return out, before


@pytest.fixture(scope="module")
def port_cells():
    out = {}
    PI.cell_A(out, False)
    PI.cell_B(out, False)
    PI.cell_C(out, False)
    PI.cell_D(out)
    return out


def test_importing_the_reference_module_leaves_xla_flags(reference_cells):
    assert os.environ.get("XLA_FLAGS") == reference_cells[1]


def test_cells_have_the_reference_iterations_and_counts(reference_cells, port_cells):
    reference_cells = reference_cells[0]
    assert list(port_cells) == list(reference_cells) == list(CELLS)
    for cell in CELLS:
        got, want = port_cells[cell]["iterations"], reference_cells[cell]["iterations"]
        assert [(i["iter"], i["name"]) for i in got] == [(i["iter"], i["name"]) for i in want]
        assert [("confirmed" in i, "hypothesis" in i) for i in got] == \
            [("confirmed" in i, "hypothesis" in i) for i in want]
        for g, w in zip(got, want):
            for key in COUNTS:
                assert g["terms"][key] == w["terms"][key], (cell, g["iter"], key)
            for key, r in SCALE.items():
                assert math.isclose(g["terms"][key], w["terms"][key] * r, rel_tol=REL)


@pytest.mark.parametrize("cell", CELLS)
def test_confirmed_flags_and_speedups_at_h100_rates(port_cells, cell):
    rec = port_cells[cell]
    assert [i["confirmed"] for i in rec["iterations"] if "confirmed" in i] == CONFIRMED[cell]
    assert abs(rec["final_speedup_vs_baseline"] - SPEEDUP[cell]) < 0.01
    # every term shows in the printed line (the reference's 3 decimals of a
    # second print 0.000 for the decode cell)
    for it in rec["iterations"]:
        for part in PI.fmt(it["terms"]).split()[:4]:
            assert not re.fullmatch(r"\S+=0(\.0+)?ms", part), part


def _strings(cells):
    for rec in cells.values():
        yield rec["selection"]
        for it in rec["iterations"]:
            if "hypothesis" in it:
                yield it["hypothesis"]


def test_no_string_quotes_a_reference_figure(reference_cells, port_cells):
    reference_cells = reference_cells[0]
    theirs = {float(n) for s in _strings(reference_cells) for n in NUMBER.findall(s)}
    priced = theirs - SHARED_NUMBERS
    assert {0.35, 9.53, 458.0, 4.8, 5.5} <= priced
    for s in _strings(port_cells):
        ours = {float(n) for n in NUMBER.findall(s)}
        assert not ours & priced, (s, ours & priced)
        assert not re.search(r"TPU|MXU|XLA|ICI|v5e", s), s


def test_selections_say_whether_the_reference_criterion_holds(port_cells):
    b = port_cells["B_kimi_train_4k"]["selection"]
    c = port_cells["C_moonshot_train_4k"]["selection"]
    assert "compute-bound" in b
    assert "does not hold" in c and "the largest share" in c


def test_cli_without_probes_writes_the_cells(tmp_path, capsys):
    PI._main(["--no-probe", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "hillclimbs.json").read_text())
    assert list(rec) == list(CELLS)
    assert "never measured" in capsys.readouterr().out


# ------------------------------------------------------------ the probes
COMMITTED = Path(__file__).resolve().parents[1] / "results" / "perf_torch" / "hillclimbs.json"
TILES = dict(attn_q_chunk=2048, attn_kv_chunk=2048)
# each probe's cell, world and config override: the port's, then the
# reference's (its probe config also sets `causal_block_pairing`)
PROBES = {"A_nemotron_prefill_32k": ("nemotron-4-15b", "prefill_32k", (16, 16), TILES,
                                     dict(TILES, causal_block_pairing=True)),
          "B_kimi_train_4k": ("kimi-k2-1t-a32b", "train_4k", (16, 16), None, None),
          "C_moonshot_train_4k": ("moonshot-v1-16b-a3b", "train_4k", (64, 4), None, None)}


def _probes(rec):
    return [i["probe"] for i in rec["iterations"] if i["iter"] == "evidence"]


@pytest.mark.parametrize("cell", list(PROBES))
def test_probe_argument_bytes_equal_the_reference_specs(cell, monkeypatch):
    arch, shape, mesh, ours, theirs = PROBES[cell]
    if theirs:
        monkeypatch.setitem(JR.ARCHS, arch, dataclasses.replace(JR.ARCHS[arch], **theirs))
    want = reference_lm(arch, shape, _mesh(mesh))
    with PI.override(arch, ours and dataclasses.replace(TR.ARCHS[arch], **ours)):
        got = DRY.argument_bytes(arch, shape, mesh)
    assert got == want
    (rec,) = _probes(json.loads(COMMITTED.read_text())[cell])
    assert rec["mesh_shape"] == list(mesh) and rec["cuts"] == {}
    assert rec["arg_bytes"] == sum(want.values())


def test_the_committed_record_is_current(port_cells):
    """The analytic part of `results/perf_torch/hillclimbs.json` is what
    the code gives now (its probes: the test above and phase 2p)."""
    committed = json.loads(COMMITTED.read_text())
    assert list(committed) == list(port_cells)
    for cell, rec in port_cells.items():
        got = committed[cell]
        assert got["selection"] == rec["selection"]
        assert got["final_speedup_vs_baseline"] == rec["final_speedup_vs_baseline"]
        assert [i for i in got["iterations"] if i["iter"] != "evidence"] == rec["iterations"]
        assert len(_probes(got)) == (cell in PROBES)


# ------------------------------------------------------ the probe at a cut
CUT = dict(layers=1, seq=256)


def test_a_probe_at_a_cut_counts_the_closed_form_flops():
    rec = PI.probe("gemma-7b", "decode_32k", layers=1)
    cfg = dataclasses.replace(TR.ARCHS["gemma-7b"], n_layers=1)
    want = TRA.lm_analytic(cfg, "decode", TR.LM_SHAPES["decode_32k"].dims, n_chips=256,
                           data_par=16)["flops_per_device"]
    assert rec["flops_per_device"] == pytest.approx(want, rel=1e-9)
    assert rec["cuts"] == {"n_layers": 1} and rec["mesh_shape"] == [16, 16]
    assert rec["device"] == DRY.fake_device() and rec["collective_counts"]["all-reduce"] > 0
    assert rec["arg_gb"] == round(rec["arg_bytes"] / 1e9, 2) > 0


def test_a_raising_override_leaves_the_registry():
    cfg = TR.ARCHS["nemotron-4-15b"]
    bad = dataclasses.replace(cfg, attn_q_chunk=0)     # no chunk can be planned
    with pytest.raises(ValueError):
        PI.probe("nemotron-4-15b", "prefill_32k", cfg_override=bad, **CUT)
    assert TR.ARCHS["nemotron-4-15b"] is cfg


def test_probe_traces_a_64_by_4_world():
    cut = dict(layers=1, seq=128, batch_size=64)
    rec = PI.probe("moonshot-v1-16b-a3b", "train_4k", mesh_shape=(64, 4), **cut)
    assert rec["mesh_shape"] == [64, 4] and rec["flops_per_device"] > 0
    assert rec["cuts"] == {"n_layers": 1, "batch": 64, "seq": 128}
    assert rec["collective_counts"] and rec["collective_bytes"] > 0


# ----------------------------------------------------- causal block pairing
@pytest.mark.parametrize("pairing", [True, False])
def test_banded_attention_matches_the_reference_block_pairing(pairing):
    """`tests/test_models_lm.py::test_block_pairing_exact` on the port: its
    banded attention against the reference's forward with and without
    `causal_block_pairing`."""
    jcfg = dataclasses.replace(JR.get_config("gemma-7b", smoke=True),
                               causal_block_pairing=pairing)
    cfg = TR.get_config("gemma-7b", smoke=True)
    assert not hasattr(cfg, "causal_block_pairing") and cfg.attn_q_chunk == 32
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 96), 0, jcfg.vocab_size)
    want, _ = JT.forward(params, toks, jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    with torch.no_grad():
        got, _ = TT.forward_train(params_from_numpy(tree, cfg, device="cpu"),
                                  torch.from_numpy(np.array(toks)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
