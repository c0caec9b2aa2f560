"""The port stands alone: no module of `repro_torch`, not
`chip_smoke.py` and not the port's examples (`examples/torch_*.py`)
imports JAX or the JAX package (`repro`) — not even its pure-numpy
modules, since `repro.core.engine` pulls Pallas in at import."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
TRAINING_MODULES = ("repro_torch.training.optimizer", "repro_torch.training.train_loop",
                    "repro_torch.checkpoint.checkpoint", "repro_torch.data.pipeline",
                    "repro_torch.core.ranker_training", "repro_torch.gnn.schnet",
                    "repro_torch.gnn.sampler", "repro_torch.gnn.convert",
                    "repro_torch.launch.train", "repro_torch.configs.schnet")
# the dry run and the roofline report (the fake world and fake tensors
# come from torch itself)
DRYRUN_MODULES = ("repro_torch.launch.dryrun", "repro_torch.launch.roofline_report",
                  "repro_torch.launch.roofline", "repro_torch.launch.mesh")
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    assert "repro_torch.serving.batch_engine" in mods and len(mods) > 25
    # the training slice's and the dry run's modules are among them
    assert set(TRAINING_MODULES) <= set(mods)
    assert set(DRYRUN_MODULES) <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_examples_import_with_jax_and_repro_blocked():
    assert [f.name for f in EXAMPLES] == ["torch_quickstart.py", "torch_serve_cluster.py",
                                          "torch_train_lm_distributed.py",
                                          "torch_train_ranker.py"]
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}]\n"
        f"for i, f in enumerate({[str(f) for f in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'example{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + EXAMPLES
    assert len(EXAMPLES) == 4
    assert len(files) > 25
    for m in TRAINING_MODULES + DRYRUN_MODULES:
        assert PORT.parent / (m.replace(".", "/") + ".py") in files
    offenders = [str(f.relative_to(REPO)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import engine")
    assert not FORBIDDEN.search("from repro_torch.core import engine")


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without a CUDA device the script fails before printing a result,
    and alone in a directory (no repository beside it) it fails too."""
    import torch
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
