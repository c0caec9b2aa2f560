"""B5 (the embedding bag) at row0 = 0 on the whole table: the parent
commit's `bag.cu`, before the kernel took a row window, against this
tree's, on the card.

- Bitwise: five shapes (Wide&Deep's wide table at serve_bulk and
  serve_p99, a (400,000, 16) fp32 table, a (100,000, 32) bf16 one and a
  small odd one), random rows and uniform ids from a seeded generator.
- Time: Wide&Deep's serve_bulk and serve_p99 calls on its wide table at
  published width (seed 0, ids as `configs/registry.make_batch` draws
  them), in turns parent, change, change, parent, twice: device ms under
  the profiler (`chip_smoke.device_ms`) and CUDA-event ms
  (`chip_smoke.time_ms`).

The parent's checkout is unpacked first, for example

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 scripts/bag_window_ab.py --parent build/parent

Needs a CUDA card and nvcc.  Prints one JSON line (also written to
`chiprun_out/bag_window_ab.json`) with the card's name and power limit."""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as CS  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as EO  # noqa: E402
from repro_torch.recsys import models as RM  # noqa: E402

SHAPES = ((8_933_376, 1, 262_144, 40, torch.float32), (8_933_376, 1, 512, 40, torch.float32),
          (400_000, 16, 65_536, 40, torch.float32), (100_000, 32, 4097, 13, torch.bfloat16),
          (5000, 3, 10_001, 130, torch.float32))


def parent_library(parent: Path) -> ctypes.CDLL:
    """nvcc of the parent's `bag.cu` (its own headers) into build/scripts."""
    src = parent / "src" / "repro_torch" / "kernels"
    out = ROOT / "build" / "scripts" / "libbag_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(out),
                    str(src / "embedding_bag" / "bag.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rt_embedding_bag.argtypes = [P, P, P, I, I, I, I, I, I, I, I, I, P]
    lib.rt_embedding_bag.restype = I
    return lib


def parent_call(lib, table, ids, out):
    """The parent's B5 at the launch this tree's wrapper picks (row0 = 0)."""
    B, F = ids.shape
    d, elt = table.shape[1], table.element_size()
    vec = d % (16 // elt) == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    geo = EO.staged_geometry(B, F, d, elt, vec, K.sm_count(table.device))
    err = lib.rt_embedding_bag(K.ptr(table), K.ptr(ids), K.ptr(out), B, F, d,
                               K.dtype_code("table", table), int(vec), *geo,
                               K.stream_of(table))
    if err:
        raise RuntimeError(f"the parent's embedding_bag returned {err}")


def bitwise(lib, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for rows, d, B, F, dt in SHAPES:
        table = torch.randn(rows, d, device=dev, generator=gen).to(dt)
        ids = torch.randint(0, rows, (B, F), device=dev, generator=gen, dtype=torch.int32)
        new = EO.bag_sum(table, ids)
        old = torch.empty_like(new)
        parent_call(lib, table, ids, old)
        torch.cuda.synchronize()
        same = torch.equal(new, old)
        out.append({"shape": [rows, d, B, F, str(dt)], "bitwise": same})
        if not same:
            raise SystemExit(f"B5 at row0 = 0 differs from the parent's kernel at {out[-1]}")
    return out


def turns(lib, dev):
    cfg = R.get_config("wide-deep")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = RM.init_params(cfg, gen, dev)
    table = model.wide_table.detach()
    out = {}
    for shape in ("serve_bulk", "serve_p99"):
        batch = R.make_batch(cfg, shape, gen, dev)
        ids = (batch["sparse_ids"] + model.offsets[None, :]).int().contiguous()
        new = EO.bag_sum(table, ids)
        old = torch.empty_like(new)
        fns = {"parent": lambda: parent_call(lib, table, ids, old),
               "change": lambda: EO.bag_sum(table, ids)}
        fns["parent"]()
        torch.cuda.synchronize()
        if not torch.equal(new, old):
            raise SystemExit(f"B5 at {shape}: the parent's and this tree's outputs differ")
        rec = []
        for side in ("parent", "change", "change", "parent") * 2:
            d = CS.device_ms(fns[side])
            rec.append({"side": side, "device_ms": d["ms"], "events": d["events_per_call"],
                        "ms": CS.time_ms(fns[side])})
        out[shape] = {"ids": list(ids.shape), "bitwise": True, "turns": rec}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the parent commit's unpacked checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bag_window_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.build(["embedding_bag"])
    lib = parent_library(args.parent.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"nvidia_smi": smi, "bitwise": bitwise(lib, dev), "turns": turns(lib, dev)}
    dest = ROOT / "chiprun_out" / "bag_window_ab.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
