"""The embedding bag's (B5) and its gradient's (K7) candidate designs,
timed against the port's own kernels on the card at Wide&Deep's calls:
the record of why `kernels/embedding_bag/bag.cu` holds the designs it
holds.

It builds `scripts/bag_designs.cu` (the designs that lost, each behind a
`design` number; see its head comment) with nvcc into `build/scripts/`.
The port's kernels ("port_...") are its own wrappers, `bag_sum` and
`bag_backward`, and its B5 kernel at tiles of at most 16 bags
(`rt_embedding_bag` at `staged_geometry`'s launch, the tile cut to 16).  Every design is checked
against the plain versions (`ref.py`) on small and Wide&Deep-shaped
inputs, then timed with `chip_smoke.device_ms` (device time under
torch.profiler, the mean of 20 calls; "cold" with a 256 MB buffer written
before each call, which flushes the 50 MB L2), each sequence run forward
and then backward (a, b, .., b, a):

- B5 at serve_bulk (262,144 bags x 40 fields into the 8,933,376 x 1 fp32
  wide table, ids as `configs/registry.make_batch` draws them) and
  serve_p99 (512 bags); the same ids split into the 16 large fields and
  the 24 small ones; and ids drawn uniformly from 12,000 rows (48 KB:
  lookups that stay in L1) and from 400,000 rows (1.6 MB: lookups that
  stay in L2);
- K7 at train_batch (65,536 bags): every design (the port's kernel by
  field group and in field-major order is `chip_smoke.bag_field_probe`'s).

    python3 scripts/bag_designs.py

Prints one JSON line (also written to `chiprun_out/bag_designs.json`);
needs a CUDA card and nvcc.  `chip_smoke.py` builds the same library to
time the first design against the port's B5 in turns."""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import registry as RREG  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as EO  # noqa: E402
from repro_torch.kernels.embedding_bag import ref as ER  # noqa: E402
from repro_torch.recsys import embedding as E  # noqa: E402

SOURCE = ROOT / "scripts" / "bag_designs.cu"
_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
# B5 designs by name: (design, tile_cap; the port's kernel: -1, its tile);
# K7 designs: (design, updates; the port's kernel: -1)
BAG = {"port_staged_tiles32": (-1, EO.TILE_BAGS), "port_staged_tiles16": (-1, 16),
       "first": (0, 0), "staged_tiles64_16loads": (1, 64), "field_major": (5, 0),
       "large_fields_past_l1": (7, 32), "persistent_smem_fields": (10, 0),
       "cp_async_tiles16": (11, 16), "table_l2_evict_last": (12, 32),
       "table_l2_evict_last_past_l1": (13, 32)}
FP32_ONLY = ("cp_async_tiles16", "table_l2_evict_last", "table_l2_evict_last_past_l1")
BWD = {"port_first": (-1, 0), "smem_groups": (1, 4), "fill_overlap": (2, 66),
       "grid_stride": (3, 8), "l2_hints": (4, 1)}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + b"".join(
        p.read_bytes() for p in _build.HEADERS)).hexdigest()[:16]
    return ROOT / "build" / "scripts" / f"libbag_designs-{digest}.so"


def build() -> Path:
    """nvcc of `bag_designs.cu` unless this source's library exists."""
    lib = library_path()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.KERNEL_DIR),
                        "-o", str(tmp), str(SOURCE)], check=True)
        tmp.replace(lib)
    return lib


def load() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build()))
    dll.bd_bag.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U, _U, _I, _P, _P]
    dll.bd_bwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P, _I, _P]
    dll.bd_bag.restype = dll.bd_bwd.restype = _I
    dll.rt_error_string.argtypes, dll.rt_error_string.restype = [_I], ctypes.c_char_p
    return dll


def plan_array(groups):
    return (ctypes.c_longlong * max(1, 4 * len(groups)))(*[x for g in groups for x in g])


def stage_groups(spans, rows, per_block, elt):
    """Design 10's field groups: runs of fields that a block of
    `per_block` bags looks up at least once for every 4 of their rows, and
    whose rows (16-byte aligned) fit 48 KB of shared memory (at
    Wide&Deep's serve_bulk: the twelve 1 K-row fields; staging the 10 K-row
    ones too measured slower).  -> [(f0, f1, lo, n)], at most 16."""
    E_, cap, out = 16 // elt, 48 * 1024 // elt, []
    for f, (a, b) in enumerate(spans):
        lo, hi = a - a % E_, min(rows, -(-b // E_) * E_)
        if hi - lo > cap or 4 * per_block < b - a:
            continue
        end = max(out[-1][2] + out[-1][3], hi) if out else hi
        if out and out[-1][1] == f and end - out[-1][2] <= cap:
            out[-1] = (out[-1][0], f + 1, out[-1][2], end - out[-1][2])
        else:
            out.append((f, f + 1, lo, hi - lo))
    return out[:16]


def past_l1_mask(spans, row_bytes, limit=64 * 1024):
    """Design 7's fields: those whose rows span more than `limit` bytes."""
    m = sum(1 << f for f, (a, b) in enumerate(spans) if f < 128 and (b - a) * row_bytes > limit)
    return m & (2 ** 64 - 1), m >> 64


def smem_groups(spans, B, d, adds=16, cap=48 * 1024):
    """K7 design 1's groups: runs of fields with >= `adds` adds a row whose
    rows fit `cap` bytes of fp32 gradient.  -> [(f0, f1, lo, rows)] <= 8."""
    out = []
    for f, (a, b) in enumerate(spans):
        n = b - a
        if n < 1 or n * d * 4 > cap or B < adds * n:
            continue
        if out and out[-1][1] == f and (b - out[-1][2]) * d * 4 <= cap:
            out[-1] = (out[-1][0], f + 1, out[-1][2], b - out[-1][2])
        else:
            out.append((f, f + 1, a, n))
    return out[:8]


def fill_run(spans, B):
    """K7 design 2's run: the longest run of fields whose rows get at least
    one add each on average.  -> [(f0, f1, lo, hi)]."""
    best, run = None, None
    for f, (a, b) in enumerate(spans):
        if 0 < b - a <= B:
            run = (run[0], f + 1, min(run[2], a), max(run[3], b)) if run else (f, f + 1, a, b)
            best = run if best is None or run[1] - run[0] > best[1] - best[0] else best
        else:
            run = None
    return [best]


class Designs:
    def __init__(self, dev):
        self.lib, self.dev = load(), dev
        self.port = _build.library("embedding_bag", EO._SIGNATURES)
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(self, err, what):
        if err:
            msg = self.lib.rt_error_string(err).decode()
            raise RuntimeError(f"{what}: cudaError {err} ({msg})")

    def bag(self, name, table, ids, spans=None):
        design, cap = BAG[name]
        if design < 0 and cap == EO.TILE_BAGS:
            return EO.bag_sum(table, ids)
        (B, F), d = ids.shape, table.shape[1]
        out = torch.empty((B, d), dtype=table.dtype, device=table.device)
        elt = table.element_size()
        vec = int(d % (16 // elt) == 0)
        if design < 0:                 # the port's kernel at another tile
            g = EO.staged_geometry(B, F, d, elt, bool(vec), self.sms)
            g = g._replace(TB=min(g.TB, cap))   # a smaller tile: the same chunk fits
            self.check(self.port.rt_embedding_bag(
                table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, F, d,
                int(table.dtype == torch.bfloat16), vec, *g,
                torch.cuda.current_stream().cuda_stream), f"bag {name}")
            return out
        groups = stage_groups(spans, table.shape[0], -(-B // self.sms), elt) \
            if design == 10 and spans else []
        m0, m1 = past_l1_mask(spans, d * elt) if design == 7 and spans else (0, 0)
        self.check(self.lib.bd_bag(table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, F, d,
                                   int(table.dtype == torch.bfloat16), vec, design, self.sms,
                                   cap, m0, m1, len(groups), plan_array(groups),
                                   torch.cuda.current_stream().cuda_stream), f"bag {name}")
        return out

    def bwd(self, name, ids, d_out, rows, spans=None):
        design, updates = BWD[name]
        if design < 0:
            return EO.bag_backward(ids, d_out, rows)
        (B, F), d = ids.shape, d_out.shape[1]
        groups = (smem_groups(spans, B, d) if design == 1 else
                  fill_run(spans, B) if design == 2 else [])
        if design == 4:
            grad = torch.empty((rows, d), dtype=torch.float32, device=d_out.device)
        elif design == 2:
            grad = torch.empty((rows, d), dtype=torch.float32, device=d_out.device)
            grad[groups[0][2]:groups[0][3]].zero_()
        else:
            grad = torch.zeros((rows, d), dtype=torch.float32, device=d_out.device)
        out = grad if d_out.dtype == torch.float32 else torch.empty(
            (rows, d), dtype=d_out.dtype, device=d_out.device)
        self.check(self.lib.bd_bwd(ids.data_ptr(), d_out.data_ptr(), grad.data_ptr(),
                                   out.data_ptr(), B, F, d, rows,
                                   int(d_out.dtype == torch.bfloat16), design, len(groups),
                                   plan_array(groups), updates,
                                   torch.cuda.current_stream().cuda_stream), f"bwd {name}")
        return out


def wide_deep(dev, shape, gen):
    """(ids (B, 40) global rows as the model builds them, spans, rows)."""
    cfg = RREG.get_config("wide-deep")
    batch = RREG.make_batch(cfg, shape, gen, dev)
    offs = E.field_offsets(cfg.field_vocabs)
    ids = (batch["sparse_ids"] + torch.as_tensor(offs, device=dev)[None]).contiguous()
    spans = [(int(a), int(a) + v) for a, v in zip(offs, cfg.field_vocabs)]
    return ids, spans, E.mega_table_rows(cfg.field_vocabs)


def close(got, want, dt):
    torch.cuda.synchronize()
    scale = max(1.0, float(want.float().abs().max())) if want.numel() else 1.0
    err = float((got.float() - want.float()).abs().max()) if want.numel() else 0.0
    tol = (1e-5 if dt == torch.float32 else 2 ** -7) * scale
    return err <= tol and got.dtype == want.dtype, err


def checks(D, dev, gen, wd):
    """Every design against the plain versions.  -> list of failures."""
    fails = []
    ids_wd, spans, rows = wd
    for dt in (torch.float32, torch.bfloat16):
        wide = (torch.randn(rows, 1, device=dev, generator=gen) * 0.05).to(dt)
        for B in (1, 513, 4097):
            ids = ids_wd[:B].contiguous()
            for name in BAG:
                if name in FP32_ONLY and dt != torch.float32:
                    continue                                   # 4- and 16-byte rows only
                ok, err = close(D.bag(name, wide, ids, spans), ER.embedding_bag_ref(wide, ids), dt)
                if not ok:
                    fails.append(("bag", name, str(dt), B, err))
            d_out = torch.randn(B, 1, device=dev, generator=gen).to(dt)
            want = ER.bag_backward_ref(ids, d_out, rows)
            for name in BWD:
                if name == "fill_overlap" and fill_run(spans, B)[0] is None:
                    continue                                   # no field gets an add a row
                ok, err = close(D.bwd(name, ids, d_out, rows, spans), want, dt)
                if not ok:
                    fails.append(("bwd", name, str(dt), B, err))
        del wide
        for d in (3, 32):
            table = torch.randn(5000, d, device=dev, generator=gen).to(dt)
            for F in (0, 1, 40, 130):
                ids = torch.randint(0, 5000, (700, F), device=dev, generator=gen,
                                    dtype=torch.int32)
                names = ["port_staged_tiles32", "port_staged_tiles16", "first",
                         "staged_tiles64_16loads", "large_fields_past_l1"]
                if dt == torch.float32:                 # 4- and 16-byte rows only
                    names += ["table_l2_evict_last", "table_l2_evict_last_past_l1"]
                for name in names:
                    ok, err = close(D.bag(name, table, ids, [(0, 5000)] * F),
                                    ER.embedding_bag_ref(table, ids), dt)
                    if not ok:
                        fails.append(("bag", name, str(dt), d, F, err))
    return fails


def turns(names, fn):
    """fn(name) for names forward then backward.  -> {name: [results]}."""
    out = {}
    for name in list(names) + list(names)[::-1]:
        out.setdefault(name, []).append(fn(name))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bag_designs: needs a CUDA card")
    import chip_smoke as CS
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    D = Designs(dev)
    report = {"device": torch.cuda.get_device_name(0), "build_s": time.perf_counter() - t0}
    bulk = wide_deep(dev, "serve_bulk", gen)
    report["check_failures"] = checks(D, dev, gen, bulk)
    if report["check_failures"]:
        print(json.dumps(report))
        raise SystemExit("bag_designs: a design disagrees with the plain version")
    ids, spans, rows = bulk
    wide = torch.randn(rows, 1, device=dev, generator=gen) * 0.05
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def warm_cold(fn):
        return CS.device_ms(fn)["ms"], CS.device_ms(fn, flush=flush)["ms"]

    report["b5_serve_bulk_warm_cold_ms"] = turns(
        BAG, lambda n: warm_cold(lambda: D.bag(n, wide, ids, spans)))
    p99 = ids[:512].contiguous()
    report["b5_serve_p99_warm_cold_ms"] = turns(
        ("port_staged_tiles32", "first"), lambda n: warm_cold(lambda: D.bag(n, wide, p99, spans)))
    for label, cols in (("fields_0_15", range(16)), ("fields_16_39", range(16, 40))):
        sub, ssp = ids[:, list(cols)].contiguous(), [spans[c] for c in cols]
        report[f"b5_{label}_ms"] = turns(
            ("port_staged_tiles32", "field_major", "persistent_smem_fields"),
            lambda n: CS.device_ms(lambda: D.bag(n, wide, sub, ssp))["ms"])
    B = ids.shape[0]
    for label, lo, hi in (("l1_resident_12k_rows", rows - 12000, rows),
                          ("l2_resident_400k_rows", 0, 400000)):
        syn = torch.randint(lo, hi, (B, 40), device=dev, generator=gen, dtype=torch.int32)
        report[f"b5_{label}_ms"] = turns(
            ("port_staged_tiles32", "first"),
            lambda n: CS.device_ms(lambda: D.bag(n, wide, syn))["ms"])
    del flush

    tids, tspans, _ = wide_deep(dev, "train_batch", gen)
    d_out = torch.randn(tids.shape[0], 1, device=dev, generator=gen)

    def bwd_ms(fn):
        r = CS.device_ms(fn)
        return r["ms"], r["by_kernel"]

    report["k7_train_batch_ms"] = turns(
        BWD, lambda n: bwd_ms(lambda: D.bwd(n, tids, d_out, rows, tspans)))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "bag_designs.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
