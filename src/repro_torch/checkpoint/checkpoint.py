"""Checkpoints of the port: `save`, `latest_step`, `restore`, `gc_old`
and `AsyncCheckpointer`, the counterparts of the JAX package's
`checkpoint/checkpoint.py`.

Format: the reference's `b"F"` container, one file per save: a one-byte
magic `F`, then zlib over a length-prefixed flat map {leaf path: raw
bytes} (never pickle, so restoring a checkpoint executes no code), plus a
JSON manifest `<file>.json` with each leaf's dtype and shape.  The port
writes and reads only this format (no msgpack or zstandard).  A tree is
nested dicts, lists and named tuples of tensors, numpy arrays and
numbers; a leaf's path joins its keys, indices and field names with "/".
bfloat16 leaves are stored as their raw bytes under the dtype name
"bfloat16".
"""
from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MAGIC = b"F"


def _encode_flat(leaves: Dict[str, bytes]) -> bytes:
    out = [struct.pack("<I", len(leaves))]
    for k, v in leaves.items():
        kb = k.encode()
        out += [struct.pack("<I", len(kb)), kb, struct.pack("<Q", len(v)), v]
    return b"".join(out)


def _decode_flat(data: bytes) -> Dict[str, bytes]:
    n, off = struct.unpack_from("<I", data)[0], 4
    leaves = {}
    for _ in range(n):
        kl = struct.unpack_from("<I", data, off)[0]
        off += 4
        k = data[off:off + kl].decode()
        off += kl
        vl = struct.unpack_from("<Q", data, off)[0]
        off += 8
        leaves[k] = data[off:off + vl]
        off += vl
    return leaves


def _pack(leaves: Dict[str, bytes]) -> bytes:
    return MAGIC + zlib.compress(_encode_flat(leaves), 3)


def _unpack(data: bytes) -> Dict[str, bytes]:
    if data[:1] != MAGIC:
        raise RuntimeError("not a b'F' checkpoint (msgpack+zstd files need the JAX "
                           "package's reader)")
    return _decode_flat(zlib.decompress(data[1:]))


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the tree's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _leaf_bytes(leaf) -> Tuple[bytes, str, List[int]]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return raw, str(t.dtype).replace("torch.", ""), list(t.shape)
    arr = np.asarray(leaf)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def _leaf_from_bytes(raw: bytes, dtype: str, shape: List[int], like) -> Any:
    tdt = getattr(torch, dtype)
    t = (torch.frombuffer(bytearray(raw), dtype=tdt) if raw
         else torch.empty(0, dtype=tdt)).reshape(shape)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device)
    if isinstance(like, np.ndarray):
        return t.numpy()
    return type(like)(t.item()) if isinstance(like, (int, float)) else t


def _rebuild(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    kids = _children(like)
    if kids is None:
        return leaves[prefix]
    vals = [_rebuild(v, leaves, f"{prefix}/{k}" if prefix else k) for k, v in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
    """Write `tree` as step `step`: the data file is published by an
    atomic rename, then its manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, meta = {}, {}
    for key, leaf in flatten(tree):
        raw, dtype, shape = _leaf_bytes(leaf)
        leaves[key] = raw
        meta[key] = {"dtype": dtype, "shape": shape}
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_pack(leaves))
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "time": time.time(), "meta": meta, "extra": extra or {}}, f)
    return path


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[5:13]) for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".ckpt"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Step `step` in the structure of `like`: each tensor leaf comes back
    as a tensor on the device of `like`'s leaf (its dtype as saved), a
    numpy leaf as numpy, a number as a number."""
    path = _path(ckpt_dir, step)
    with open(path, "rb") as f:
        blob = _unpack(f.read())
    with open(path + ".json") as f:
        meta = json.load(f)["meta"]
    leaves = {key: _leaf_from_bytes(blob[key], meta[key]["dtype"], meta[key]["shape"], leaf)
              for key, leaf in flatten(like)}
    return _rebuild(like, leaves)


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest `keep` checkpoints."""
    for s in _steps(ckpt_dir)[:-keep]:
        for suffix in (".ckpt", ".ckpt.json"):
            try:
                os.remove(_path(ckpt_dir, s)[:-5] + suffix)
            except FileNotFoundError:
                pass


def to_host(tree: Any) -> Any:
    """A snapshot of `tree` in host memory: every tensor copied to the CPU
    (a copy even when it lies there: training updates it in place), the
    copy from the card finished before this returns."""
    return _rebuild(tree, {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                           else v for k, v in flatten(tree)})


class AsyncCheckpointer:
    """Writes off the training path: `save_async` snapshots the tree to
    host memory (`to_host`) on the caller's thread and returns; a worker
    thread serialises and writes, then keeps the newest `keep`.  The
    worker touches no device tensor, so it never enqueues on the compute
    stream.  `wait()` joins pending writes and raises a writer's error."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, extra = item
            try:
                save(self.ckpt_dir, step, tree, extra)
                gc_old(self.ckpt_dir, self.keep)
            except Exception as e:       # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self._q.put((step, to_host(tree), extra))

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=30)
