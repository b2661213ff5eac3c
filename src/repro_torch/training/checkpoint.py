"""Fault-tolerant checkpointing: sharded, atomic, resumable.

Port of ``repro/training/checkpoint.py``, in its on-disk format (the
reference's code, which its docstring predates), so a checkpoint of
either package restores in the other::

    ckpt_dir/
      step_000000100.tmp/       # written first
        manifest.json           # step, tree structure, leaf shapes/dtypes
        shard_00000.bin         # per leaf: int64 length, then its bytes
      step_000000100/           # renamed after fsync => commit
      LATEST                    # the last committed step's directory

Leaves go in ``jax.tree_util``'s order (``core.tree``).  Each leaf's
bytes are zstd-compressed when ``zstandard`` imports, else stored raw;
the manifest's ``codec`` says which, and a zstd checkpoint on a host
without the package raises.  bf16 leaves are written as their uint16
bits under the dtype name ``bfloat16`` (numpy has no bf16 of its own)
and read back the same way, with no ``ml_dtypes``.  A crashed write
(a ``.tmp`` directory) never shadows a committed step: restore deletes
it and loads the newest committed one.  Restored leaves are tensors on
the device of the matching leaf of ``tree_like``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten

try:
    import zstandard
except ModuleNotFoundError:          # host without zstd: store raw
    zstandard = None


class _RawCodec:
    def compress(self, b: bytes) -> bytes:
        return b

    def decompress(self, b: bytes) -> bytes:
        return b


_CODEC = (zstandard.ZstdCompressor(level=3) if zstandard is not None
          else _RawCodec())
_CODEC_NAME = "zstd" if zstandard is not None else "raw"


def _decompressor(codec: str):
    """The decompressor of the manifest's codec: raw checkpoints load
    anywhere; zstd ones need the package."""
    if codec == "raw":
        return _RawCodec()
    if zstandard is None:
        raise RuntimeError(
            f"checkpoint was written with codec {codec!r} but the "
            f"zstandard package is not installed")
    return zstandard.ZstdDecompressor()


def _leaf_bytes(leaf: Any) -> Tuple[bytes, list, str]:
    """(raw bytes, shape, numpy dtype name) of a tensor (or array) leaf."""
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                "bfloat16")
    arr = t.numpy()
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_from_bytes(raw: bytes, spec: Dict[str, Any],
                     like: Any) -> torch.Tensor:
    shape = spec["shape"]
    if spec["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(shape).copy()
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        arr = np.frombuffer(raw, np.dtype(spec["dtype"])).reshape(
            shape).copy()
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def save(ckpt_dir: str, step: int, tree: Any, *, process_index: int = 0,
         keep: int = 3) -> str:
    """Atomically write a checkpoint; returns the committed path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, spec = tree_flatten(tree)
    blobs = [_leaf_bytes(leaf) for leaf in leaves]
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": repr(spec),
        "leaves": [{"shape": shape, "dtype": dtype}
                   for _, shape, dtype in blobs],
        "num_leaves": len(leaves),
        "process_index": process_index,
        "codec": _CODEC_NAME,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    shard = os.path.join(tmp, f"shard_{process_index:05d}.bin")
    with open(shard, "wb") as f:
        for raw, _, _ in blobs:
            comp = _CODEC.compress(raw)
            f.write(np.array([len(comp)], np.int64).tobytes())
            f.write(comp)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)           # atomic commit
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step, resilient to a stale LATEST pointer."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for entry in os.listdir(ckpt_dir):
        if entry.startswith("step_") and not entry.endswith(".tmp"):
            try:
                steps.append(int(entry.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            process_index: int = 0) -> Tuple[int, Any]:
    """Load (step, tree).  ``tree_like`` gives the structure and each
    leaf's device; shapes and dtypes come from the manifest.  Tolerates
    interrupted writes: ``.tmp`` directories are removed; raises
    ``ValueError`` when the leaf counts differ."""
    for entry in list(os.listdir(ckpt_dir)):
        if entry.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, entry), ignore_errors=True)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    decodec = _decompressor(manifest.get("codec", "zstd"))
    leaves_like, spec = tree_flatten(tree_like)
    if manifest["num_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, "
            f"expected {len(leaves_like)}")
    out = []
    shard = os.path.join(path, f"shard_{process_index:05d}.bin")
    with open(shard, "rb") as f:
        for leaf_spec, like in zip(manifest["leaves"], leaves_like):
            n = np.frombuffer(f.read(8), np.int64)[0]
            raw = decodec.decompress(f.read(int(n)))
            out.append(_leaf_from_bytes(raw, leaf_spec, like))
    return manifest["step"], spec.unflatten(out)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(e.split("_")[1]) for e in os.listdir(ckpt_dir)
        if e.startswith("step_") and not e.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
