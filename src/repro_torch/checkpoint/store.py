"""Checkpoint store (port of ``repro.checkpoint.store``): atomic,
integrity-checked, device-placing restore.

Layout:  ``<dir>/step_<N:08d>/manifest.json`` + one ``<leaf_id>.npy`` per
leaf, byte for byte the reference's, so that each package reads what the
other wrote:

* A state is a nested dict of leaves, whose nodes may also be
  NamedTuples (a train state's ``optim.AdamWState``).  Leaf ids are the
  path keys joined with ``__`` (``"root"`` for a bare leaf), in sorted key
  order, as ``jax.tree_util`` flattens the same dicts; a NamedTuple's
  fields in field order, each as ``"." + name`` (``jax.tree_util``'s
  ``GetAttrKey``), so a train state's optimizer leaves are
  ``opt__.step``, ``opt__.mu__...`` and ``opt__.nu__...`` in both
  packages.
* The manifest records each leaf's shape, dtype name and the CRC32 of its
  bytes; the CRC is verified on load.
* Atomic: written to ``step_<N>.tmp`` then renamed, so a crash mid-save
  never corrupts the latest checkpoint.  ``keep_last`` prunes superseded
  steps.

Leaves are torch tensors (any device) or numpy arrays.  A bf16 tensor is
written as its 2-byte words under the descriptor ``'<V2'`` with the
manifest dtype ``"bfloat16"``: what ``np.save`` writes for an ml_dtypes
bfloat16 array, without needing ml_dtypes.  On restore each leaf takes the
dtype of the matching ``like`` leaf by reinterpreting its bytes, never by
converting values: a ``"bfloat16"`` leaf becomes ``torch.bfloat16``, and a
``"uint32"`` leaf (the reference's PRNG key words) becomes ``torch.int32``
when ``like`` asks for int32.  ``device=`` places the restored tensors (the
counterpart of the reference's ``shardings=``; a tensor-parallel engine
re-slices its pool through ``serving.device_kv.DeviceKV.load``).

A state sharded over a ``("data", "model")`` mesh is saved and restored
in the same layout, whole leaves: every rank calls
``save_checkpoint(whole=...)``, which puts one leaf at a time back
together from every rank's shard (a collective), and only the rank
passing ``write=True`` writes; every rank restores its own shards of the
whole leaves (``restore_checkpoint(shard=...)``).  So a run saved under
a mesh resumes on one process, and the reverse.
"""

from __future__ import annotations

import json
import shutil
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike

# manifest dtype names a ``like`` leaf of each torch dtype accepts (bytes
# reinterpreted); any other dtype accepts only its own name
_ACCEPTS = {torch.int32: ("int32", "uint32"),
            torch.bfloat16: ("bfloat16",)}


def _leaf_id(prefix: tuple) -> str:
    return "__".join(prefix) or "root"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaves_with_paths(tree, prefix: tuple = ()) -> list:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves_with_paths(tree[k], prefix + (k,)))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out.extend(_leaves_with_paths(getattr(tree, f),
                                          prefix + ("." + f,)))
        return out
    return [(_leaf_id(prefix), tree)]


def _unflatten(like, leaves: dict, prefix: tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (k,))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves,
                                       prefix + ("." + f,))
                            for f in like._fields))
    return leaves[_leaf_id(prefix)]


def _to_numpy(leaf) -> tuple[np.ndarray, str, Optional[str]]:
    """(C-ordered array of the leaf's bytes, manifest dtype name, the .npy
    descriptor to write when np.save would not write it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), \
                "bfloat16", "<V2"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, str(arr.dtype), None


def _write_npy(path: Path, arr: np.ndarray, descr: Optional[str]) -> None:
    if descr is None:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes())


def save_checkpoint(directory, step: int, state, keep_last: int = 3,
                    extra: Optional[dict] = None, whole=None,
                    write: bool = True) -> Optional[Path]:
    """Write ``state`` as ``step``.  ``whole(leaf_id, leaf)``, where
    given, is called for every leaf in order (on every rank of a mesh)
    and returns the whole leaf that is written; a rank with
    ``write=False`` writes nothing and returns None."""
    if not write:
        for pid, leaf in _leaves_with_paths(state):
            whole(pid, leaf)
        return None
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for pid, leaf in _leaves_with_paths(state):
        arr, dtype, descr = _to_numpy(leaf if whole is None
                                      else whole(pid, leaf))
        _write_npy(tmp / f"{pid}.npy", arr, descr)
        manifest["leaves"][pid] = {
            "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish

    # retention
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for old in steps[:-keep_last]:
        shutil.rmtree(old)
    return final


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1])
        for p in directory.glob("step_*")
        if p.is_dir() and not p.name.endswith(".tmp")
    )
    return steps[-1] if steps else None


def read_manifest(directory, step: Optional[int] = None) -> dict:
    """A checkpoint's manifest (leaf metadata and the ``extra`` dict),
    read without touching the leaves: the serving snapshot builds its
    ``like`` tree from the host state in ``extra``."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    src = directory / f"step_{step:08d}"
    return json.loads((src / "manifest.json").read_text())


def _as_like(arr: np.ndarray, meta: dict, like: torch.Tensor, pid: str):
    """The leaf read from disk as a tensor of ``like``'s dtype, its bytes
    reinterpreted (never its values converted)."""
    if meta["dtype"] not in _ACCEPTS.get(
            like.dtype, (str(like.dtype).removeprefix("torch."),)):
        raise ValueError(f"checkpoint leaf {pid} is {meta['dtype']}, "
                         f"the restore wants {like.dtype}")
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {pid} has shape {arr.shape}, "
                         f"the restore wants {tuple(like.shape)}")
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
    return torch.from_numpy(arr.view(np_dtype))


def restore_checkpoint(directory, step: int, like,
                       device: DeviceLike = None, shard=None):
    """Restore into the structure of ``like``, a tree of tensors (meta
    tensors will do: only their dtypes and shapes are read); the leaves
    land on ``device`` (default: the CPU).  ``shard(leaf_id, leaf)``,
    where given, cuts each whole leaf read to what this rank keeps
    (``like`` then has the whole shapes).  Returns (state, manifest)."""
    src = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    leaves = {}
    for pid, leaf in _leaves_with_paths(like):
        meta = manifest["leaves"].get(pid)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {pid}")
        arr = np.load(src / f"{pid}.npy")
        crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
        if crc != meta["crc32"]:
            raise IOError(f"checkpoint leaf {pid} corrupt (crc mismatch)")
        out = _as_like(arr, meta, leaf, pid)
        if shard is not None:
            out = shard(pid, out)
        if device is not None:
            out = out.to(device)
        leaves[pid] = out
    return _unflatten(like, leaves), manifest


__all__ = ["save_checkpoint", "restore_checkpoint", "read_manifest",
           "latest_step"]
