"""Training checkpoints with a manifest committed last (the port's
counterpart of the JAX package's ``core/checkpoint.py``).

Layout: ``<output_dir>/epoch_{E}_step_{S}/`` holds ``model.pt`` (the
model's ``state_dict``: fp32 master weights under the names of
``models/gpt/convert.py``), ``optimizer.pt`` (the AdamW state) and
``meta.json`` (epoch, step, consumed samples, seed), each written with
``torch.save`` / ``json`` and fsynced. Then :func:`write_manifest`
commits ``pfx_manifest.json`` (file list, sizes and the small files'
hashes), written to a temporary name and renamed into place, the
directory fsynced: a directory without a committed manifest is a torn
save, and :func:`latest_checkpoint` never picks it. Saves are
synchronous in this slice.

LoRA adapters (:func:`save_adapter` / :func:`load_adapter`) are stored
in the JAX package's format, so either package reads the other's:
``adapter.npz`` holds the canonical tree's leaves (``core/adapters.py``)
as ``leaf{i}`` in sorted key order, ``adapter.json`` (``kind:
lora_adapter``) names each key's leaf, shape and dtype and carries the
caller's ``meta``, and the manifest is committed last.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.log import logger

_STEP_DIR = re.compile(r"epoch_(\d+)_step_(\d+)$")

#: commit marker written last; its presence means the save completed
MANIFEST_NAME = "pfx_manifest.json"

#: files at or under this size get a content hash in the manifest
_HASH_MAX_BYTES = 1 << 20


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed manifest verification."""


def write_manifest(path: str, meta: Optional[Dict[str, Any]] = None) -> str:
    """Commit the manifest of a completed step dir: relative file list,
    byte sizes and content hashes of the small files, written to a
    temporary name and renamed into place (the rename is the commit),
    then the directory fsynced. Returns the manifest's path."""
    files: Dict[str, int] = {}
    hashes: Dict[str, str] = {}
    for root, _dirs, names in os.walk(path):
        for name in names:
            if name == MANIFEST_NAME or name.endswith(".tmp"):
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            files[rel] = os.path.getsize(full)
            if files[rel] <= _HASH_MAX_BYTES:
                with open(full, "rb") as f:
                    hashes[rel] = hashlib.sha256(f.read()).hexdigest()
    payload = {"format": 1, "meta": meta or {}, "files": files,
               "sha256": hashes}
    final = os.path.join(path, MANIFEST_NAME)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    dirfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return final


def verify_checkpoint(path: str) -> Optional[str]:
    """None when ``path`` holds a committed, intact checkpoint; else the
    reason it must not be restored."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return "no committed manifest (save did not complete)"
    except (OSError, ValueError) as err:
        return f"unreadable manifest: {err}"
    for rel, size in payload.get("files", {}).items():
        try:
            actual = os.path.getsize(os.path.join(path, rel))
        except OSError:
            return f"missing file {rel}"
        if actual != int(size):
            return (f"size mismatch on {rel}: manifest says {size}, "
                    f"found {actual}")
    for rel, digest in payload.get("sha256", {}).items():
        try:
            with open(os.path.join(path, rel), "rb") as f:
                actual = hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return f"missing file {rel}"
        if actual != digest:
            return f"content hash mismatch on {rel}"
    return None


def _write(path: str, obj, as_json: bool = False) -> None:
    with open(path, "w" if as_json else "wb") as f:
        if as_json:
            json.dump(obj, f, sort_keys=True)
        else:
            torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def save_adapter(path: str, tree: Dict[str, Any],
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Persist one canonical LoRA adapter tree (``{"site/leaf":
    [num_layers, ...]}``, tensors or arrays) at ``path``: the leaves in
    ``adapter.npz``, the descriptor ``adapter.json`` with ``meta``
    verbatim, then the manifest (:func:`write_manifest`). Re-saving
    removes the old manifest first. Returns the manifest's path.

    Raises:
        ValueError: ``tree`` is empty.
    """
    if not tree:
        raise ValueError("refusing to save an empty adapter tree")
    os.makedirs(path, exist_ok=True)
    stale = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(stale):
        os.remove(stale)
    arrays: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict[str, Any]] = {}
    for i, key in enumerate(sorted(tree)):
        val = tree[key]
        arr = val.detach().cpu().numpy() if torch.is_tensor(val) \
            else np.asarray(val)
        arrays[f"leaf{i}"] = arr
        index[key] = {"npz": f"leaf{i}", "shape": list(arr.shape),
                      "dtype": str(arr.dtype)}
    with open(os.path.join(path, "adapter.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    _write(os.path.join(path, "adapter.json"),
           {"kind": "lora_adapter", "meta": meta or {}, "leaves": index},
           as_json=True)
    return write_manifest(path, {"kind": "lora_adapter",
                                 "leaves": len(index)})


def load_adapter(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(tree, meta)`` of a :func:`save_adapter` directory (numpy
    leaves).

    Raises:
        CheckpointCorrupt: the directory was never committed, fails
            verification, is not an adapter, or a leaf disagrees with
            its descriptor (a torn adapter would serve wrong deltas, so
            there is no fallback).
    """
    reason = verify_checkpoint(path)
    if reason is not None:
        raise CheckpointCorrupt(f"adapter at {path} refused: {reason}")
    try:
        with open(os.path.join(path, "adapter.json")) as f:
            desc = json.load(f)
        if desc.get("kind") != "lora_adapter":
            raise CheckpointCorrupt(f"{path} is not an adapter dir "
                                    f"(kind={desc.get('kind')!r})")
        tree: Dict[str, np.ndarray] = {}
        with np.load(os.path.join(path, "adapter.npz")) as npz:
            for key, ent in desc.get("leaves", {}).items():
                arr = npz[ent["npz"]]
                if list(arr.shape) != list(ent["shape"]) or \
                        str(arr.dtype) != ent["dtype"]:
                    raise CheckpointCorrupt(
                        f"adapter leaf {key} at {path}: descriptor says "
                        f"{ent['shape']}/{ent['dtype']}, npz holds "
                        f"{list(arr.shape)}/{arr.dtype}")
                tree[key] = arr
    except (OSError, ValueError, KeyError) as err:
        raise CheckpointCorrupt(
            f"adapter at {path} unreadable: {err}") from err
    if not tree:
        raise CheckpointCorrupt(f"adapter at {path} holds no leaves")
    return tree, desc.get("meta", {})


def save_checkpoint(output_dir: str, epoch: int, step: int,
                    model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict],
                    meta: Dict[str, Any]) -> str:
    """Write ``<output_dir>/epoch_{E}_step_{S}`` and commit its manifest;
    returns the directory. Re-saving a step first removes the old
    manifest, so a crash mid-rewrite leaves no marker over half-new
    bytes."""
    path = os.path.abspath(
        os.path.join(output_dir, f"epoch_{epoch}_step_{step}"))
    os.makedirs(path, exist_ok=True)
    stale = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(stale):
        os.remove(stale)
    _write(os.path.join(path, "model.pt"), model_state)
    if optimizer_state is not None:
        _write(os.path.join(path, "optimizer.pt"), optimizer_state)
    _write(os.path.join(path, "meta.json"), meta, as_json=True)
    write_manifest(path, meta)
    logger.info("saved checkpoint to %s", path)
    return path


def _step_dirs(ckpt_dir: str) -> List[Tuple[Tuple[int, int], str]]:
    """``((epoch, step), path)`` of every step dir below ``ckpt_dir``,
    newest first."""
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_DIR.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            out.append(((int(m.group(1)), int(m.group(2))),
                        os.path.join(ckpt_dir, name)))
    out.sort(reverse=True)
    return out


def latest_checkpoint(ckpt_dir: Optional[str]) -> Optional[str]:
    """``ckpt_dir`` itself when it names a step dir, else the newest
    VERIFIED ``epoch_*_step_*`` below it (torn or corrupt dirs are
    skipped with a warning), or None."""
    if ckpt_dir is None or not os.path.isdir(ckpt_dir):
        return None
    if _STEP_DIR.search(os.path.normpath(ckpt_dir)):
        return ckpt_dir
    for _key, path in _step_dirs(ckpt_dir):
        reason = verify_checkpoint(path)
        if reason is None:
            return path
        logger.warning("skipping unverified checkpoint %s: %s", path,
                       reason)
    return None


def load_checkpoint(path: str, device: torch.device
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict],
                               Dict[str, Any]]:
    """``(model_state, optimizer_state or None, meta)`` of a verified
    step dir, tensors on ``device``.

    Raises:
        CheckpointCorrupt: the directory fails verification.
    """
    reason = verify_checkpoint(path)
    if reason is not None:
        raise CheckpointCorrupt(f"{path}: {reason}")
    model_state = torch.load(os.path.join(path, "model.pt"),
                             map_location=device, weights_only=True)
    opt_path = os.path.join(path, "optimizer.pt")
    opt_state = torch.load(opt_path, map_location=device,
                           weights_only=True) \
        if os.path.isfile(opt_path) else None
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return model_state, opt_state, meta
