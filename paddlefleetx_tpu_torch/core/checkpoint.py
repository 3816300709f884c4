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
save, and :func:`latest_checkpoint` never picks it; a directory whose
contents disagree with its manifest is corrupt, and
:func:`load_checkpoint` with a ``fallback_dir`` falls back to the newest
older verified step, with a ``ckpt_fallback`` event.

``save_checkpoint(..., async_save=True)`` snapshots the model and
optimizer state into pinned host buffers (allocated once and reused by
every later save of the same shapes): the device-to-host copies run on
a copy stream ordered after the work queued so far on the compute
stream, and :func:`fence_pending_snapshot` makes the compute stream
wait for them before the next optimizer step writes the parameters and
moments in place. A writer thread (timeline track ``ckpt-writer``)
waits for the copies, writes the files and commits the manifest last;
:func:`wait_for_pending_save` joins it (the next save, a resolve, a
load and the interpreter's exit all do). :func:`gc_checkpoints` keeps
the newest ``keep_last_k`` verified step directories; the manifest
gates it, so it never deletes an uncommitted directory (an async save
in flight).

A serving prefix store (:func:`save_prefix_store` /
:func:`load_prefix_store`: a tiered server's host-resident KV pages and
the registry entries that reach them, ``GenerationServer.
export_prefix_store``) is a directory of ``host_pages.npz`` and
``prefix_store.json``, its manifest committed last; a torn or altered
store is refused on load.

LoRA adapters (:func:`save_adapter` / :func:`load_adapter`) are stored
in the JAX package's format, so either package reads the other's:
``adapter.npz`` holds the canonical tree's leaves (``core/adapters.py``)
as ``leaf{i}`` in sorted key order, ``adapter.json`` (``kind:
lora_adapter``) names each key's leaf, shape and dtype and carries the
caller's ``meta``, and the manifest is committed last.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import timeline
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


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_prefix_store(path: str, store: Dict[str, Any]) -> str:
    """Persist a serving prefix store
    (``GenerationServer.export_prefix_store``) as a committed-last
    directory: the page rows as one ``host_pages.npz``, the registry
    structure, the geometry, the model fingerprint and the npz's
    SHA-256 as ``prefix_store.json``, then the :func:`write_manifest`
    rename commit. A torn write leaves no manifest, and
    :func:`load_prefix_store` refuses it. Returns the manifest path."""
    os.makedirs(path, exist_ok=True)
    # decommit a stale manifest FIRST, so a crash mid-rewrite cannot
    # leave a marker that attests to half-new bytes
    stale = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(stale):
        os.remove(stale)
    arrays: Dict[str, Any] = {}
    pages_index: Dict[str, int] = {}
    for hpid, leaves in store.get("pages", {}).items():
        pages_index[str(int(hpid))] = len(leaves)
        for i, leaf in enumerate(leaves):
            arrays[f"p{int(hpid)}_{i}"] = np.asarray(leaf)
    prompts = []
    n_payload = 0
    for key, (pages, payload) in store.get("prompts", {}).items():
        idx = None
        if payload is not None:
            idx = n_payload
            arrays[f"payload{idx}"] = np.asarray(payload)
            n_payload += 1
        prompts.append([key, [int(p) for p in pages], idx])
    npz = os.path.join(path, "host_pages.npz")
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    meta = {"kind": "prefix_store",
            "page_size": int(store["page_size"]),
            "kv_cache_dtype": store["kv_cache_dtype"],
            "model_fingerprint": store.get("model_fingerprint"),
            "pages": pages_index,
            "prefixes": [[k, int(p)]
                         for k, p in store.get("prefixes", {}).items()],
            "prompts": prompts,
            # the manifest hashes small files only: the page rows carry
            # their own digest, so a flipped byte is refused at any size
            "host_pages_sha256": _file_sha256(npz)}
    _write(os.path.join(path, "prefix_store.json"), meta, as_json=True)
    return write_manifest(path, {"kind": "prefix_store",
                                 "pages": len(pages_index)})


def load_prefix_store(path: str, recorder=None
                      ) -> Optional[Dict[str, Any]]:
    """Load a :func:`save_prefix_store` directory back into the dict
    ``GenerationServer.import_prefix_store`` takes. Refuses (None: the
    caller starts cold, with a ``prefix_store_rejected`` event) a
    directory that was never committed, fails verification or whose
    page rows do not match their digest: a warm start from torn KV
    bytes would serve wrong attention."""
    reason = verify_checkpoint(path)
    meta = None
    if reason is None:
        try:
            with open(os.path.join(path, "prefix_store.json")) as f:
                meta = json.load(f)
            if _file_sha256(os.path.join(path, "host_pages.npz")) != \
                    meta.get("host_pages_sha256"):
                reason = "content hash mismatch on host_pages.npz"
        except (OSError, ValueError) as err:
            reason = f"unreadable prefix store: {err}"
    if reason is not None:
        logger.warning("prefix store at %s refused: %s", path, reason)
        if recorder is not None:
            recorder.emit("prefix_store_rejected", path=path, reason=reason)
        return None
    try:
        # every array materializes inside the context, so the file
        # closes here rather than at garbage collection
        with np.load(os.path.join(path, "host_pages.npz")) as npz:
            pages = {int(h): [npz[f"p{int(h)}_{i}"] for i in range(n)]
                     for h, n in meta.get("pages", {}).items()}
            prompts = {k: ([int(p) for p in pids],
                           npz[f"payload{idx}"] if idx is not None
                           else None)
                       for k, pids, idx in meta.get("prompts", [])}
    except (OSError, ValueError, KeyError) as err:
        logger.warning("prefix store at %s unreadable: %s", path, err)
        return None
    return {"page_size": meta["page_size"],
            "kv_cache_dtype": meta["kv_cache_dtype"],
            "model_fingerprint": meta.get("model_fingerprint"),
            "pages": pages,
            "prefixes": {k: int(p) for k, p in meta.get("prefixes", [])},
            "prompts": prompts}


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


#: guards the in-flight async save below (the writer thread and the
#: training loop both reach it)
_STATE_LOCK = threading.Lock()

#: the async save whose writer thread has not been joined yet
_PENDING: Optional["_AsyncSave"] = None

#: the snapshot copies the next optimizer step must wait for
_SNAPSHOT_EVENT: Optional[Any] = None

#: host buffers of the async snapshots, by state key, reused by every
#: save of the same shape and dtype (pinned on the card's host)
_HOST_BUFFERS: Dict[str, torch.Tensor] = {}


class _AsyncSave:
    """One async save in flight: its directory, its writer thread and
    the error the thread met, if any."""

    def __init__(self, path: str):
        self.path = path
        self.thread: Optional[threading.Thread] = None
        self.errors: List[BaseException] = []


def _host_buffer(key: str, t: torch.Tensor) -> torch.Tensor:
    buf = _HOST_BUFFERS.get(key)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=t.device.type == "cuda")
        _HOST_BUFFERS[key] = buf
    return buf


def _snapshot(obj, key: str = ""):
    """``obj`` (a state dict: nested dicts, lists and tuples) with every
    tensor copied into its host buffer; the device copies are queued
    non-blocking on the current stream."""
    if isinstance(obj, torch.Tensor):
        buf = _host_buffer(key, obj)
        buf.copy_(obj.detach(), non_blocking=obj.device.type == "cuda")
        return buf
    if isinstance(obj, dict):
        return {k: _snapshot(v, f"{key}/{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v, f"{key}/{i}")
                         for i, v in enumerate(obj))
    return obj


def _device_of(state) -> Optional[torch.device]:
    for t in (state or {}).values():
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def fence_pending_snapshot() -> None:
    """Make the current CUDA stream wait for the last async snapshot's
    copies (a no-op when none is pending or on the CPU): called before
    an optimizer step writes the parameters and moments in place."""
    global _SNAPSHOT_EVENT
    with _STATE_LOCK:
        event, _SNAPSHOT_EVENT = _SNAPSHOT_EVENT, None
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


def _write_files(path: str, model_state, optimizer_state, meta,
                 event, errors: List[BaseException]) -> None:
    """The writer thread: wait for the snapshot's copies, write the
    files, commit the manifest last."""
    tl = timeline.track("ckpt-writer")
    t0 = tl.begin()
    try:
        if event is not None:
            event.synchronize()
        tl.add("wait", t0)
        t0 = tl.begin()
        _write_step_dir(path, model_state, optimizer_state, meta)
        tl.add("write", t0)
    except BaseException as err:  # noqa: BLE001 -- raised by the joiner
        errors.append(err)


def _write_step_dir(path, model_state, optimizer_state, meta) -> None:
    _write(os.path.join(path, "model.pt"), model_state)
    if optimizer_state is not None:
        _write(os.path.join(path, "optimizer.pt"), optimizer_state)
    _write(os.path.join(path, "meta.json"), meta, as_json=True)
    write_manifest(path, meta)
    logger.info("saved checkpoint to %s", path)


def wait_for_pending_save() -> None:
    """Block until the async save in flight (if any) has written its
    files and committed its manifest.

    Raises:
        RuntimeError: the writer thread failed (its directory stays
            uncommitted, so no resolve picks it).
    """
    global _PENDING
    with _STATE_LOCK:
        pending, _PENDING = _PENDING, None
    if pending is None:
        return
    pending.thread.join()
    if pending.errors:
        raise RuntimeError(f"async checkpoint save to {pending.path} "
                           f"failed") from pending.errors[0]


atexit.register(wait_for_pending_save)


def save_checkpoint(output_dir: str, epoch: int, step: int,
                    model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict],
                    meta: Dict[str, Any], async_save: bool = False) -> str:
    """Write ``<output_dir>/epoch_{E}_step_{S}`` and commit its manifest;
    returns the directory. Re-saving a step first removes the old
    manifest, so a crash mid-rewrite leaves no marker over half-new
    bytes. At most one save is in flight: a save first waits for the
    previous async one. With ``async_save`` the state is snapshotted
    (module docstring) and the files are written by a thread while
    training goes on."""
    global _PENDING, _SNAPSHOT_EVENT
    wait_for_pending_save()
    path = os.path.abspath(
        os.path.join(output_dir, f"epoch_{epoch}_step_{step}"))
    os.makedirs(path, exist_ok=True)
    stale = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(stale):
        os.remove(stale)
    if not async_save:
        _write_step_dir(path, model_state, optimizer_state, meta)
        return path
    device = _device_of(model_state)
    event = None
    if device is not None and device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            model_host = _snapshot(model_state, "model")
            opt_host = _snapshot(optimizer_state, "optimizer")
            event = torch.cuda.Event()
            event.record(stream)
    else:
        model_host = _snapshot(model_state, "model")
        opt_host = _snapshot(optimizer_state, "optimizer")
    save = _AsyncSave(path)
    save.thread = threading.Thread(
        target=_write_files, name="ckpt-writer",
        args=(path, model_host, opt_host, dict(meta), event, save.errors))
    with _STATE_LOCK:
        _PENDING = save
        _SNAPSHOT_EVENT = event
    save.thread.start()
    logger.info("async checkpoint save started to %s", path)
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


def latest_checkpoint(ckpt_dir: Optional[str], recorder=None
                      ) -> Optional[str]:
    """``ckpt_dir`` itself when it names a step dir, else the newest
    VERIFIED ``epoch_*_step_*`` below it, or None. Torn or corrupt dirs
    are skipped with a warning; when that passes over newer dirs, a
    ``ckpt_fallback`` event (``stage: resolve``) goes to ``recorder``.
    An async save in flight is waited for first."""
    wait_for_pending_save()
    if ckpt_dir is None or not os.path.isdir(ckpt_dir):
        return None
    if _STEP_DIR.search(os.path.normpath(ckpt_dir)):
        return ckpt_dir
    skipped: List[Dict[str, str]] = []
    for _key, path in _step_dirs(ckpt_dir):
        reason = verify_checkpoint(path)
        if reason is None:
            if skipped and recorder is not None:
                recorder.emit("ckpt_fallback", to=path, skipped=skipped,
                              stage="resolve")
            return path
        logger.warning("skipping unverified checkpoint %s: %s", path,
                       reason)
        skipped.append({"path": path, "reason": reason})
    if skipped and recorder is not None:
        recorder.emit("ckpt_fallback", to=None, skipped=skipped,
                      stage="resolve")
    return None


def _restore(path: str, device: torch.device):
    model_state = torch.load(os.path.join(path, "model.pt"),
                             map_location=device, weights_only=True)
    opt_path = os.path.join(path, "optimizer.pt")
    opt_state = torch.load(opt_path, map_location=device,
                           weights_only=True) \
        if os.path.isfile(opt_path) else None
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return model_state, opt_state, meta


def load_checkpoint(path: str, device: torch.device,
                    fallback_dir: Optional[str] = None, recorder=None
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict],
                               Dict[str, Any]]:
    """``(model_state, optimizer_state or None, meta)`` of a verified
    step dir, tensors on ``device``. With ``fallback_dir``, a step dir
    that fails verification (or whose read fails) gives way to the
    newest OLDER verified step dir below ``fallback_dir``, each
    rejection emitting a ``ckpt_fallback`` event (``stage: load``) to
    ``recorder``; without it a verification failure raises.

    Raises:
        CheckpointCorrupt: no candidate verifies.
    """
    wait_for_pending_save()
    path = os.path.abspath(path)
    candidates = [path]
    if fallback_dir is not None and os.path.isdir(fallback_dir):
        mine = _STEP_DIR.search(path)
        my_key = (int(mine.group(1)), int(mine.group(2))) if mine \
            else None
        for key, p in _step_dirs(fallback_dir):
            if os.path.abspath(p) == path:
                continue
            if my_key is not None and key >= my_key:
                continue   # fall BACK, never forward past the target
            candidates.append(os.path.abspath(p))
    last_reason = None
    for i, cand in enumerate(candidates):
        reason = verify_checkpoint(cand)
        if reason is None:
            try:
                out = _restore(cand, device)
            except Exception as err:  # an intact manifest, a failed read
                reason = f"restore failed: {err!r}"
                if fallback_dir is None or i == len(candidates) - 1:
                    raise
            else:
                if i > 0:
                    logger.warning("restored FALLBACK checkpoint %s "
                                   "(newest was %s: %s)", cand,
                                   candidates[0], last_reason)
                return out
        last_reason = reason
        logger.error("checkpoint %s failed verification: %s", cand,
                     reason)
        if recorder is not None:
            recorder.emit("ckpt_fallback", rejected=cand, reason=reason,
                          stage="load",
                          remaining=len(candidates) - 1 - i)
        if fallback_dir is None:
            raise CheckpointCorrupt(f"{cand}: {reason}")
    raise CheckpointCorrupt(
        f"no verified checkpoint among {len(candidates)} candidates "
        f"(newest: {candidates[0]}: {last_reason})")


def gc_checkpoints(output_dir: str, keep_last_k: int,
                   recorder=None) -> List[str]:
    """Delete all but the newest ``keep_last_k`` VERIFIED step dirs
    under ``output_dir``; returns the deleted paths. An unverified dir
    (an async save in flight, or a torn one) is never a candidate, so
    GC does not wait for a save. Each deletion removes the manifest
    first (a kill mid-``rmtree`` leaves an unverifiable stub, not a
    manifest over missing files); a ``ckpt_gc`` event goes to
    ``recorder``. ``keep_last_k < 1`` keeps everything."""
    if keep_last_k is None or keep_last_k < 1:
        return []
    if not os.path.isdir(output_dir):
        return []
    verified = [p for _key, p in _step_dirs(output_dir)
                if verify_checkpoint(p) is None]
    deleted = []
    for path in verified[keep_last_k:]:
        try:
            os.remove(os.path.join(path, MANIFEST_NAME))
        except OSError as err:
            logger.warning("ckpt gc: cannot decommit %s (%s); leaving it",
                           path, err)
            continue
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
        logger.info("ckpt gc: deleted %s (keep_last_k=%d)", path,
                    keep_last_k)
    if deleted and recorder is not None:
        recorder.emit("ckpt_gc", deleted=deleted, keep_last_k=keep_last_k,
                      kept=verified[:keep_last_k])
    return deleted
