"""``save_state_dict`` / ``load_state_dict`` with reshard on load
(counterpart of ``paddle_tpu/distributed/checkpoint/save_load.py:45-448``).

The on-disk format is the reference's, so that either package reads the
other's checkpoints:

- one ``.npy`` file a shard, named ``<key with '.' and '/' as '_'>.<rank>.<n>.npy``,
  written whole under a temporary name and renamed;
- per-rank manifests ``metadata.json.<rank>``: ``{"save_id", "entries":
  {key: {"shape", "dtype", "shards": [{"file", "index": [[start, stop,
  step], ...], "crc32"}]}}}``, the crc32 that of the file's bytes;
- ``metadata.json``, the coordinator's merge of the manifests of this save
  (those with its ``save_id``, a nonce rank 0 draws and broadcasts).

A tensor's shard is what this rank holds of it: the slice of a sharded
parameter or optimizer state (``distributed._sharded``: its tensor slice,
and of that its slice along the shard axis), written by the first of the
ranks that hold that slice; a whole tensor is written by rank 0.
bfloat16 shards are raw 2-byte words (``uint16`` in the ``.npy``) with
the manifest's ``dtype`` saying "bfloat16", since numpy has no such type
here. Every rank writes into one shared directory.

``load_state_dict`` fills each target tensor in place with the part of
it that this rank holds, assembled from whatever shards were written: a
checkpoint saved by 2 ranks loads into 1 or 4, one saved at fsdp 2 x
tensor 2 into tensor 1. A shard whose bytes fail
their crc32, or that is missing, raises :class:`CheckpointCorruptError`.
``async_save=True`` copies the state to the host now and writes on a
thread; the next save or load of that path, or :func:`wait_async_save`,
waits for it and raises its error.
"""

from __future__ import annotations

import io
import json
import os
import random
import threading
import time
import zlib

import numpy as np
import torch

from .. import _sharded
from .. import env as _env

__all__ = ["save_state_dict", "load_state_dict", "wait_async_save", "CheckpointCorruptError"]

_META = "metadata.json"
_WAIT_S = 120

_pending: dict = {}
_pending_lock = threading.Lock()
_last_save_id: dict = {}


class CheckpointCorruptError(RuntimeError):
    """A shard failed its manifest checksum or is missing."""


class _Writer:
    def __init__(self, fn, path):
        self.exc = None
        self.path = path

        def run():
            try:
                fn()
            except BaseException as e:      # re-raised at the fence
                self.exc = e

        self.thread = threading.Thread(target=run, daemon=True)

    def join(self):
        self.thread.join()
        if self.exc is not None:
            raise RuntimeError(f"async checkpoint save to {self.path} failed") from self.exc


def _fence(path):
    key = os.path.abspath(path)
    with _pending_lock:
        w = _pending.get(key)
    if w is None:
        return
    try:
        w.join()
    finally:
        with _pending_lock:
            if _pending.get(key) is w:
                del _pending[key]


def wait_async_save(path=None):
    """Wait for the async save to ``path`` (every path when None)."""
    if path is not None:
        _fence(path)
        return
    with _pending_lock:
        keys = list(_pending)
    for k in keys:
        _fence(k)


def _flatten(prefix, obj, out):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        out[prefix] = obj
    return out


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t) -> np.ndarray:
    """A host copy; bfloat16 as its raw 2-byte words."""
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.contiguous().cpu().numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _part(t):
    """(index, writer, full shape) of what this rank holds of ``t``."""
    info = _sharded.info_of(t) if torch.is_tensor(t) else None
    if info is not None and (info.tdim is not None or (info.at_rest and info.dim is not None)):
        return info.held_index, info.writer, tuple(info.full_shape)
    shape = tuple(t.shape)
    return tuple(slice(0, n) for n in shape), _env.get_rank() == 0, shape


def _slices(index):
    return [[s.start, s.stop, 1] for s in index]


def _write_shard(path, fname, data) -> int:
    buf = io.BytesIO()
    np.save(buf, data)
    payload = buf.getvalue()
    tmp = os.path.join(path, f".{fname}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, os.path.join(path, fname))
    return zlib.crc32(payload)


def _nonce():
    nonce = (time.time_ns() ^ random.getrandbits(62)) & 0x7FFFFFFF
    if _env.is_initialized() and _env.get_world_size() > 1:
        from .. import collective as _c

        box = [nonce]
        _c.broadcast_object_list(box, src=0)
        nonce = box[0]
    return nonce


def _read_manifests(path, save_id):
    parts = {}
    for fn in sorted(os.listdir(path)):
        suffix = fn[len(_META) + 1:]
        if not fn.startswith(_META + ".") or not suffix.isdigit():
            continue
        try:
            with open(os.path.join(path, fn)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(doc, dict) and doc.get("save_id") == save_id:
            parts[int(suffix)] = doc["entries"]
    return parts


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0, unique_id=None,
                    async_save=False):
    """Write ``state_dict`` (nested dicts of tensors) to the directory
    ``path``; see the module docstring."""
    _fence(path)
    os.makedirs(path, exist_ok=True)
    rank, world = _env.get_rank(), _env.get_world_size()
    meta, shards = {}, []
    for name, value in _flatten("", state_dict, {}).items():
        index, writer, full = _part(value)
        entry = {"shape": list(full), "dtype": _dtype_name(value), "shards": []}
        if writer:
            fname = f"{name.replace('/', '_').replace('.', '_')}.{rank}.0.npy"
            rec = {"file": fname, "index": _slices(index)}
            shards.append((fname, _to_numpy(value), rec))
            entry["shards"].append(rec)
        meta[name] = entry
    save_id = unique_id if unique_id is not None else _nonce()
    _last_save_id[os.path.abspath(path)] = save_id

    def write():
        for fname, data, rec in shards:
            rec["crc32"] = _write_shard(path, fname, data)
        mine = os.path.join(path, f"{_META}.{rank}")
        with open(mine + ".tmp", "w") as f:
            json.dump({"save_id": save_id, "entries": meta}, f)
        os.replace(mine + ".tmp", mine)
        if rank != coordinator_rank:
            return
        deadline = time.monotonic() + _WAIT_S
        while True:
            parts = _read_manifests(path, save_id)
            if set(range(world)) <= set(parts):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"save_state_dict: manifests of ranks {sorted(parts)} for "
                                   f"save {save_id}, of a world of {world}: every rank must "
                                   "save into one shared directory")
            time.sleep(0.05)
        merged = {}
        for r in sorted(parts):
            for k, v in parts[r].items():
                if k not in merged:
                    merged[k] = v
                else:
                    merged[k]["shards"].extend(v["shards"])
        tmp = os.path.join(path, f"{_META}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"save_id": save_id, "entries": merged}, f, indent=1)
        os.replace(tmp, os.path.join(path, _META))

    if async_save:
        w = _Writer(write, path)
        with _pending_lock:
            _pending[os.path.abspath(path)] = w
        w.thread.start()
        return
    write()


def _read_meta(path, expect):
    deadline = time.monotonic() + (_WAIT_S if expect is not None else 0)
    while True:
        try:
            with open(os.path.join(path, _META)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = None
        if doc is not None:
            entries = doc.get("entries", doc) if isinstance(doc, dict) else doc
            if expect is None or doc.get("save_id") == expect:
                return entries
        if time.monotonic() > deadline:
            if doc is None:
                raise FileNotFoundError(f"{os.path.join(path, _META)}: no checkpoint manifest")
            raise FileNotFoundError(f"{path}: the manifest of save {expect} never appeared")
        time.sleep(0.05)


def _load_shard(path, shard, dtype_name):
    fpath = os.path.join(path, shard["file"])
    try:
        with open(fpath, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointCorruptError(f"{fpath}: shard unreadable ({e})") from e
    want = shard.get("crc32")
    if want is not None and zlib.crc32(blob) != want:
        raise CheckpointCorruptError(f"{fpath}: checksum mismatch (manifest {want}, file "
                                     f"{zlib.crc32(blob)}): a truncated or corrupt shard")
    return _from_numpy(np.load(io.BytesIO(blob), allow_pickle=False), dtype_name)


def _assemble(path, entry, index, dtype, device):
    """The part ``index`` of the saved tensor ``entry``, from every shard
    that overlaps it."""
    want = [(s.start, s.stop) for s in index]
    out = torch.empty([b - a for a, b in want], dtype=dtype)
    covered = torch.zeros(out.shape, dtype=torch.bool)
    shape = entry["shape"]
    for shard in entry["shards"]:
        have = [(a or 0, shape[d] if b is None else b) for d, (a, b, _) in enumerate(shard["index"])]
        lo = [max(a, c) for (a, _), (c, _) in zip(have, want)]
        hi = [min(b, d) for (_, b), (_, d) in zip(have, want)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = _load_shard(path, shard, entry["dtype"]).reshape(
            [b - a for a, b in have])
        src = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, have))
        dst = tuple(slice(l - c, h - c) for l, h, (c, _) in zip(lo, hi, want))
        out[dst] = data[src].to(dtype)
        covered[dst] = True
    if not bool(covered.all()):
        raise CheckpointCorruptError(f"{path}: the saved shards do not cover the part "
                                     f"{want} of a tensor of shape {entry['shape']}")
    return out.to(device)


def load_state_dict(state_dict, path, process_group=None, coordinator_rank=0, unique_id=None,
                    offload=False):
    """Fill every tensor of ``state_dict`` found in the checkpoint at
    ``path`` in place, with the part of it this rank holds; returns
    ``state_dict``."""
    _fence(path)
    meta = _read_meta(path, unique_id if unique_id is not None
                      else _last_save_id.get(os.path.abspath(path)))
    for name, target in _flatten("", state_dict, {}).items():
        if name not in meta or not torch.is_tensor(target):
            continue
        index, _, full = _part(target)
        if list(full) != list(meta[name]["shape"]):
            raise ValueError(f"{name}: the checkpoint holds shape {meta[name]['shape']}, the "
                             f"target {list(full)}")
        got = _assemble(path, meta[name], index, target.dtype, target.device)
        with torch.no_grad():
            target.copy_(got.reshape(target.shape))
    return state_dict
