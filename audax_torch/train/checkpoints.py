"""Checkpoints: one-shot tree saves and a step-indexed manager (port of
``audax/train/checkpoints.py``: ``save_pytree``, ``load_pytree``,
``CheckpointManager``), with a reader for the JAX package's orbax
checkpoints.

A tree is nested dicts, lists, tuples and named tuples whose leaves are
tensors (or numpy arrays), Python scalars, strings or None. The port's
format is a directory of two files:

  * ``tree.pt`` -- ``torch.save`` of a nested dict of tensors that mirrors
    the tree (a list's or tuple's items under the keys "0", "1", ...),
    read back with ``torch.load(weights_only=True)``;
  * ``tree.json`` -- the record of the tree: each container's kind (a
    named tuple's class name and fields), where its tensors sit, and the
    value of each scalar, string or None.

The writer never pickles Python objects, so a checkpoint loads with no
code of the saver. Without a ``target`` a tree comes back as plain
containers (a named tuple as a dict of its fields, as an orbax restore
without a target gives) with its tensors on the CPU; with one, it takes the
target's structure, container types, dtypes and devices.

Async contract, as in JAX: ``CheckpointManager.save`` snapshots the state
to host copies on the caller's thread and returns; one worker thread writes
the snapshots in order, so the write overlaps the next epoch's compute.
``wait()``/``close()`` finish every pending write. ``save_pytree`` is the
synchronous one-shot; ``block=False`` returns a handle whose
``wait_until_finished()`` finishes the write. A write goes to a temporary
directory that is renamed into place, so a reader never sees half a
checkpoint.

``load_pytree`` also reads a directory that the JAX package's orbax
``save_pytree`` or ``CheckpointManager`` wrote (``_METADATA`` holds the
tree's paths; every leaf is a zarr array in an OCDBT key-value store), with
no ``jax`` and no ``orbax``: ``read_orbax`` opens each leaf with
``tensorstore``, imported inside the function (``ImportError`` naming it
where it is missing). It is the carry-across for a user's trained JAX
checkpoint; PyTorch's side of the card machine has no tensorstore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "load_pytree", "read_orbax",
           "PendingSave"]

_TENSORS = "tree.pt"
_RECORD = "tree.json"
_FORMAT = "audax_torch.pytree/1"


# ----------------------------------------------------------- the format ----
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _snapshot(tree) -> tuple:
    """(record, tensors): the tree's JSON record and the nested dict of
    host copies of its tensors, taken now (later in-place updates of the
    caller's tensors do not reach the write)."""
    if isinstance(tree, dict):
        rec, ten = {}, {}
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"tree keys must be str, got {k!r}")
            rec[k], t = _snapshot(v)
            if t is not None:
                ten[k] = t
        return {"kind": "dict", "items": rec}, ten
    if isinstance(tree, (list, tuple)):
        parts = [_snapshot(v) for v in tree]
        rec = {"kind": "list" if isinstance(tree, list) else "tuple",
               "items": [r for r, _ in parts]}
        if _is_namedtuple(tree):
            rec.update(name=type(tree).__name__, fields=list(tree._fields))
        return rec, {str(i): t for i, (_, t) in enumerate(parts)
                     if t is not None}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.array(tree, copy=True))
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return {"kind": "tensor"}, t
    if isinstance(tree, np.generic):
        tree = tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"kind": "value", "value": tree}, None
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _rebuild(rec: dict, ten):
    """The plain tree of a record and its loaded tensors."""
    kind = rec["kind"]
    if kind == "dict":
        return {k: _rebuild(r, (ten or {}).get(k))
                for k, r in rec["items"].items()}
    if kind in ("list", "tuple"):
        items = [_rebuild(r, (ten or {}).get(str(i)))
                 for i, r in enumerate(rec["items"])]
        if rec.get("fields"):
            return dict(zip(rec["fields"], items))
        return items if kind == "list" else tuple(items)
    if kind == "tensor":
        return ten
    return rec["value"]


def _write(path: str, record: dict, tensors) -> None:
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tensors if tensors is not None else {},
               os.path.join(tmp, _TENSORS))
    with open(os.path.join(tmp, _RECORD), "w") as fh:
        json.dump({"format": _FORMAT, "tree": record}, fh)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _read(path: str):
    with open(os.path.join(path, _RECORD)) as fh:
        meta = json.load(fh)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{meta.get('format')!r}")
    tensors = torch.load(os.path.join(path, _TENSORS), map_location="cpu",
                         weights_only=True)
    return _rebuild(meta["tree"], tensors)


def _match(target, raw, where: str = ""):
    """``raw`` (a plain tree) in ``target``'s structure: its container
    types, tensor dtypes and devices, and scalar types."""
    if isinstance(target, dict):
        if not isinstance(raw, dict):
            raise ValueError(f"{where or '/'}: expected a dict, found "
                             f"{type(raw).__name__}")
        missing = sorted(set(target) - set(raw))
        if missing:
            raise KeyError(f"{where or '/'}: the checkpoint lacks {missing}")
        return {k: _match(v, raw[k], f"{where}/{k}")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if isinstance(raw, dict) and _is_namedtuple(target) \
                and set(target._fields) <= set(raw):
            items = [raw[f] for f in target._fields]
        else:
            items = list(raw.values()) if isinstance(raw, dict) else list(raw)
        if len(items) != len(target):
            raise ValueError(f"{where}: {len(items)} items, the target has "
                             f"{len(target)}")
        out = [_match(t, r, f"{where}/{i}")
               for i, (t, r) in enumerate(zip(target, items))]
        if _is_namedtuple(target):
            return type(target)(*out)
        return type(target)(out)
    if isinstance(target, torch.Tensor):
        raw = torch.as_tensor(raw)
        if tuple(raw.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {tuple(raw.shape)}, the target "
                             f"has {tuple(target.shape)}")
        return raw.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return np.asarray(torch.as_tensor(raw).cpu().numpy(),
                          dtype=target.dtype)
    if isinstance(target, (bool, int, float)):
        return type(target)(raw.item() if isinstance(raw, torch.Tensor)
                            else raw)
    return raw


# ------------------------------------------------------- the orbax reader --
def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def read_orbax(path: str):
    """A tree written by the JAX package's orbax ``save_pytree`` (or one step
    of its ``CheckpointManager``: ``<dir>/<step>`` or its ``default``
    item), as plain containers of CPU tensors and Python scalars, read with
    ``tensorstore`` alone. Sequences come back as lists, named tuples and
    dataclasses as dicts (orbax records their fields as keys)."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("reading an orbax checkpoint needs the "
                          "'tensorstore' package, which is not "
                          "installed") from e
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, "_METADATA")):
        path = os.path.join(path, "default")
    with open(os.path.join(path, "_METADATA")) as fh:
        meta = json.load(fh)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    root: Dict[str, Any] = {}
    seqs = set()                    # id() of the nodes keyed by index
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        node = root
        for k in keys[:-1]:
            if k["key_type"] == 1:
                seqs.add(id(node))
            node = node.setdefault(k["key"], {})
        if keys[-1]["key_type"] == 1:
            seqs.add(id(node))
        if value.get("skip_deserialize") or value["value_type"] == "None":
            node[keys[-1]["key"]] = None
            continue
        name = ".".join(k["key"] for k in keys)
        if meta.get("use_ocdbt", True):
            kv = {"driver": "ocdbt", "base": f"file://{path}", "path": name}
        else:
            kv = {"driver": "file", "path": os.path.join(path, name)}
        arr = ts.open({"driver": driver, "kvstore": kv}).result() \
            .read().result()
        node[keys[-1]["key"]] = (arr.item() if value["value_type"] == "scalar"
                                 else _to_tensor(arr))

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if id(node) in seqs:
            return [out[k] for k in sorted(out, key=int)]
        return out
    return fix(root)


def _is_orbax(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, *p, "_METADATA"))
               for p in ((), ("default",)))


# ------------------------------------------------------------ one-shots ----
class PendingSave:
    """An asynchronous write; ``wait_until_finished()`` finishes it (and
    raises what the write raised)."""

    def __init__(self, future: Future):
        self._future = future

    def wait_until_finished(self) -> None:
        self._future.result()


def save_pytree(path: str, tree: Any, *, block: bool = True
                ) -> Optional[PendingSave]:
    """One-shot tree save (standalone artifacts). The tensors are copied to
    the host before it returns; ``block=False`` leaves the file write to a
    worker thread and returns its ``PendingSave``."""
    record, tensors = _snapshot(tree)
    if block:
        _write(path, record, tensors)
        return None
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="audax-ckpt")
    future = pool.submit(_write, path, record, tensors)
    pool.shutdown(wait=False)            # the worker ends after the write
    return PendingSave(future)


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """Restore a tree the port's ``save_pytree`` wrote, or an orbax one of
    the JAX package (``read_orbax``). With ``target`` the result matches its
    structure, dtypes and devices; without, plain containers of CPU
    tensors."""
    path = os.path.abspath(path)
    raw = (_read(path) if os.path.exists(os.path.join(path, _RECORD))
           else read_orbax(path) if _is_orbax(path)
           else None)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    return raw if target is None else _match(target, raw)


# --------------------------------------------------------------- manager ----
class CheckpointManager:
    """Step-indexed checkpoints (``<directory>/<step>``) with best-metric
    tracking and resume.

    Retention keeps the LATEST ``max_to_keep`` steps, so resume always has
    the newest state. Best-by-metric is tracked SEPARATELY: an improving
    save also writes a standalone ``best/`` checkpoint and a ``best.json``
    record. (Keeping the best N instead would delete the latest steps: a
    resumed run would silently retrain from the best epoch, and a
    completed run would have no final checkpoint.)"""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 best_metric: str = "val_loss", minimize: bool = True,
                 config: Optional[Dict] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.minimize = minimize
        self._best_path = os.path.join(self.directory, "best.json")
        self._steps = set(self._steps_on_disk())
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="audax-ckpt")
        self._pending: List[Future] = []
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as fh:
                json.dump(config, fh, indent=2, default=str)

    def _steps_on_disk(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def _best_record(self) -> Optional[Dict]:
        if os.path.exists(self._best_path):
            with open(self._best_path) as fh:
                return json.load(fh)
        return None

    def _write_step(self, step: int, record, tensors) -> None:
        _write(os.path.join(self.directory, str(step)), record, tensors)
        for old in self._steps_on_disk()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def save(self, step: int, state: Any,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Snapshot ``state`` now and write it on the worker thread."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        record, tensors = _snapshot(state)
        self._pending.append(self._pool.submit(self._write_step, int(step),
                                               record, tensors))
        self._steps.add(int(step))
        val = metrics.get(self.best_metric)
        if val is None:
            return
        rec = self._best_record()
        improved = rec is None or (val < rec["value"] if self.minimize
                                   else val > rec["value"])
        if improved:
            self._pending.append(self._pool.submit(
                _write, os.path.join(self.directory, "best"), record,
                tensors))
            with open(self._best_path, "w") as fh:
                json.dump({"step": int(step), "value": val,
                           "metric": self.best_metric}, fh)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """The checkpoint of ``step`` (the latest by default) in
        ``state_like``'s structure. ``state_like`` may be a top-level subset
        of the saved dict (e.g. params without the optimizer state)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        raw = load_pytree(os.path.join(self.directory, str(step)))
        if isinstance(state_like, dict) and isinstance(raw, dict):
            raw = {k: raw[k] for k in state_like if k in raw}
        return _match(state_like, raw)

    def restore_best(self, state_like: Any) -> Any:
        """Restore the best-by-metric checkpoint (independent of step
        retention)."""
        if self._best_record() is None:
            raise FileNotFoundError(f"no best checkpoint in {self.directory}")
        self.wait()
        return load_pytree(os.path.join(self.directory, "best"), state_like)

    def latest_step(self) -> Optional[int]:
        return max(self._steps) if self._steps else None

    def best_step(self) -> Optional[int]:
        rec = self._best_record()
        return None if rec is None else int(rec["step"])

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
