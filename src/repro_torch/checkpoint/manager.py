"""Checkpoint manager: the counterpart of ``repro/checkpoint/manager.py``, for
torch state on one card or sharded over a mesh (DTensors).

The same behaviour and the same files as the JAX manager, so a checkpoint
written by either package restores in the other:

* **atomic**: state is written to ``step_XXXXXXXX.tmp`` and os.rename'd into
  place; a crash mid-write never corrupts the latest checkpoint.
* **async**: ``save()`` copies every leaf to host memory before it returns,
  and writes to disk on a background thread, overlapping I/O with the next
  training steps; ``wait()`` joins before the next save or exit, and raises
  what the write raised.
* **keep-k**: the oldest checkpoints beyond ``keep`` are deleted.
* **one file**: ``arrays.npz`` holds every leaf as a ``.npy`` entry keyed by
  its ``_flatten`` path (``params/...``, ``opt/mu/...``, ``opt/nu/...``,
  ``opt/step``); ``meta.json`` holds ``step``, ``keys`` and the caller's
  metadata (the data pipeline's cursor rides there).
* **sharded**: ``save()`` gathers each DTensor leaf whole (a collective: every
  rank calls ``save()``), and only rank 0 of the default process group
  copies it to the host and writes; the others drop what they gathered and
  do not wait for the write. ``restore()`` places each
  leaf on a ``(DeviceMesh, placements)`` where ``shardings`` or a DTensor
  template leaf gives one, as ``jax.device_put`` onto a NamedSharding does,
  so a run can resume on a mesh of another shape.

Where the two layouts differ, this copy bridges them:

* The snapshot is a copy. ``adamw_update`` overwrites params, mu and nu in
  place, and on the CPU ``t.numpy()`` aliases ``t``: an async write of a view
  would race the next step and save that step's values.
* ``OptState.step`` is a Python ``int`` here and an int32 0-dim array in the
  JAX package: an ``int`` leaf is written as ``np.int32`` of shape ``()`` and
  restored as an ``int``.
* A bf16 leaf is written as the JAX package writes an ml_dtypes bfloat16
  array: its raw 2-byte values under the ``.npy`` descr ``'<V2'``, which
  ``np.load`` reads back as ``|V2``. Such data (or int16 / uint16 data) is
  restored into a bf16 template leaf bit for bit, by a view.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import distribute

# the .npy descr of the JAX package's bf16 leaves (ml_dtypes' bfloat16.str)
BF16_DESCR = "<V2"
# bytes handed to the zip entry per write
_CHUNK = 16 * 2 ** 20


def _is_placement(x) -> bool:
    """A ``(DeviceMesh, placements)`` pair: one leaf of ``shardings``."""
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh)


def _flatten(tree, prefix=""):
    out = {}
    if _is_placement(tree):
        out[prefix[:-1]] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    """Rebuild ``template``'s structure with the leaves of ``flat``."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if hasattr(template, "_fields"):
        vals = {
            k: _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields
        }
        return type(template)(**vals)
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)
        )
    return flat[prefix[:-1]]


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of one leaf that owns its memory: a bf16 tensor as ``V2``
    raw values, a Python int as int32 0-dim; a DTensor gathered whole."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        if not np.iinfo(np.int32).min <= leaf <= np.iinfo(np.int32).max:
            raise ValueError(f"int leaf {leaf} does not fit the int32 it is saved as")
        return np.asarray(leaf, dtype=np.int32)
    return np.array(leaf)


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)``, but with a 2-byte void array (bf16) under
    the descr ``'<V2'``, as the JAX package's file has it; ``np.savez`` would
    write ``'|V2'``. Headers are written as ``np.lib.format.write_array``
    writes them."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            header = np.lib.format.header_data_from_array_1_0(a)
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                header["descr"] = BF16_DESCR
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(fid, header)
                data = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
                for i in range(0, len(data), _CHUNK):
                    fid.write(data[i:i + _CHUNK])


def _to_leaf(arr: np.ndarray, like, place) -> Any:
    """One array of the file as the template leaf ``like``: a tensor of its
    dtype (raw 2-byte values into bf16 by a view) on ``place``, a device or a
    ``(DeviceMesh, placements)`` (then a DTensor of this rank's shard), or an
    int."""
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {arr.shape} != template {tuple(like.shape)}")
        raw = arr.dtype.kind == "V" and arr.dtype.itemsize == 2  # the JAX file's bf16
        if raw or (like.dtype == torch.bfloat16 and arr.dtype in (np.int16, np.uint16)):
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if _is_placement(place):
            return distribute(t.to(dtype=like.dtype), place)
        return t.to(device=place, dtype=like.dtype)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    return arr


def _place_of(key: str, flat_sh: dict, default):
    """The place (a device, or a ``(DeviceMesh, placements)``) that the
    longest prefix of ``key`` in ``flat_sh`` names."""
    best = None
    for p in flat_sh:
        if (p == "" or key == p or key.startswith(p + "/")) and (
                best is None or len(p) > len(best)):
            best = p
    if best is None:
        return default
    place = flat_sh[best]
    return place if _is_placement(place) else torch.device(place)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict, *, metadata: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Copy every leaf to host memory now, write in the background
        (unless blocking=True). Sharded, every rank calls it (the gather of a
        DTensor leaf is a collective) and rank 0 alone copies to the host and
        writes: another rank drops each gathered leaf at once."""
        self.wait()  # at most one in-flight write
        flat = _flatten(state)
        if _rank() != 0:
            for v in flat.values():
                if isinstance(v, DTensor):
                    v.full_tensor()
            return
        snapshot = {k: _to_host(v) for k, v in flat.items()}
        meta = dict(metadata or {})
        meta["step"] = step
        meta["keys"] = sorted(snapshot)

        def _write():
            tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
            final = os.path.join(self.directory, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            _write_npz(os.path.join(tmp, "arrays.npz"), snapshot)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            def _run():
                try:
                    _write()
                except Exception as e:  # handed to wait(), which raises it
                    self._error = e

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(
        self,
        template: Any,
        step: Optional[int] = None,
        *,
        shardings: Any = None,
    ) -> tuple[Any, dict]:
        """Returns (state, metadata), state in ``template``'s structure: each
        leaf a new tensor of the template leaf's dtype and device, or its mesh
        and placements where it is a DTensor (an int where the template holds
        an int). ``shardings`` (optional) is a pytree matching ``template`` or
        a prefix of it whose leaves are devices or ``(DeviceMesh,
        placements)`` pairs (``sharding.named``'s output), e.g. ``{"params":
        torch.device("cuda")}``; a leaf under one of its paths goes there
        instead."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        flat_sh = _flatten(shardings) if shardings is not None else {}
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as z:
            # leaf by leaf, so host memory holds one leaf's array at a time
            for k, like in _flatten(template).items():
                if isinstance(like, DTensor):
                    place = (like.device_mesh, like.placements)
                else:
                    place = like.device if isinstance(like, torch.Tensor) else None
                flat[k] = _to_leaf(z[k], like, _place_of(k, flat_sh, place))
        return _unflatten_into(template, flat), meta

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
