"""Fault-tolerant checkpointing on npz shards and a JSON manifest, in the
reference's on-disk format, so either package restores what the other
wrote, bit for bit:

    <dir>/step_XXXXXXXX/shard_<i>.npz   leaves, keys "/"-joined, dealt
                                        round-robin over the sorted keys
    <dir>/step_XXXXXXXX/manifest.json   step, keys, shapes, dtypes,
                                        n_shards, metadata
    <dir>/LATEST                        name of the newest step dir

* **atomic**: written to ``<dir>/tmp.<step>``, fsynced, renamed to
  ``step_<step>``; ``LATEST`` is replaced last, so a crash mid-save never
  corrupts the newest checkpoint, and a ``LATEST`` that names a missing
  dir falls back to the newest one on disk.
* **async save**: ``save`` copies the tensors to host memory and returns;
  the files are written on a background thread, joined by ``wait()``
  (and by the next ``save``).
* **garbage collection**: only the newest ``keep_last`` step dirs stay.
* **restore** puts the tensors on ``device``; a ``template`` (a nested
  dict shaped like the state) validates keys and shapes and fixes the
  tree's structure.
* **bfloat16 leaves** are written as the reference writes them: the npz
  entry holds the 16-bit patterns under the array descr ``<V2`` (what
  numpy records for an ``ml_dtypes`` bf16 array) and the manifest says
  ``"bfloat16"``; ``np.load`` returns such an entry as ``|V2`` voids, which
  restore turns back into ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.bridge import (array_to_tensor, is_bf16_array,
                                resolve_device, tensor_to_array)

_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def _host_copy(leaf) -> np.ndarray:
    """A host array that later in-place updates of ``leaf`` cannot reach
    (a bf16 tensor as 2-byte voids holding its bits)."""
    if isinstance(leaf, torch.Tensor):
        return tensor_to_array(leaf)
    return np.array(leaf, copy=True)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if is_bf16_array(a) else str(a.dtype)


def _savez(path: Path, arrays: dict) -> None:
    """``np.savez`` (stored zip, one ``<key>.npy`` per array), with each
    bf16 array's header saying ``<V2`` as the reference's does."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if is_bf16_array(a):
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False,
                            "shape": a.shape})
                    f.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(f, a, allow_pickle=False)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3,
                 n_shards: int = 4, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.n_shards = n_shards
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state: dict, metadata: Optional[dict] = None):
        """state: nested dict of tensors or arrays. Blocks only for the
        copy to host memory; the files are written on a background thread
        when ``async_save``."""
        flat = {k: _host_copy(v) for k, v in _flatten(state).items()}
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, flat, metadata or {}))
            self._thread.start()
        else:
            self._write(step, flat, metadata or {})

    def _write_guarded(self, step: int, flat: dict, metadata: dict):
        try:
            self._write(step, flat, metadata)
        except Exception as e:              # re-raised by wait()
            self._error = e

    def _write(self, step: int, flat: dict, metadata: dict):
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        keys = sorted(flat)
        shards: list[dict] = [{} for _ in range(self.n_shards)]
        for i, k in enumerate(keys):
            shards[i % self.n_shards][k] = flat[k]
        for i, shard in enumerate(shards):
            if shard:
                _savez(tmp / f"shard_{i}.npz", shard)
        manifest = {
            "step": step,
            "keys": keys,
            "shapes": {k: list(flat[k].shape) for k in keys},
            "dtypes": {k: _dtype_name(flat[k]) for k in keys},
            "n_shards": self.n_shards,
            "metadata": metadata,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # directory-entry durability before the atomic publish
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (self.dir / "LATEST.tmp").write_text(final.name)
        os.replace(self.dir / "LATEST.tmp", self.dir / "LATEST")
        self._gc()

    def wait(self):
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for old in sorted(self.dir.glob("step_*"))[:-self.keep_last]:
            shutil.rmtree(old)

    # ---------------------------------------------------------- restore ----
    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name).exists():  # crash between rename & pointer
            ckpts = sorted(self.dir.glob("step_*"))
            if not ckpts:
                return None
            name = ckpts[-1].name
        return int(name.split("_")[1])

    def restore(self, step: Optional[int] = None, *, device=None,
                template=None):
        """Returns (state, metadata), the state's tensors on ``device``
        (default the card). ``template``: a nested dict shaped like the
        state; every leaf's key must be in the checkpoint with the
        template leaf's shape, and the result has the template's keys."""
        dev = resolve_device(device, "Checkpointer.restore")
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for i in range(manifest["n_shards"]):
            f = d / f"shard_{i}.npz"
            if f.exists():
                with np.load(f) as z:
                    flat.update({k: z[k] for k in z.files})
        missing = set(manifest["keys"]) - set(flat)
        if missing:
            raise IOError(f"checkpoint {d} missing keys: "
                          f"{sorted(missing)[:5]}")
        if template is not None:
            want = {k: tuple(v.shape) for k, v in _flatten(template).items()}
            absent = sorted(set(want) - set(flat))
            if absent:
                raise KeyError(f"template keys not in checkpoint {d}: "
                               f"{absent[:5]}")
            for k, shape in want.items():
                if tuple(flat[k].shape) != shape:
                    raise ValueError(f"{k}: checkpoint shape "
                                     f"{flat[k].shape}, template {shape}")
            flat = {k: flat[k] for k in want}
        dtypes = manifest["dtypes"]
        for k, v in flat.items():
            if is_bf16_array(v) != (dtypes[k] == "bfloat16"):
                raise ValueError(f"{k}: entry dtype {v.dtype}, manifest "
                                 f"{dtypes[k]}")
        tree = _unflatten({k: array_to_tensor(v).to(dev)
                           for k, v in flat.items()})
        return tree, manifest["metadata"]
