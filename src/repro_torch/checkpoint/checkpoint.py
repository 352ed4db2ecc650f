"""Atomic, asynchronous checkpoints with the JAX package's on-disk layout
(``repro.checkpoint``), for trees of torch tensors.

* **layout**: ``<dir>/step_%010d/arrays.npz`` (one array a leaf, keyed
  by its slash-joined path) and ``manifest.json`` with ``step``,
  ``paths``, ``meta`` and ``complete``: a checkpoint written by either
  package restores in the other;
* **atomic**: written to ``.tmp_step_%010d``, the manifest fsynced, then
  renamed into place, so a crash mid-save never leaves a torn latest
  checkpoint; :meth:`CheckpointManager.latest_step` skips a directory
  whose manifest is missing, torn or incomplete;
* **async**: :meth:`CheckpointManager.save_async` copies every leaf to
  host memory now (the only synchronous part) and writes on a thread;
* **retention**: the last ``keep`` checkpoints stay on disk.

bf16 leaves are written as fp32, which holds every bf16 value exactly
(numpy has no bf16 type without ``ml_dtypes``).  :meth:`restore` returns
numpy arrays; callers cast each to their template leaf's type and
device, as the JAX package's train loop does.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix="") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array on the host; bf16 as fp32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path,
                 keep: int = 3) -> None:
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    # ------------------------------ save ------------------------------
    def save(self, step: int, tree: Any, meta: Optional[dict] = None
             ) -> pathlib.Path:
        """Synchronous atomic save."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        return self._write(step, host, meta or {})

    def save_async(self, step: int, tree: Any,
                   meta: Optional[dict] = None) -> None:
        """Device->host copy now; disk IO on a thread (one at a time)."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self._pending = threading.Thread(
            target=self._write, args=(step, host, meta or {}), daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, flat: dict, meta: dict) -> pathlib.Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {"step": step, "paths": sorted(flat),
                    "meta": meta, "complete": True}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ----------------------------- restore ----------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            mf = p / "manifest.json"
            if mf.exists():
                try:
                    m = json.loads(mf.read_text())
                    if m.get("complete"):
                        out.append(int(m["step"]))
                except (json.JSONDecodeError, KeyError):
                    continue  # torn manifest = incomplete checkpoint
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> tuple[int, Any]:
        """(step, the saved tree of numpy arrays); the newest complete
        checkpoint when ``step`` is None."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        with np.load(path / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        return step, _unflatten(flat)

    def meta(self, step: int) -> dict:
        path = self.dir / f"step_{step:010d}" / "manifest.json"
        return json.loads(path.read_text())["meta"]
