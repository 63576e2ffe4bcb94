"""Checkpointing: atomic, optionally compressed, resumable — the JAX
package's ``train/checkpoint.py``.

Layout: ``<dir>/step_<N>/`` holds ``state.pt`` (or ``state.pt.zst``) and
``manifest.json``, and a ``latest`` pointer file names the newest step. A
save writes into a ``.tmp_*`` directory and publishes it with one
``os.replace``; ``latest`` is rewritten only after that, so a partial save
never becomes ``latest``. ``restore`` checks the manifest's structure hash
(of the state tree's paths) before loading anything.

The payload is ``torch.save`` of the flat path -> CPU tensor dict (paths as
the JAX package's ``keystr`` writes them), loaded back with
``weights_only=True``. The JAX package packs with ``msgpack`` and always
compresses with ``zstandard``; here ``zstandard`` is optional: a save
compresses when it imports, and the manifest's ``compression`` says which
(``"zstd"`` or ``null``), so a checkpoint written without it restores
anywhere and one written with it needs it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.schema import tree_paths, tree_unflatten

try:                       # optional: the GPU machine does not have it
    import zstandard
except ImportError:
    zstandard = None

_PAYLOAD = {None: "state.pt", "zstd": "state.pt.zst"}


def _structure_hash(tree) -> str:
    keys = "|".join(k for k, _ in tree_paths(tree))
    return hashlib.sha256(keys.encode()).hexdigest()[:16]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    compression_level: int = 3

    def __post_init__(self):
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None) -> Path:
        """Write ``state`` (a nested dict of tensors, on any device) as step
        ``step``, then point ``latest`` at it and drop all but the newest
        ``keep`` steps."""
        target = self.dir / f"step_{step:08d}"
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            buf = io.BytesIO()
            torch.save({k: v.detach().cpu() for k, v in tree_paths(state)},
                       buf)
            blob = buf.getvalue()
            compression = "zstd" if zstandard is not None else None
            if compression:
                blob_out = zstandard.ZstdCompressor(
                    level=self.compression_level).compress(blob)
            else:
                blob_out = blob
            (tmp / _PAYLOAD[compression]).write_bytes(blob_out)
            manifest = {
                "step": step,
                "time": time.time(),
                "structure": _structure_hash(state),
                "bytes_raw": len(blob),
                "compression": compression,
                **(meta or {}),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if target.exists():
                shutil.rmtree(target)
            os.replace(tmp, target)                      # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        # 'latest' is written only after the directory is fully in place
        latest_tmp = self.dir / ".latest_tmp"
        latest_tmp.write_text(target.name)
        os.replace(latest_tmp, self.dir / "latest")
        self._gc()
        return target

    def _gc(self):
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        latest = self.dir / "latest"
        if not latest.exists():
            return None
        name = latest.read_text().strip()
        if not (self.dir / name).exists():
            return None
        return int(name.split("_")[1])

    def restore(self, like: Dict[str, Any],
                step: Optional[int] = None) -> Tuple[int, Any, Dict]:
        """Load step ``step`` (default: ``latest``) as a tree of ``like``'s
        structure, each tensor on the device of ``like``'s. Raises
        ``FileNotFoundError`` without a checkpoint and ``ValueError`` when
        the structure, or a leaf's shape or dtype, differs from ``like``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        target = self.dir / f"step_{step:08d}"
        manifest = json.loads((target / "manifest.json").read_text())
        if manifest["structure"] != _structure_hash(like):
            raise ValueError("checkpoint structure mismatch: "
                             f"{manifest['structure']} vs current tree")
        compression = manifest.get("compression")
        blob = (target / _PAYLOAD[compression]).read_bytes()
        if compression:
            if zstandard is None:
                raise ImportError("this checkpoint is zstd-compressed; "
                                  "restoring it needs the 'zstandard' "
                                  "package")
            blob = zstandard.ZstdDecompressor().decompress(blob)
        flat = torch.load(io.BytesIO(blob), weights_only=True)
        leaves = []
        for key, leaf in tree_paths(like):
            got = flat[key]
            if got.shape != leaf.shape or got.dtype != leaf.dtype:
                raise ValueError(f"checkpoint leaf {key} is {got.dtype} "
                                 f"{tuple(got.shape)}, the current tree's "
                                 f"{leaf.dtype} {tuple(leaf.shape)}")
            leaves.append(got.to(leaf.device))
        return step, tree_unflatten(like, leaves), manifest
