"""Async, atomic checkpointing of torch tensor trees: a copy of
``repro/checkpoint/manager.py`` (its layout, guarantees and errors) over
the port's own tree flatten (``repro_torch.tree``).

Layout:  <dir>/step_<N>/
           manifest.json     # step, leaf files, shapes, dtypes, extras
           leaf_<i>.npy      # one file per tree leaf

* atomic publish -- each leaf via its own temp file + fsync + rename,
  the step directory written as step_<N>.tmp and renamed; a crash
  mid-save never corrupts the latest checkpoint;
* async -- save() copies the leaves to the host and returns; a
  background thread writes them; wait() joins;
* resumable -- restore(like) rebuilds the tree of ``like``'s structure
  on each leaf's device and dtype; with ``shardings`` each leaf comes
  back as this rank's block of it;
* retention -- keep_last prunes old steps after a successful publish.

numpy has no bfloat16, so a bf16 leaf is stored as its raw 16-bit
words (int16) and the manifest records ``bfloat16``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree


class CheckpointError(RuntimeError):
    """A checkpoint on disk is missing, truncated, or corrupt."""


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        arr = t.numpy().copy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # -------------------------------------------------- save
    def save(self, step: int, tree_: Any, extras: Optional[dict] = None,
             blocking: bool = False) -> None:
        # copy to the host *before* returning: the caller may update the
        # tensors in place right after
        host = [_to_host(leaf) for leaf in tree.leaves(tree_)]

        def work():
            self._write(step, host, extras or {})

        self.wait()
        if blocking:
            work()
        else:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step, host_leaves, extras) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extras": extras, "leaves": []}
        for i, (arr, dtype) in enumerate(host_leaves):
            name = f"leaf_{i:05d}.npy"
            # each leaf lands via its own temp file + atomic rename +
            # fsync, so a crash mid-save can never leave a half-written
            # .npy under the final leaf name
            leaf_final = os.path.join(tmp, name)
            leaf_tmp = leaf_final + ".part"
            with open(leaf_tmp, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            os.rename(leaf_tmp, leaf_final)
            manifest["leaves"].append(
                {"file": name, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d,
                                                "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _checkpoint_path(self, step: Optional[int]) -> tuple[str, int]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        if not os.path.isdir(path):
            raise CheckpointError(
                f"checkpoint step {step} missing under {self.dir} "
                f"(have steps {self.all_steps()})")
        return path, step

    def _load_manifest(self, path: str, step: int) -> dict:
        mpath = os.path.join(path, "manifest.json")
        try:
            with open(mpath) as f:
                return json.load(f)
        except FileNotFoundError as e:
            raise CheckpointError(
                f"checkpoint step {step}: manifest.json missing "
                f"({mpath})") from e
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointError(
                f"checkpoint step {step}: manifest.json corrupt "
                f"({e})") from e

    def _load_leaf(self, path: str, meta: dict, step: int) -> torch.Tensor:
        fpath = os.path.join(path, meta["file"])
        try:
            arr = np.load(fpath)
        except FileNotFoundError as e:
            raise CheckpointError(
                f"checkpoint step {step}: leaf {meta['file']} missing "
                f"— checkpoint incomplete") from e
        except Exception as e:
            raise CheckpointError(
                f"checkpoint step {step}: leaf {meta['file']} "
                f"truncated or corrupt ({type(e).__name__}: {e})") from e
        stored = "int16" if meta["dtype"] == "bfloat16" else meta["dtype"]
        if list(arr.shape) != list(meta["shape"]) or \
                str(arr.dtype) != stored:
            raise CheckpointError(
                f"checkpoint step {step}: leaf {meta['file']} shape/"
                f"dtype {arr.shape}/{arr.dtype} does not match "
                f"manifest {tuple(meta['shape'])}/{meta['dtype']}")
        return _from_host(arr, meta["dtype"])

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> tuple[Any, dict]:
        """Rebuild the tree of ``like``'s structure; each tensor leaf
        lands on its ``like`` leaf's device.  ``shardings`` (a tree of
        ``sharding.NamedSharding`` of the same structure, or None): each
        leaf comes back as this rank's block of it."""
        path, step = self._checkpoint_path(step)
        manifest = self._load_manifest(path, step)
        leaves_like = tree.leaves(like)
        if len(leaves_like) != len(manifest["leaves"]):
            raise CheckpointError(
                f"checkpoint step {step}: {len(manifest['leaves'])} "
                f"leaves on disk vs {len(leaves_like)} in the supplied "
                f"structure — checkpoint/model structure mismatch")
        shard_leaves = ([None] * len(leaves_like) if shardings is None
                        else tree.leaves(shardings))
        if len(shard_leaves) != len(leaves_like):
            raise ValueError(f"{len(shard_leaves)} shardings for "
                             f"{len(leaves_like)} leaves")
        out = []
        for meta, ref, shard in zip(manifest["leaves"], leaves_like,
                                    shard_leaves):
            t = self._load_leaf(path, meta, step)
            if shard is not None:
                t = shard.local(t).contiguous()
            if isinstance(ref, torch.Tensor):
                t = t.to(ref.device)
            out.append(t)
        return tree.unflatten(like, out), manifest["extras"]

    def restore_flat(self, step: Optional[int] = None
                     ) -> tuple[list, dict]:
        """A checkpoint as a flat list of host tensors (manifest order)
        plus its extras, without a like-structured tree."""
        path, step = self._checkpoint_path(step)
        manifest = self._load_manifest(path, step)
        leaves = [self._load_leaf(path, meta, step)
                  for meta in manifest["leaves"]]
        return leaves, manifest["extras"]
