"""Checkpoint manager — epoch-keyed, resume-by-dir.

Replaces tf.train.Saver/Supervisor (reference: hem/util/misc.py:129-153,
hem/util/state.py:14-34, hem/util/training.py:126-130,162):

* one baseline checkpoint at step 0 before any training;
* one checkpoint per epoch, named ``checkpoint-{epoch}.npz``;
* ``max_to_keep`` most-recent retained (0 = keep all);
* pointing ``--dir`` at a populated workspace resumes from the latest.

A checkpoint is one ``np.savez`` archive of the pytree's leaves (the
wrapper ``{"train_state": {params, mstate, opt, step, rng}, "epoch"}`` that
loop.train saves/restores), each stored under its keypath
(``jax.tree_util.keystr``). Leaves whose dtype numpy cannot store natively
(bfloat16) are stored as same-width unsigned integers; the keypaths and
dtype names ride along so restore can check them. There is no meta-graph:
post-hoc tooling rebuilds the model from options.json and restores into its
fresh state (SURVEY.md §5.4 rebuild note).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import numpy as np

_CKPT_RE = re.compile(r"^checkpoint-(\d+)\.npz$")
# metadata entries: keystr paths start with '[' or '.', so names can't clash
_PATHS, _DTYPES = "__paths__", "__dtypes__"


def _flatten(tree) -> tuple[list[str], list, Any]:
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    return paths, [x for _, x in flat], treedef


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 0):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    # -- listing ----------------------------------------------------------
    def checkpoints(self) -> list[tuple[int, str]]:
        """Sorted [(epoch, path)] (reference: util.py:379-387 checkpoints())."""
        found = []
        for fname in os.listdir(self.directory):
            m = _CKPT_RE.match(fname)
            if m:
                found.append((int(m.group(1)), os.path.join(self.directory, fname)))
        return sorted(found)

    def latest(self) -> Optional[str]:
        ckpts = self.checkpoints()
        if not ckpts and any(f.startswith("checkpoint-") and
                             f.endswith(".msgpack")
                             for f in os.listdir(self.directory)):
            # resuming would silently restart from scratch on top of them
            raise RuntimeError(
                f"{self.directory} holds only checkpoint-*.msgpack files, a "
                f"format hemx no longer reads (see doc/migration.md); use a "
                f"fresh --dir")
        return ckpts[-1][1] if ckpts else None

    # -- save/restore -----------------------------------------------------
    def save(self, train_state: Any, epoch: int) -> str:
        path = os.path.join(self.directory, f"checkpoint-{epoch}.npz")
        paths, leaves, _ = _flatten(train_state)
        leaves = [np.asarray(x) for x in leaves]
        arrays = {p: (a if a.dtype.isbuiltin
                      else a.view(f"u{a.dtype.itemsize}"))
                  for p, a in zip(paths, leaves)}
        arrays[_PATHS] = np.array(paths)
        arrays[_DTYPES] = np.array([str(a.dtype) for a in leaves])
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        self._gc()
        return path

    def restore(self, template: Any, path: Optional[str] = None) -> Any:
        """Restore into the structure of ``template`` (a freshly-initialized
        train state). Leaves come back as host numpy arrays. Raises
        ValueError unless the checkpoint holds exactly the template's
        keypaths, shapes and dtypes."""
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        paths, tmpl, treedef = _flatten(template)
        with np.load(path, allow_pickle=False) as z:
            saved = z[_PATHS].tolist()
            if sorted(saved) != sorted(paths):
                missing = sorted(set(paths) - set(saved))
                extra = sorted(set(saved) - set(paths))
                raise ValueError(f"{path} does not match the template: "
                                 f"missing {missing[:5]}, unexpected "
                                 f"{extra[:5]}")
            dtypes = dict(zip(saved, z[_DTYPES].tolist()))
            leaves = []
            for p, t in zip(paths, tmpl):
                a = z[p]
                if dtypes[p] != str(t.dtype) or a.shape != np.shape(t):
                    raise ValueError(
                        f"{path}: leaf {p} is {dtypes[p]}{list(a.shape)}, "
                        f"the template wants {t.dtype}{list(np.shape(t))}")
                leaves.append(a.view(t.dtype))
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def _gc(self) -> None:
        if self.max_to_keep <= 0:
            return
        ckpts = self.checkpoints()
        for _, path in ckpts[:-self.max_to_keep]:
            try:
                os.remove(path)
            except OSError:
                pass
