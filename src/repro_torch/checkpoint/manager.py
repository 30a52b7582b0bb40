"""Atomic, versioned checkpoints of nested arrays (port of
``repro.checkpoint.manager``, in a format of the port's own).

Layout:  <dir>/step_<N>/
            meta.json           format tag, tree structure, paths, shapes,
                                dtypes, ``extra``
            arrays.npz          the leaves as host numpy, keyed by path
         <dir>/step_<N>.done    commit marker (atomic rename)

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors or numbers; a leaf's path joins its keys and indices with
"/" (dict keys sorted), e.g. ``factors/0``.  numpy has no bfloat16: a
bfloat16 tensor is stored as its int16 bit pattern, with ``bfloat16`` as
its dtype in ``meta.json``, and restored bit for bit.

Guarantees:
  * atomicity -- a checkpoint is written to a temporary directory, renamed
    into place, and becomes visible only when its ``.done`` marker is
    renamed in after it; torn writes are never restored and are pruned
    when a manager opens the directory.
  * keep-k garbage collection of committed checkpoints.
  * restore onto any device: leaves load on the host and go where the
    template's leaves live, numpy or a torch device (or to ``device``).
  * async save: leaves are copied to the host on the caller's thread and
    the files are written on a worker thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..obs import clock as obs_clock

FORMAT = "repro_torch.checkpoint"
VERSION = 1


def _flatten(tree, prefix: str = ""):
    """``(paths, leaves, structure)``: depth-first leaves with their paths,
    and a JSON-able description of the nesting."""
    if isinstance(tree, dict):
        paths, leaves, spec = [], [], {}
        for k in sorted(tree, key=str):
            p, lv, s = _flatten(tree[k], f"{prefix}{k}/")
            paths += p
            leaves += lv
            spec[str(k)] = s
        return paths, leaves, {"dict": spec}
    if isinstance(tree, (list, tuple)):
        paths, leaves, spec = [], [], []
        for i, v in enumerate(tree):
            p, lv, s = _flatten(v, f"{prefix}{i}/")
            paths += p
            leaves += lv
            spec.append(s)
        return paths, leaves, {"list" if isinstance(tree, list) else "tuple": spec}
    return [prefix[:-1]], [tree], "leaf"


def _unflatten(spec, leaves):
    """Rebuild a tree from its structure and an iterator of leaves."""
    if spec == "leaf":
        return next(leaves)
    if "dict" in spec:
        return {k: _unflatten(s, leaves) for k, s in spec["dict"].items()}
    kind = "list" if "list" in spec else "tuple"
    items = [_unflatten(s, leaves) for s in spec[kind]]
    return items if kind == "list" else tuple(items)


def _like(template, by_path: dict, prefix: str = ""):
    """A tree of ``template``'s structure, its dicts in the template's own
    key order, whose leaves are ``by_path``'s (keyed as ``_flatten`` keys
    them).  Code that walks a tree in order (an optimizer's global norm)
    then sums a restored tree as it summed the saved one."""
    if isinstance(template, dict):
        return {k: _like(v, by_path, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [_like(v, by_path, f"{prefix}{i}/") for i, v in enumerate(template)]
        return items if isinstance(template, list) else tuple(items)
    return by_path[prefix[:-1]]


BF16 = "bfloat16"


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array and the name of its dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy(), BF16
        x = x.cpu().numpy()
    else:
        x = np.asarray(x)
    return x, str(x.dtype)


def _from_host(a: np.ndarray, dtype: str, template):
    """A stored leaf in the form of its template leaf: a torch tensor of the
    template's dtype (on the template's device), else a numpy array."""
    if isinstance(template, torch.Tensor):
        x = torch.from_numpy(a)
        if dtype == BF16:
            x = x.view(torch.bfloat16)
        return x.to(template.dtype)
    if dtype == BF16:
        a = torch.from_numpy(a).view(torch.bfloat16).float().numpy()
    return a.astype(np.asarray(template).dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = str(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(self.dir, exist_ok=True)
        self._prune_torn()

    # -- discovery ----------------------------------------------------------

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.done", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def _prune_torn(self):
        """Drop step directories without a commit marker and leftovers of
        interrupted writes."""
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith(".tmp_step_"):
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.remove(path)
            elif re.fullmatch(r"step_(\d+)", name) and not os.path.exists(
                    f"{path}.done"):
                shutil.rmtree(path, ignore_errors=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             block: bool = False):
        """Snapshot ``tree`` at ``step``; ``extra`` is JSON metadata."""
        self.wait()  # one in-flight save at a time
        paths, leaves, structure = _flatten(tree)
        # device -> host, on this thread
        host, dtypes = zip(*(_to_host(x) for x in leaves)) if leaves else ((), ())
        meta = {
            "format": FORMAT,
            "version": VERSION,
            "step": int(step),
            "structure": structure,
            "paths": paths,
            "shapes": [list(a.shape) for a in host],
            "dtypes": list(dtypes),
            "extra": extra or {},
            "time": obs_clock.wall(),   # epoch timestamp, not a duration
        }
        text = json.dumps(meta)

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                f.write(text)
            np.savez(os.path.join(tmp, "arrays.npz"), **dict(zip(paths, host)))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            # commit marker: atomic rename
            marker_tmp = os.path.join(self.dir, f".tmp_step_{step}.done")
            with open(marker_tmp, "w") as f:
                f.write("ok")
            os.rename(marker_tmp, os.path.join(self.dir, f"step_{step}.done"))
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self._steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"step_{s}.done"))
            except OSError:
                pass

    # -- restore --------------------------------------------------------------

    def _load_host(self, step: int | None):
        """Committed checkpoint ``step`` (default latest): meta and host
        arrays in path order.  Raises for a directory this format did not
        write."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = os.path.join(self.dir, f"step_{step}")
        meta_path = os.path.join(base, "meta.json")
        if not os.path.exists(meta_path):
            raise ValueError(f"{base} holds no {FORMAT} checkpoint")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT or meta.get("version") != VERSION:
            raise ValueError(
                f"{base}: format {meta.get('format')!r} version "
                f"{meta.get('version')!r}, expected {FORMAT!r} {VERSION}")
        with np.load(os.path.join(base, "arrays.npz"),
                     allow_pickle=False) as data:
            host = [data[p] for p in meta["paths"]]
        return meta, host

    def restore_items(self, step: int | None = None) -> tuple[dict, dict]:
        """Template-free restore: ``(dict of path -> host array, extra)``,
        for consumers whose array shapes are part of the checkpointed
        state (a streaming session's growing nonzero set).  A bfloat16
        leaf comes back as float32 (exact)."""
        meta, host = self._load_host(step)
        items = {p: (_from_host(a, dt, np.float32(0)) if dt == BF16 else a)
                 for p, a, dt in zip(meta["paths"], host, meta["dtypes"])}
        return items, meta.get("extra", {})

    def restore(self, step: int | None = None, *, template: Any = None,
                device=None) -> tuple[Any, dict]:
        """Load checkpoint ``step`` (default latest) into ``template``'s
        structure (its dicts in its key order), shapes and dtypes.  A leaf goes where its template leaf
        lives: a torch tensor onto ``device``, or without it onto that
        tensor's device (so a template of ``meta`` tensors, such as a
        model's ``abstract_params()``, takes ``device``), anything else to
        numpy.  Returns ``(tree, extra)``."""
        if template is None:
            raise ValueError("restore requires a template tree")
        meta, host = self._load_host(step)
        t_paths, t_leaves, _ = _flatten(template)
        if t_paths != meta["paths"]:
            differing = set(meta["paths"]) ^ set(t_paths)
            raise ValueError(
                f"checkpoint/template structure mismatch; differing: "
                f"{sorted(differing)[:5]}...")
        out = []
        for a, dt, t in zip(host, meta["dtypes"], t_leaves):
            if tuple(a.shape) != tuple(np.shape(t)):
                raise ValueError(
                    f"shape mismatch {a.shape} vs {tuple(np.shape(t))} on "
                    f"restore")
            x = _from_host(a, dt, t)
            if isinstance(t, torch.Tensor):
                x = x.to(t.device if device is None else device)
            out.append(x)
        return _like(template, dict(zip(t_paths, out))), meta.get("extra", {})
