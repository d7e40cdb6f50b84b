"""Checkpointing: flat npz of a nested state plus a json sidecar.

Port of ``repro.checkpoint.ckpt``.  A state is a nest of dicts, lists and
tuples whose leaves are tensors or NumPy arrays.  :func:`save` writes
every leaf to host NumPy (``<path>.npz``, ``arr_0 .. arr_{n-1}`` in
flatten order: dict keys sorted, as the reference's pytrees flatten) and
records each leaf's key path (the reference's ``keystr`` form, e.g.
``['w']``), shape and dtype in ``<path>.json``, beside an optional
free-form ``extra`` dict for state that is not an array (rng state,
meter counters, loop indices; json keeps Python ints exact and floats by
``repr``, so a resume from it is bit for bit).  :func:`restore` checks
key paths, shapes and dtypes against a template and puts each tensor on
the device of the template's leaf.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(state, prefix: str = "") -> list[tuple[str, object]]:
    """(key path, leaf) pairs in the reference's pytree order."""
    if isinstance(state, dict):
        out = []
        for k in sorted(state):
            out += _flatten(state[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(state, (list, tuple)):
        out = []
        for i, v in enumerate(state):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, state)]


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state, extra: dict | None = None) -> None:
    """Write ``state``'s leaves to ``<path>.npz`` and their key paths,
    shapes, dtypes and ``extra`` to ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    meta = {"keys": [], "shapes": [], "dtypes": [], "specs": {}}
    for key, leaf in _flatten(state):
        arr = _host(leaf)
        meta["keys"].append(key)
        meta["shapes"].append(list(arr.shape))
        meta["dtypes"].append(str(arr.dtype))
        arrays[f"arr_{len(arrays)}"] = arr
    if extra is not None:
        meta["extra"] = extra
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def restore(path: str, like):
    """Restore into the structure of ``like`` (a template nest).

    Every leaf is checked against the template — key path (when the
    sidecar is present), shape and dtype must match exactly; a mismatch
    raises ``ValueError`` naming it.  A tensor leaf comes back on the
    template leaf's device; other leaves come back as NumPy arrays.
    """
    with np.load(path + ".npz") as data:
        n = len(data.files)
        missing = [f"arr_{i}" for i in range(n) if f"arr_{i}" not in data]
        if missing:
            raise ValueError(
                f"checkpoint {path}.npz is malformed: missing {missing[0]} "
                f"(expected arr_0..arr_{n - 1})"
            )
        arrays = [data[f"arr_{i}"] for i in range(n)]
    flat = _flatten(like)
    if len(arrays) != len(flat):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template has {len(flat)}"
        )
    flat_keys = [k for k, _ in flat]
    meta = load_meta(path) if os.path.exists(path + ".json") else None
    if meta is not None and meta.get("keys") and meta["keys"] != flat_keys:
        bad = next(
            (s, t) for s, t in zip(meta["keys"], flat_keys) if s != t
        ) if len(meta["keys"]) == len(flat_keys) else (meta["keys"], flat_keys)
        raise ValueError(
            f"checkpoint tree structure mismatch: saved key {bad[0]!r} vs "
            f"template key {bad[1]!r}"
        )
    restored = []
    for (key, leaf), a in zip(flat, arrays):
        want_shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(a.shape) != tuple(want_shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(a.shape)}, "
                f"template wants {tuple(want_shape)}"
            )
        if isinstance(leaf, torch.Tensor):
            want = torch.empty((), dtype=leaf.dtype).numpy().dtype
            if a.dtype != want:
                raise ValueError(
                    f"checkpoint leaf {key!r} has dtype {a.dtype}, template "
                    f"wants {want}"
                )
            restored.append(torch.from_numpy(a).to(leaf.device))
        else:
            if hasattr(leaf, "dtype") and a.dtype != np.dtype(leaf.dtype):
                raise ValueError(
                    f"checkpoint leaf {key!r} has dtype {a.dtype}, template "
                    f"wants {np.dtype(leaf.dtype)}"
                )
            restored.append(a)
    return _unflatten(like, restored)


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)
