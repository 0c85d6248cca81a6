"""Checkpoint / resume of streaming state (host side): port of
`t41x.utils.checkpoint`.

The radio CONFIG persists as JSON (`t41x_torch.config`); this module
checkpoints the DSP carry state (filter histories, AGC, NR, NCO phase),
enabling deterministic resume of a long capture from block N.

States are trees of NamedTuples, tuples and dicts with tensor (or
array) leaves; serialization is a flat .npz keyed by tree path, written
with the keys `jax.tree_util.tree_flatten_with_path` gives the same tree
in `t41x` (a field name for a NamedTuple, an index for a tuple, a key
for a dict; `()` and None hold no leaf), so a checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch


def flatten_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf), ...] in `t41x`'s order: NamedTuple fields in
    declaration order, tuple and list items by index, dict items by
    sorted key."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        return [(prefix, tree)]
    return [pl for k, v in items for pl in flatten_with_path(v, prefix + (k,))]


def map_leaves(fn, tree):
    """The tree with each leaf replaced by `fn(path, leaf)`."""
    def go(t, prefix):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(go(v, prefix + (k,))
                             for k, v in zip(t._fields, t)))
        if isinstance(t, (tuple, list)):
            return type(t)(go(v, prefix + (i,)) for i, v in enumerate(t))
        if isinstance(t, dict):
            return {k: go(v, prefix + (k,)) for k, v in t.items()}
        return fn(prefix, t)
    return go(tree, ())


def _key(path) -> str:
    return "s:" + "/".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state, extra: dict | None = None) -> None:
    """Save a state tree (plus an optional JSON-able metadata dict)."""
    arrays = {_key(kp): _numpy(leaf)
              for kp, leaf in flatten_with_path(state)}
    if extra is not None:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, template):
    """Load into the structure of `template` (a state tree with the same
    shape/dtype layout); tensor leaves land on the template leaf's
    device.  Returns (state, meta_dict)."""
    with np.load(path) as z:
        meta = None
        if "__meta__" in z:
            meta = json.loads(bytes(z["__meta__"]).decode())
        defaulted: list[str] = []

        def load(kp, leaf):
            key = _key(kp)
            expect = _numpy(leaf)
            if key not in z:
                # forward compatibility: a state field added after the
                # checkpoint was written (e.g. KimState.idx) falls back
                # to the template's init value instead of a KeyError
                defaulted.append(key)
                return leaf.clone() if isinstance(leaf, torch.Tensor) \
                    else np.asarray(leaf)
            arr = z[key]
            if arr.shape != expect.shape:
                raise ValueError(
                    f"checkpoint mismatch at {key}: {arr.shape} vs "
                    f"{expect.shape}")
            arr = arr.astype(expect.dtype)
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(arr).to(leaf.device)
            return arr

        state = map_leaves(load, template)
        if defaulted:
            # loud, not silent: a field RENAME looks identical to a field
            # addition from here (old key ignored as extra, new key
            # defaulted) — surface the list so it can't slip through
            warnings.warn(
                f"checkpoint {path!r} missing {len(defaulted)} state "
                f"field(s), substituting template init values: "
                f"{', '.join(defaulted)}", stacklevel=2)
    return state, meta
