"""Checkpoint/resume for model state and column-batch sweeps.

The reference has no solver checkpointing (SURVEY.md section 5), only
warm-start by convention (passing the previous T_surf/T/convecting mask back
into RCE, tests/test_adiabat.f90:186-211). Here that convention becomes an
explicit, durable artifact: the AdiabatClimate solution state (and any nested
dict, list or tuple of arrays or tensors) round-trips through one ``.npz``
file, with the JAX package's fields (``clima_tpu/utils/checkpoint.py``), so a
file written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_state", "load_state", "restore_state", "save_pytree", "load_pytree"]

_STATE_FIELDS = [
    "T_surf", "T", "P", "P_surf", "P_trop", "f_i", "f_i_surf", "z", "dz",
    "gravity", "gravity_surf", "densities", "N_atmos", "N_surface", "N_ocean",
    "pdensities", "pradii", "convecting_with_below", "lapse_rate",
    "lapse_rate_intended", "make_column_P_guess",
]


def _host(v):
    """An array, tensor (on any device) or number as a host numpy array."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_state(c, filename):
    """Save an AdiabatClimate solution state (warm-start checkpoint)."""
    data = {}
    for f in _STATE_FIELDS:
        v = getattr(c, f, None)
        if v is not None:
            data[f] = _host(v)
    data["__meta_nz"] = np.asarray(c.nz)
    data["__meta_ng"] = np.asarray(c.sp.ng)
    np.savez(filename, **data)


def load_state(filename):
    """Load a checkpoint into a dict of arrays."""
    with np.load(filename) as d:
        return {k: d[k] for k in d.files}


def restore_state(c, filename):
    """Restore a checkpoint onto a model (shapes must match). Each field
    takes the type the model holds: a tensor stays a tensor on its device
    and in its dtype, a number a float, anything else a numpy array."""
    data = load_state(filename)
    if int(data["__meta_nz"]) != c.nz or int(data["__meta_ng"]) != c.sp.ng:
        raise ValueError("checkpoint shape does not match this model")
    for f in _STATE_FIELDS:
        if f in data:
            cur = getattr(c, f, None)
            v = data[f]
            if torch.is_tensor(cur):
                setattr(c, f, torch.as_tensor(v, dtype=cur.dtype, device=cur.device))
            elif np.isscalar(cur) or (cur is not None and np.ndim(cur) == 0):
                setattr(c, f, float(v))
            else:
                setattr(c, f, np.asarray(v))
    return c


def tree_flatten(tree):
    """(leaves, structure string) of a nested dict / list / tuple, in JAX's
    order: a dict's entries by sorted key, None a node without leaves,
    anything else a leaf. The string is what ``str`` of JAX's treedef gives
    for the same tree."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        parts = [(k, tree_flatten(tree[k])) for k in sorted(tree)]
        leaves = [leaf for _, (sub, _) in parts for leaf in sub]
        return leaves, "{" + ", ".join(f"{k!r}: {s}" for k, (_, s) in parts) + "}"
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(x) for x in tree]
        leaves = [leaf for sub, _ in parts for leaf in sub]
        inner = ", ".join(s for _, s in parts)
        if isinstance(tree, list):
            return leaves, f"[{inner}]"
        return leaves, f"({inner},)" if len(tree) == 1 else f"({inner})"
    return [tree], "*"


def _unflatten(example, leaves):
    """``example``'s structure with its leaves taken in order from the
    iterator ``leaves``; a tensor leaf of the example gives a tensor on its
    device, any other leaf the array itself."""
    if example is None:
        return None
    if isinstance(example, dict):
        out = {k: _unflatten(example[k], leaves) for k in sorted(example)}
        return {k: out[k] for k in example}
    if isinstance(example, (list, tuple)):
        return type(example)(_unflatten(x, leaves) for x in example)
    leaf = next(leaves)
    return torch.as_tensor(leaf, device=example.device) if torch.is_tensor(example) else leaf


def save_pytree(tree, filename):
    """Save a nested dict / list / tuple of arrays or tensors (e.g. batched
    sweep state)."""
    leaves, structure = tree_flatten(tree)
    np.savez(
        filename,
        __treedef=np.frombuffer(f"PyTreeDef({structure})".encode(), dtype=np.uint8),
        **{f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)},
    )


def load_pytree(filename, treedef_example):
    """Load a tree saved by save_pytree, using an example for structure."""
    with np.load(filename) as d:
        n = len([k for k in d.files if k.startswith("leaf_")])
        leaves = [d[f"leaf_{i}"] for i in range(n)]
    return _unflatten(treedef_example, iter(leaves))
