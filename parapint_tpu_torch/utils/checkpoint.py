"""Checkpoint/resume for interior-point solves (counterpart of
``parapint_tpu.utils.checkpoint``).

The whole solver state is the :class:`IPState` (tensors, or dicts of
tensors) plus two scalars (barrier, inertia coefficient), so a checkpoint is
exact: the leaves go into an ``.npz`` in a fixed order (the state's fields,
dict keys in insertion order), with that structure recorded beside them.

Use ``ip_solve(..., checkpoint_path=..., checkpoint_interval=k)`` for
periodic checkpoints, or call save/load directly.
"""

import json
import os
from typing import List, Tuple

import numpy as np
import torch

from parapint_tpu_torch.interfaces.base import STATE_FIELDS, IPState


def _flatten(state: IPState) -> Tuple[List[torch.Tensor], str]:
    """(leaves, structure string) of a state."""
    leaves, parts = [], []
    for f in STATE_FIELDS:
        v = getattr(state, f)
        if isinstance(v, dict):
            parts.append(f"{f}:{{{','.join(v)}}}")
            leaves.extend(v.values())
        else:
            parts.append(f)
            leaves.append(v)
    return leaves, "IPState(" + ";".join(parts) + ")"


def save_checkpoint(path: str, state: IPState, barrier: float, inertia_coef: float, iteration: int) -> None:
    """Atomically write the solver state to ``path`` (.npz)."""
    leaves, structure = _flatten(state)
    arrays = {f"leaf_{i}": l.detach().cpu().numpy() for i, l in enumerate(leaves)}
    meta = dict(
        barrier=float(barrier),
        inertia_coef=float(inertia_coef),
        iteration=int(iteration),
        treedef=structure,
        shapes=[list(a.shape) for a in arrays.values()],
        n_leaves=len(leaves),
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like: IPState) -> Tuple[IPState, float, float, int]:
    """Load a checkpoint; ``like`` (e.g. ``interface.init_state()``) gives the
    structure, the dtypes and the device.  Returns (state, barrier,
    inertia_coef, iteration).  A checkpoint written for another structure or
    problem size raises ValueError."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    like_leaves, structure = _flatten(like)
    if meta["treedef"] != structure:
        raise ValueError(
            f"checkpoint {path!r} was written for a different state structure:\n"
            f"  stored:   {meta['treedef']}\n  expected: {structure}"
        )
    bad = [
        (i, tuple(a.shape), tuple(l.shape))
        for i, (a, l) in enumerate(zip(arrays, like_leaves))
        if tuple(a.shape) != tuple(l.shape)
    ]
    if bad:
        raise ValueError(
            f"checkpoint {path!r} was written for a different problem size; "
            f"mismatched leaf shapes (index, stored, expected): {bad[:5]}"
        )
    it = iter(torch.as_tensor(a, dtype=l.dtype, device=l.device) for a, l in zip(arrays, like_leaves))
    fields = {}
    for f in STATE_FIELDS:
        v = getattr(like, f)
        fields[f] = {k: next(it) for k in v} if isinstance(v, dict) else next(it)
    return IPState(**fields), meta["barrier"], meta["inertia_coef"], meta["iteration"]
