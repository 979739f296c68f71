"""Scatter-adds in a fixed order: the same sums on every device and in every
run.

PyTorch's scatter-adds (``Tensor.index_add`` and ``index_put`` with
``accumulate``) add with atomics on CUDA, in an order that changes between
runs, so float64 results do not repeat bit for bit.  Here the entries that
land on one output position are added in ascending order of their flat
position in the input (block-major for an (N, L) map), one elementwise add
per entry, on the CPU and on the card alike.

The plan (a stable sort of the keys, then a gather table of shape
(largest multiplicity, positions hit)) depends only on the index map, so it
is computed once per map and cached while that tensor lives; an index map
must not be changed in place after its first use.  Entries whose index is
``size`` or more (the dump index) are dropped.
"""

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary

_plans = WeakIdKeyDictionary()


@dataclasses.dataclass(frozen=True)
class _Plan:
    keys: torch.Tensor  # (U,) the output positions hit, ascending
    gather: torch.Tensor  # (m, U) flat input positions; n_in = a zero
    n_in: int


def _make_plan(keys: torch.Tensor, size: int) -> _Plan:
    n_in = keys.numel()
    kept = torch.nonzero(keys < size).squeeze(1)
    k_sorted, order = torch.sort(keys[kept], stable=True)
    src = kept[order]
    uniq, counts = torch.unique_consecutive(k_sorted, return_counts=True)
    seg = torch.repeat_interleave(torch.arange(uniq.numel(), device=keys.device), counts)
    rank = torch.arange(src.numel(), device=keys.device) - (torch.cumsum(counts, 0) - counts)[seg]
    m = int(counts.max()) if counts.numel() else 0
    gather = torch.full((m, uniq.numel()), n_in, dtype=torch.int64, device=keys.device)
    gather[rank, seg] = src
    return _Plan(keys=uniq, gather=gather, n_in=n_in)


def _plan(row_idx: torch.Tensor, size: int, pairs: bool) -> _Plan:
    per_map = _plans.get(row_idx)
    if per_map is None:
        per_map = _plans[row_idx] = {}
    plan = per_map.get((size, pairs))
    if plan is None:
        r = row_idx.reshape(row_idx.shape[0], -1).long()
        if pairs:
            ok = (r[:, :, None] < size) & (r[:, None, :] < size)
            keys = torch.where(ok, r[:, :, None] * size + r[:, None, :], size * size)
            plan = _make_plan(keys.reshape(-1), size * size)
        else:
            plan = _make_plan(r.reshape(-1), size)
        per_map[(size, pairs)] = plan
    return plan


def _apply(plan: _Plan, values: torch.Tensor, n_out: int) -> torch.Tensor:
    flat = values.reshape(-1)
    if flat.numel() != plan.n_in:
        raise ValueError(f"expected {plan.n_in} values, got {flat.numel()}")
    parts = torch.cat([flat, flat.new_zeros(1)])[plan.gather]
    out = flat.new_zeros(n_out)
    if parts.shape[0]:
        acc = parts[0]
        for k in range(1, parts.shape[0]):
            acc = acc + parts[k]
        out[plan.keys] = acc
    return out


def scatter_add_rows(row_idx: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """out (size,) with out[k] = sum of values[b, l] over row_idx[b, l] == k,
    in ascending (b, l); ``values`` has ``row_idx``'s shape."""
    return _apply(_plan(row_idx, size, pairs=False), values, size)


def scatter_add_pairs(row_idx: torch.Tensor, S: torch.Tensor, size: int) -> torch.Tensor:
    """out (size, size) with out[p, q] = sum of S[b, l, m] over
    (row_idx[b, l], row_idx[b, m]) == (p, q), in ascending (b, l, m);
    row_idx (N, L), S (N, L, L)."""
    return _apply(_plan(row_idx, size, pairs=True), S, size * size).reshape(size, size)
