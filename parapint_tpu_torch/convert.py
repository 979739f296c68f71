"""Carry iterates, model data and linear systems across from the JAX
package as numpy.

The port never imports JAX; these functions take plain numpy arrays (or any
array numpy can read) laid out as the JAX package's pytrees, so that the
two packages can start from the same iterate, the same model data and the
same KKT system.
"""

import numpy as np
import torch

from parapint_tpu_torch.interfaces.base import STATE_FIELDS, IPState

F64 = torch.float64


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def ipstate_from_numpy(tree, device) -> IPState:
    """IPState of float64 tensors on ``device`` from a JAX ``IPState`` (or a
    dict with the same field names) whose leaves are arrays or dicts of
    arrays."""

    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(a) for k, a in v.items()}
        return torch.as_tensor(np.array(v, dtype=np.float64), dtype=F64, device=device)

    return IPState(**{f: leaf(_field(tree, f)) for f in STATE_FIELDS})


def ipstate_to_numpy(state: IPState) -> dict:
    """{field: array or {key: array}} in numpy, the JAX IPState's layout."""

    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(a) for k, a in v.items()}
        return v.detach().cpu().numpy()

    return {f: leaf(getattr(state, f)) for f in STATE_FIELDS}


SPEC_ARRAYS = ("x0", "xl", "xu", "gl", "gu", "eq_mask", "ineq_mask", "x_mask")


def spec_arrays_from_numpy(spec, device) -> dict:
    """Keyword arguments ``params``, ``x0``, the bounds and the masks of a
    JAX ``DynamicModelSpec`` or ``StochasticModelSpec`` (or any object with
    those attributes) as tensors on ``device``, ready for the port's spec of
    the same name."""
    out = {
        "params": {
            k: torch.as_tensor(np.array(v), device=device) for k, v in spec.params.items()
        }
    }
    for name in SPEC_ARRAYS:
        a = np.array(getattr(spec, name))
        dtype = torch.bool if a.dtype == np.bool_ else F64
        out[name] = torch.as_tensor(a, dtype=dtype, device=device)
    return out


def _t(a, device, dtype=None):
    a = np.array(a)
    if dtype is None and a.dtype.kind == "i":
        dtype = torch.int64
    return torch.as_tensor(a, dtype=dtype, device=device)


def block_rhs_from_numpy(rhs, device):
    """The port's ``BlockRhs`` from a JAX ``BlockRhs`` (arrays as numpy)."""
    from parapint_tpu_torch.linalg.schur import BlockRhs

    return BlockRhs(blocks=_t(rhs.blocks, device), coupling=_t(rhs.coupling, device))


def block_kkt_from_numpy(kkt, device):
    """The port's ``BlockKKT`` or ``LocalBlockKKT`` from the JAX package's
    (told apart by ``border_loc``), dtypes kept and row indices int64."""
    from parapint_tpu_torch.linalg.schur import BlockKKT, LocalBlockKKT

    if hasattr(kkt, "border_loc"):
        return LocalBlockKKT(
            diag=_t(kkt.diag, device),
            border_loc=_t(kkt.border_loc, device),
            row_idx=_t(kkt.row_idx, device, torch.int64),
            q=_t(kkt.q, device),
            mask=_t(kkt.mask, device),
            assembly=kkt.assembly,
        )
    return BlockKKT(
        diag=_t(kkt.diag, device),
        border=_t(kkt.border, device),
        q=_t(kkt.q, device),
        mask=_t(kkt.mask, device),
    )


def condensed_kkt_from_numpy(A_bands, q_c, n_t: int, n_blocks: int, device):
    """The port's ``CondensedLSQKKT`` from the JAX package's fields (the
    band store and Q as numpy, dtypes kept)."""
    from parapint_tpu_torch.linalg.condensed import CondensedLSQKKT

    return CondensedLSQKKT(
        A_bands=_t(A_bands, device), q_c=_t(q_c, device), n_t=int(n_t), n_blocks=int(n_blocks)
    )


def kind_params_from_numpy(params_per_block, device) -> list:
    """Per-block parameter dicts of ``HeterogeneousDynamicInterface`` from
    the JAX package's (dicts of arrays or scalars), as tensors on
    ``device`` with numpy's dtypes (a Python float becomes float64)."""
    return [{k: _t(v, device) for k, v in p.items()} for p in params_per_block]
