"""Host-side symbolic analysis for the banded per-block KKT path
(counterpart of ``parapint_tpu.interfaces.banded_symbolic``).

Computes, once per problem (the analogue of MA27's symbolic factorization):

1. the sparsity pattern of the per-block KKT from sample-point AD
   evaluations (two random points per parameter sample, union),
2. a bandwidth-reducing, *constraint-after-its-variables* permutation
   (RCM on the variable graph, then each constraint row inserted after the
   last of its variables — the quasi-definite elimination order that keeps
   the unpivoted block-Thomas LDL^T sweep stable), and
3. the half-bandwidth p plus the probe/extraction index sets: a symmetric
   banded matrix with half-bandwidth p is determined by 2p+1 matvecs
   against stride-(2p+1) indicator probes.

``banded_plan`` is numpy/scipy and follows the reference line for line;
``block_patterns`` evaluates the torch model with ``torch.func``.
"""

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee
from torch.func import hessian, jacfwd


@dataclasses.dataclass(frozen=True)
class BandedPlan:
    """Static output of the symbolic analysis (all host numpy)."""

    perm: np.ndarray  # (nk,) permuted index i holds original index perm[i]
    iperm: np.ndarray  # (nk,)
    p: int  # half-bandwidth of the permuted KKT
    q: int  # probe stride = 2p+1
    # probe blocks in ORIGINAL index space, split by family:
    Vx: np.ndarray  # (q, n)
    Vs: np.ndarray  # (q, mi)
    Vyeq: np.ndarray  # (q, me)
    Vyineq: np.ndarray  # (q, mi)
    Vlam: np.ndarray  # (q, n_link)
    # band extraction gather indices (see structured.py banded assembly):
    col_idx: np.ndarray  # (p+1, nk) probe column of entry (e, i)
    row_idx: np.ndarray  # (p+1, nk) clipped permuted row i+e
    valid: np.ndarray  # (p+1, nk) float mask for i+e < nk


def _pattern(mat: torch.Tensor) -> np.ndarray:
    return mat.abs().cpu().numpy() > 0


def block_patterns(fns, params_samples, n, me, mi, device, rng=None):
    """Union sparsity patterns (Hess, Jeq, Jineq) from sample evaluations.

    ``fns`` is a BatchedNLPFunctions; evaluation runs in float64 on
    ``device`` with all masks enabled.  ``params_samples``: list of
    single-block param dicts; patterns are unioned over samples x two random
    points each (the same numpy draws as the JAX package's analysis).
    """
    if rng is None:
        rng = np.random.default_rng(20260820)
    f64 = torch.float64
    xm = torch.ones(n, dtype=torch.bool, device=device)
    em = torch.ones(me, dtype=f64, device=device)
    im = torch.ones(mi, dtype=f64, device=device)
    one = torch.ones((), dtype=f64, device=device)

    def lag(x, yeq, yineq, p):
        return fns._lag(x, yeq, yineq, one, p, xm, em, im)

    Hpat = np.zeros((n, n), dtype=bool)
    Jeq_pat = np.zeros((me, n), dtype=bool)
    Jineq_pat = np.zeros((mi, n), dtype=bool)
    as_t = lambda a: torch.as_tensor(a, dtype=f64, device=device)
    for p_s in params_samples:
        for _ in range(2):
            x = as_t(rng.normal(size=n) * 0.7 + 0.3)
            yeq = as_t(rng.normal(size=me))
            yineq = as_t(rng.normal(size=mi))
            Hpat |= _pattern(hessian(lag)(x, yeq, yineq, p_s))
            if me:
                Jeq_pat |= _pattern(jacfwd(lambda xx: fns._ceq(xx, p_s, xm, em))(x))
            if mi:
                Jineq_pat |= _pattern(jacfwd(lambda xx: fns._cineq(xx, p_s, xm, im))(x))
    return Hpat, Jeq_pat, Jineq_pat


def banded_plan(
    Hpat: np.ndarray,
    Jeq_pat: np.ndarray,
    Jineq_pat: np.ndarray,
    link_pat: np.ndarray,  # (n_link, n) union over blocks
    n: int,
    me: int,
    mi: int,
    n_link: int,
) -> BandedPlan:
    """Ordering + bandwidth + probe plan; see module docstring.

    Per-block KKT layout (original space): [x(n), s(mi), y_eq(me),
    y_ineq(mi), lam(n_link)] — parapint_tpu_torch.interfaces.blocked.sub_kkt_layout.
    """
    nv = n + mi  # variables: x then s
    nk = nv + me + mi + n_link
    off_s, off_yeq, off_yineq, off_lam = n, nv, nv + me, nv + me + mi

    # constraint rows over variable columns [x | s]
    empty = np.empty(0, dtype=np.int64)
    rows, cols = [], []
    er, ec = np.nonzero(Jeq_pat) if me else (empty, empty)
    rows.append(er)
    cols.append(ec)
    ir, icx = np.nonzero(Jineq_pat) if mi else (empty, empty)
    rows.append(me + ir)
    cols.append(icx)
    # s_i appears (with -1) in inequality row i
    rows.append(me + np.arange(mi))
    cols.append(n + np.arange(mi))
    lr, lc = np.nonzero(link_pat) if n_link else (empty, empty)
    rows.append(me + mi + lr)
    cols.append(lc)
    rows = np.concatenate([np.asarray(r, dtype=np.int64) for r in rows])
    cols = np.concatenate([np.asarray(c, dtype=np.int64) for c in cols])
    ncon = me + mi + n_link
    J = sp.csr_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(ncon, nv), dtype=np.int8
    )

    # variable graph: Hessian coupling + shared-constraint coupling
    Hfull = sp.lil_matrix((nv, nv), dtype=np.int8)
    hr, hc = np.nonzero(Hpat)
    Hfull[hr, hc] = 1
    G = (Hfull.tocsr() + J.T @ J).tocsr()
    G.data[:] = 1
    rcm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
    pos_var = np.empty(nv, dtype=np.int64)
    pos_var[rcm] = np.arange(nv)

    # constraint position = position of its LAST variable (quasi-definite
    # elimination order); empty (fully masked / diagonal-only) rows first
    Jc = J.tocsr()
    pos_con = np.full(ncon, -1, dtype=np.int64)
    for r in range(ncon):
        vs = Jc.indices[Jc.indptr[r] : Jc.indptr[r + 1]]
        if len(vs):
            pos_con[r] = pos_var[vs].max()

    # merge: stable sort by (2*pos) for vars, (2*pos + 1) for constraints
    keys = np.concatenate([2 * pos_var, 2 * pos_con + 1])
    # original full-KKT index of each participant
    var_ids = np.concatenate([np.arange(n), off_s + np.arange(mi)])
    con_ids = np.concatenate(
        [
            off_yeq + np.arange(me),
            off_yineq + np.arange(mi),
            off_lam + np.arange(n_link),
        ]
    ).astype(np.int64)
    ids = np.concatenate([var_ids, con_ids])
    order = np.argsort(keys, kind="stable")
    perm = ids[order]
    iperm = np.empty(nk, dtype=np.int64)
    iperm[perm] = np.arange(nk)

    # half-bandwidth of the permuted full KKT pattern
    full_r = [hr, hc]  # H symmetric: both triangles
    full_c = [hc, hr]
    if me:
        full_r += [off_yeq + er, ec]
        full_c += [ec, off_yeq + er]
    if mi:
        full_r += [off_yineq + ir, icx]
        full_c += [icx, off_yineq + ir]
        full_r += [off_yineq + np.arange(mi), off_s + np.arange(mi)]
        full_c += [off_s + np.arange(mi), off_yineq + np.arange(mi)]
    if n_link:
        full_r += [off_lam + lr, lc]
        full_c += [lc, off_lam + lr]
    fr = np.concatenate([np.asarray(a, dtype=np.int64) for a in full_r])
    fc = np.concatenate([np.asarray(a, dtype=np.int64) for a in full_c])
    p = int(np.abs(iperm[fr] - iperm[fc]).max()) if len(fr) else 0
    q = 2 * p + 1

    # probes: Vp[i, j] = 1 iff i == j (mod q), in permuted space; split into
    # family blocks in ORIGINAL space (V_orig[perm[i]] = Vp[i])
    Vp = (np.arange(nk)[:, None] % q) == np.arange(q)[None, :]
    V_orig = np.zeros((nk, q))
    V_orig[perm] = Vp.astype(np.float64)
    Vx = V_orig[:n].T.copy()
    Vs = V_orig[off_s:off_yeq].T.copy()
    Vyeq = V_orig[off_yeq:off_yineq].T.copy()
    Vyineq = V_orig[off_yineq:off_lam].T.copy()
    Vlam = V_orig[off_lam:].T.copy()

    ii = np.arange(nk)
    ee = np.arange(p + 1)[:, None]
    col_idx = np.broadcast_to(ii % q, (p + 1, nk)).copy()
    raw_rows = ii[None, :] + ee
    valid = (raw_rows < nk).astype(np.float64)
    row_idx = np.minimum(raw_rows, nk - 1)

    return BandedPlan(
        perm=perm,
        iperm=iperm,
        p=p,
        q=q,
        Vx=Vx,
        Vs=Vs,
        Vyeq=Vyeq,
        Vyineq=Vyineq,
        Vlam=Vlam,
        col_idx=col_idx,
        row_idx=row_idx,
        valid=valid,
    )
