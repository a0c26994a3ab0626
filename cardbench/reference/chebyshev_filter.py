"""The numbers a filtered solve of the nev smallest eigenvalues is judged
by: the Ritz values it returned and the basis Q (its Schur vectors of the
filter, an orthonormal basis of an invariant subspace of A), worked out in
float64 with the reference's own matvec, a block of rows at a time.

- nconverged_short: how many of the nev values or rows were not returned.
- eig_err, multiplicity_errors: of the nev smallest returned values, as
  reference/partial_schur.py has them: every returned value near an exact
  one, every distinct one of the nev smallest exact values returned, and
  only copies of multiple eigenvalues replaced by the next values.
- subspace_resid: ||A Q - Q S||_F with S = Q^T A Q, over sum
  |coefficients|: zero for an invariant subspace.
- orth: ||Q^T Q - I||_F."""

import numpy as np
import torch

from cardbench import reference
from cardbench.reference.partial_schur import eigen_numbers

NUMBERS = ("nconverged_short", "eig_err", "multiplicity_errors",
           "subspace_resid", "orth")
BLOCK = 10


def check(cfg, kept):
    spec, nev = cfg["operator"], cfg["recipe"]["nev"]
    op = reference.operator_module(spec)
    scale = op.norm_bound(spec)
    Qf = kept["Q_rows"]
    k = Qf.shape[0]
    vals = np.sort(np.real(np.asarray(kept["values"])))
    out = {"nconverged_short": float(max(nev - min(k, vals.size), 0))}
    if k < nev or vals.size < nev:
        return dict(out, eig_err=np.inf, multiplicity_errors=np.inf,
                    subspace_resid=np.inf, orth=np.inf)
    out.update(eigen_numbers(vals[:nev], op.smallest(spec, 2 * nev), nev,
                             scale))
    Q = Qf.double()
    S = torch.empty((k, k), dtype=torch.float64, device=Q.device)
    for b in range(0, k, BLOCK):
        S[:, b:b + BLOCK] = Q @ op.matvec_rows(Q[b:b + BLOCK], spec).T
    sq = 0.0
    for b in range(0, k, BLOCK):
        resid = op.matvec_rows(Q[b:b + BLOCK], spec) - S[:, b:b + BLOCK].T @ Q
        sq += torch.sum(resid * resid).item()
        del resid
    out["subspace_resid"] = float(np.sqrt(sq)) / scale
    eye = torch.eye(k, dtype=torch.float64, device=Q.device)
    out["orth"] = torch.linalg.norm(Q @ Q.T - eye).item()
    return out


def control(cfg, seed, device):
    spec, nev = cfg["operator"], cfg["recipe"]["nev"]
    Q, _, values = reference.operator_module(spec).control(spec, nev, seed,
                                                           device)
    return {"Q_rows": Q, "values": values, "nconverged": nev}
