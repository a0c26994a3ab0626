"""The numbers a partial Schur decomposition A Q = Q R of the nev
smallest eigenvalues is judged by, worked out in float64 with the
reference's own matvec.

- nconverged_short: how many of the nev eigenvalues were not returned.
- eig_err: over sum |coefficients|, the larger of two distances: from
  each returned value to the nearest of the 2 nev smallest exact ones,
  and from each distinct exact value among the nev smallest to the
  nearest returned value: how far the values returned lie from those
  they stand for.
- multiplicity_errors: each returned value is assigned to its nearest
  exact eigenvalue, equal exact values taken as one multiple eigenvalue;
  counted are the distinct eigenvalues among the nev smallest that no
  returned value is assigned to, the values beyond an eigenvalue's
  multiplicity, and the values past the nev-th smallest beyond the copies
  of multiple eigenvalues left out.  A Krylov method from one start
  vector may return the next eigenvalue in place of a second (or later)
  copy, and only in place of one; leaving out a wanted eigenvalue counts
  however near its neighbour lies.
- beyond_nev (recorded, not compared): the returned values assigned past
  the nev-th smallest eigenvalue.
- schur_resid: ||A Q - Q R||_F over sum |coefficients|.
- orth: ||Q^T Q - I||_F."""

import numpy as np
import torch

from cardbench import reference

NUMBERS = ("nconverged_short", "eig_err", "multiplicity_errors",
           "schur_resid", "orth")
# Exact eigenvalues closer than this, over sum |coefficients|, are one
# multiple eigenvalue: far below float32's resolution of the spectrum and
# far above float64's rounding of the closed form.
CLUSTER = 1e-9


def check(cfg, kept):
    spec, nev = cfg["operator"], cfg["recipe"]["nev"]
    op = reference.operator_module(spec)
    scale = op.norm_bound(spec)
    Q = kept["Q_rows"].double()
    k = Q.shape[0]
    vals = np.asarray(kept["eigenvalues"])
    vals = vals[np.argsort(vals.real, kind="stable")]
    out = {"nconverged_short": float(max(nev - min(k, vals.size), 0))}
    if k == 0 or vals.size != k:
        return dict(out, eig_err=np.inf, multiplicity_errors=np.inf,
                    schur_resid=np.inf, orth=np.inf)
    out.update(eigen_numbers(vals, op.smallest(spec, 2 * nev), nev, scale))
    R = torch.as_tensor(np.asarray(kept["R"], dtype=np.float64),
                        device=Q.device)
    # Rows layout: (A Q)^T = R^T Q^T.
    resid = op.matvec_rows(Q, spec) - R.T @ Q
    out["schur_resid"] = torch.linalg.norm(resid).item() / scale
    del resid
    eye = torch.eye(k, dtype=torch.float64, device=Q.device)
    out["orth"] = torch.linalg.norm(Q @ Q.T - eye).item()
    return out


def eigen_numbers(vals, low, nev, scale):
    """eig_err, multiplicity_errors and beyond_nev of returned values
    `vals` against the exact low end of the spectrum `low` (ascending, at
    least nev values)."""
    vals = np.real(np.asarray(vals))
    low = np.asarray(low)
    # cluster[i]: the multiple eigenvalue low[i] belongs to.
    cluster = np.concatenate(
        [[0], np.cumsum(np.diff(low) > CLUSTER * scale)])
    nearest = np.abs(vals[:, None] - low[None, :]).argmin(axis=1)
    to_exact = np.abs(vals - low[nearest])
    to_wanted = np.abs(low[:nev, None] - vals[None, :]).min(axis=1)
    got = np.bincount(cluster[nearest], minlength=cluster[-1] + 1)
    # Multiplicities are known for every cluster but the one cut off at
    # the end of `low`; among the nev smallest, as far as they reach.
    mult = np.bincount(cluster)
    wanted = np.bincount(cluster[:nev])
    top = cluster[nev - 1]
    missing = int(np.sum(got[:top + 1] == 0))
    over = int(np.maximum(got - mult, 0)[:cluster[-1]].sum())
    left_out = int(np.sum(np.where(got[:top + 1] > 0,
                                   np.maximum(wanted - got[:top + 1], 0), 0)))
    beyond = int(np.sum(cluster[nearest] > top))
    return {"eig_err": float(max(to_exact.max(), to_wanted.max())) / scale,
            "multiplicity_errors": float(missing + over
                                         + max(beyond - left_out, 0)),
            "beyond_nev": float(beyond)}


def control(cfg, seed, device):
    """The control's answer in the program's place (see the operator's
    reference `control`), kept as the harness keeps a solve's."""
    spec, nev = cfg["operator"], cfg["recipe"]["nev"]
    Q, R, values = reference.operator_module(spec).control(spec, nev, seed,
                                                           device)
    return {"Q_rows": Q, "R": R, "eigenvalues": values, "nconverged": nev}
