"""partial_schur on the operator, as a user calls it."""

import arnoldimethod_torch as am
import torch

from cardbench.systems import module as system

# Restarts of the traced slice's short solve.
SLICE_RESTARTS = 3


def prepare(cfg, mix, device):
    r = cfg["recipe"]
    kw = dict(nev=r["nev"], which=r["which"], tol=r["tol"],
              mindim=r["mindim"], maxdim=r["maxdim"], restarts=r["restarts"])
    if mix["method"] is not None:
        kw["method"] = mix["method"]
    op = system(cfg["operator"]).build(cfg["operator"], device)
    return {"op": op, "kw": kw}


def warm_up(state, x0):
    """One restart of the cell's own solve: the first Krylov range, a dense
    restart and a second range, at the cell's n, maxdim and method."""
    am.partial_schur(state["op"], v1=x0, **dict(state["kw"], restarts=1))


def solve(state, x0, seed):
    return am.partial_schur(state["op"], v1=x0, **state["kw"]), {}


def keep(out):
    d, h = out
    kept = {"Q_rows": d.Q_rows.clone(), "R": d.R.copy(),
            "eigenvalues": d.eigenvalues.copy(), "nconverged": h.nconverged}
    return kept, history(h)


def history(h):
    """The program's counts and host spans of a solve (History)."""
    return {"mvproducts": h.mvproducts, "restarts": h.restarts,
            "host_syncs": h.host_syncs, "nconverged": h.nconverged,
            "converged": bool(h.converged),
            "timings": {k: float(v) for k, v in h.timings.items()}}


def slice_parts(state, x0):
    """"range": the first Krylov range alone (restarts=0), whose steps
    project against 1, 2, ..., maxdim rows; "steps": the solve stopped
    after SLICE_RESTARTS restarts."""
    op = state["op"]
    n = op.shape[0]
    itemsize = torch.empty((), dtype=op.dtype).element_size()

    def first_range():
        _, h = am.partial_schur(op, v1=x0, **dict(state["kw"], restarts=0))
        steps = h.mvproducts
        return {"steps": steps, "work": {"orthogonalization": {
            "n": n, "itemsize": itemsize, "j0": 0, "j1": steps}}}

    def restarts():
        _, h = am.partial_schur(op, v1=x0,
                                **dict(state["kw"], restarts=SLICE_RESTARTS))
        return {"steps": h.mvproducts, "work": {}}

    return [("range", first_range), ("steps", restarts)]
