"""The filtered recipe for the smallest eigenvalues of a large operator:
estimate_interval, a ChebyshevFilterOperator over it, partial_schur of
the filter with which="LM", and rayleigh_ritz back to the operator."""

import arnoldimethod_torch as am
import torch

from cardbench.recipes.partial_schur import history
from cardbench.systems import module as system

# Filtered matvecs in the traced slice.
SLICE_MATVECS = 4


def prepare(cfg, mix, device):
    r = cfg["recipe"]
    kw = dict(nev=r["nev"], which=r["which"], tol=r["tol"],
              mindim=r["mindim"], maxdim=r["maxdim"], restarts=r["restarts"])
    if mix["method"] is not None:
        kw["method"] = mix["method"]
    op = system(cfg["operator"]).build(cfg["operator"], device)
    return {"op": op, "kw": kw, "nev": r["nev"], "degree": r["degree"],
            "interval": dict(maxdim=r["interval"]["maxdim"],
                             refine_degree=tuple(r["interval"]["refine_degree"])),
            "last_interval": None}


def _interval(state, seed, refine_degree=None):
    iv = dict(state["interval"])
    if refine_degree is not None:
        iv["refine_degree"] = refine_degree
    return am.estimate_interval(state["op"], nev=state["nev"], seed=seed, **iv)


def warm_up(state, x0):
    """Every piece at the cell's n, nev and maxdim, with degree-2 filters
    in place of the long ones: the interval's passes, one restart of the
    filtered solve and a Rayleigh-Ritz over a random block."""
    op = state["op"]
    iv = _interval(state, 0, (2,) * len(state["interval"]["refine_degree"]))
    fop = am.ChebyshevFilterOperator(op, iv.a, iv.b, 2, scale_point=iv.lo)
    am.partial_schur(fop, v1=x0, **dict(state["kw"], restarts=1))
    gen = torch.Generator(device=x0.device).manual_seed(0)
    X = torch.randn((state["nev"], op.shape[0]), generator=gen,
                    dtype=x0.dtype, device=x0.device)
    am.rayleigh_ritz(op, X, rows_layout=True, return_vectors=False)


def solve(state, x0, seed):
    import time

    op = state["op"]
    t0 = time.perf_counter()
    # estimate_interval returns host floats, so its span needs no sync.
    iv = _interval(state, seed)
    interval_s = time.perf_counter() - t0
    state["last_interval"] = iv
    fop = am.ChebyshevFilterOperator(op, iv.a, iv.b, state["degree"],
                                     scale_point=iv.lo)
    d, h = am.partial_schur(fop, v1=x0, **state["kw"])
    w, _, res = am.rayleigh_ritz(op, d.Q_rows, rows_layout=True,
                                 return_vectors=False)
    return (d, h, w, res), {"interval_s": interval_s}


def keep(out):
    d, h, w, res = out
    kept = {"Q_rows": d.Q_rows.clone(), "values": w.copy(),
            "nconverged": h.nconverged}
    return kept, history(h)


def slice_parts(state, x0):
    """"steps": SLICE_MATVECS filtered matvecs through the filter of the
    window's last interval, each one Krylov step's operator."""
    iv = state["last_interval"]
    fop = am.ChebyshevFilterOperator(state["op"], iv.a, iv.b,
                                     state["degree"], scale_point=iv.lo)
    itemsize = x0.element_size()

    def matvecs():
        for _ in range(SLICE_MATVECS):
            fop.matvec(x0)
        return {"steps": SLICE_MATVECS, "work": {"filtered_matvec": {
            "n": x0.numel(), "degree": state["degree"], "itemsize": itemsize,
            "count": SLICE_MATVECS}}}

    return [("steps", matvecs)]
