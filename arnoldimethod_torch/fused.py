"""The Krylov-Schur solve with the whole restart on the device:
`partial_schur(..., method="device")`.

Counterpart of the JAX package's `arnoldimethod_tpu/fused.py`, restart for
restart: the same convergence criterion, truncation rule, conjugate-pair
and purge handling, with the dense work (Francis QR, Ritz values and
residuals, locking, the Sylvester-swap partition, the Hessenberg restore,
the truncation matrix) in the working dtype, on the device, instead of in
host float64.  H stays on the device for the whole solve.

Each restart runs, in order:
1. `dense.device.restart`: on the card one launch of the restart kernel
   (`csrc/dense_restart.cu`), on the CPU its plain version.  It first
   reads the breakdown flags of the last expansion range; when step j*
   broke down it writes j* to the state's rollback slot and changes
   nothing else.
2. One read of the int32 loop state (`dense.device.STATE`).
3. On a rollback: step j* is finished on the breakdown path
   (`ops.expansion.finish_breakdown`), steps j*+1..m-1 run again and the
   restart is launched again: one more read.
4. Otherwise the basis change V <- Qbig^T V (a plain GEMM, as XLA does it
   in the JAX package), then, unless the solve is done, the expansion
   from k back to m with no host read (`expand_range_device`).
Then one final dense phase (`dense.device.finish`: the sort into the
target order and the eigenvalues), its basis change, and one batched
readback in the driver.  So a solve reads the device once a restart, once
more a rollback, and once at the end.

Sharded (`comm`): V holds this rank's columns, the expansion's
contractions are summed over the ranks on the stream (ops/expansion.py),
and every rank launches the restart kernel on its own copy of H, which is
the same on every rank bit for bit, so the state read and every decision
agree; Qbig is applied to the local columns.

Divergences from the JAX package: no chunked dispatch (its dispatch
budget is a TPU-watchdog workaround), one state read a restart where JAX
reads one flag a chunk, and random rows of the breakdown path from a
torch.Generator instead of `fold_in(key, it)`.
"""

from __future__ import annotations

import torch

from . import trace
from .dense.device import STATE, finish, new_state, restart
from .ops.expansion import apply_basis_change, expand_range_device, finish_breakdown

__all__ = ["fused_solve"]


def _roll_back(op, V, H, flags, j, m, generator, comm=None):
    """Finish step j on the breakdown path and run the steps after it
    again (their flags cleared and written anew)."""
    finish_breakdown(V, H, j, m, generator, comm)
    flags[j] = 0
    expand_range_device(op, V, H, j + 1, m, flags, comm)


def fused_solve(op, V, H, nev, mindim, tol, restarts, generator, which,
                active0=0, maxiter_qr=None, comm=None):
    """Run the Krylov-Schur iteration with its restarts on the device.

    V: (m+1, n) with V[active0] the normalized start vector; for a warm
    start, rows [0, active0) hold locked Schur vectors and H's leading
    columns the locked R block.  H: (m+1, m) in the working dtype on V's
    device, columns [active0, m) zero.  V and H are updated in place: on
    return they hold the basis and the Hessenberg factor, truncated and
    sorted into the target order.

    Returns (lam, state, reads): lam (2, m) the eigenvalues of the leading
    blocks, re and im; state the int32 loop state on the device (active =
    nconverged, prods, it, purges, qr_ok); reads the host reads made.
    `comm` (a `parallel.comm.RowComm`) runs the sharded solve, V being this
    rank's columns of the basis."""
    m = H.shape[1]
    flags = torch.zeros(m, dtype=H.dtype, device=H.device)
    state = new_state(active0, m, restarts, device=H.device)
    Qbig = torch.empty((m + 1, m + 1), dtype=H.dtype, device=H.device)
    reads = 0
    with trace.span("expand"):
        expand_range_device(op, V, H, active0, m, flags, comm)
    if restarts <= 0:
        # No dense phase reads the flags: settle the range here.
        while True:
            broke = torch.nonzero(flags).flatten()
            with trace.span(key="sync_wait"):
                broke = broke.tolist()
            reads += 1
            if not broke:
                break
            _roll_back(op, V, H, flags, broke[0], m, generator, comm)
    else:
        while True:
            with trace.span("dense_restart"):
                restart(H, Qbig, state, flags, nev=nev, mindim=mindim,
                        tol=tol, restarts=restarts, which=which,
                        maxiter=maxiter_qr)
                with trace.span(key="sync_wait"):
                    s = state.tolist()
            reads += 1
            if s[STATE["rollback"]] >= 0:
                _roll_back(op, V, H, flags, s[STATE["rollback"]], m,
                           generator, comm)
                continue
            if s[STATE["done"]]:
                apply_basis_change(V, Qbig)
                break
            with trace.span("truncate_expand"):
                apply_basis_change(V, Qbig)
                expand_range_device(op, V, H, s[STATE["k"]], m, flags, comm)
    with trace.span("finish"):
        lam = torch.empty((2, m), dtype=H.dtype, device=H.device)
        finish(H, Qbig, lam, state, which)
        apply_basis_change(V, Qbig)
    return lam, state, reads
