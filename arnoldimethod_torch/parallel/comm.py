"""The collectives of the row-sharded solver, written out.

The distribution model is the JAX package's (arnoldimethod_tpu/parallel/
mesh.py): the n-sized objects, the operator's rows and the Krylov basis V's
column axis, are split over a 1-D `rows` mesh into P contiguous runs of n/P
rows, one a rank; H, Q and the whole dense restart stay replicated,
identical on every rank.  The JAX package is a single controller and GSPMD
inserts the collectives.  This port is SPMD over torch.distributed, one
process a device, and each collective is an explicit call here:

- `all_reduce_`: every Gram-Schmidt contraction and norm (JAX's psum);
- `gather_partials`: the double-word sums of the extended path
  (extended=True), one `all_gather_into_tensor` of every rank's partial
  pairs (JAX: the collectives GSPMD makes of df_sum's tree); the sum over
  the ranks is folded from the gathered bits by the kernel that consumes
  it (`ops.df.df_axpy_gathered`, df_normalize's step form), or by one
  `df_rank_sum` launch (`df_sum`);
- `gather_rows`: x for an operator that reads all of it (JAX's all-gather),
  through `all_gather_into_tensor`;
- `exchange`: ShardedCsrOperator's footprint gather (JAX's ppermute
  rounds), one `all_to_all_single`;
- `halo`: a banded matvec's entries of x past this rank's rows, from
  whichever ranks own them (JAX's collective-permutes), one
  `all_to_all_single` whose splits are zero except to those ranks, so it
  moves the halo and nothing else.

These are collectives that NCCL and gloo both run on CUDA tensors, so one
code path serves several cards (NCCL), processes that share one card and
CPU processes (gloo).  Nothing is copied to the host here.  `COLLECTIVES`
counts the calls and the bytes of each kind: for an all-reduce the buffer's
bytes, for the others the bytes this rank receives.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops import df

__all__ = ["COLLECTIVES", "ROWS", "CollectiveCounts", "RowComm"]

ROWS = "rows"


class CollectiveCounts:
    """Calls and bytes of each kind of collective the port made: `calls`
    and `nbytes` map "all_reduce", "all_gather", "all_to_all", "halo" and
    "df_sum" to integers.  `reset()` sets them to 0 to count one solve or
    one step."""

    KINDS = ("all_reduce", "all_gather", "all_to_all", "halo", "df_sum")

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.nbytes = dict.fromkeys(self.KINDS, 0)

    def add(self, kind, nbytes):
        self.calls[kind] += 1
        self.nbytes[kind] += int(nbytes)

    def snapshot(self):
        """{kind: {"calls": c, "bytes": b}}, a copy."""
        return {k: {"calls": self.calls[k], "bytes": self.nbytes[k]}
                for k in self.KINDS}


COLLECTIVES = CollectiveCounts()


def _bytes(t):
    return t.numel() * t.element_size()


class RowComm:
    """This rank's part of an n-row partition over the `rows` dimension of
    `mesh` (a torch.distributed DeviceMesh): `rank`, `size` (the world
    size P), `n_local` = n / P rows and their global `offset`, and the
    collectives over the mesh's group.  n must divide evenly."""

    def __init__(self, mesh, n):
        self.mesh = mesh
        self.group = mesh.get_group(ROWS)
        self.size = mesh.size()
        self.rank = mesh.get_local_rank(ROWS)
        n = int(n)
        if n % self.size != 0:
            raise ValueError(
                f"matrix rows ({n}) must be divisible by the mesh size "
                f"({self.size}); pad the problem to a multiple first"
            )
        self.n = n
        self.n_local = n // self.size
        self.offset = self.rank * self.n_local

    def local(self, x):
        """This rank's rows of a global tensor x (n, ...): a view."""
        return x[self.offset:self.offset + self.n_local]

    def all_reduce_(self, t):
        """Sum t over the ranks, in place (complex tensors too); returns t.
        Every rank gets the same bits, so decisions taken from the sums
        agree on every rank."""
        dist.all_reduce(t, group=self.group)
        COLLECTIVES.add("all_reduce", _bytes(t))
        return t

    def gather_partials(self, parts):
        """Every rank's partial sums `parts`, a sequence of (hi, lo) pairs of
        0-dim or 1-D tensors, in one all_gather_into_tensor (a flat buffer,
        gloo's form): a `df.Gathered` record, seen as (P, 2k): each rank's
        k hi words, then its k lo; the parts' columns in order.  Every rank
        receives the same bits, so every rank folds the same sums (df32.
        df_sum's tree along the ranks; at one rank the partials
        themselves).  Not dist.all_reduce: its sum is single-word and its
        order the library's."""
        send = torch.cat([p[w].reshape(-1) for w in (0, 1) for p in parts])
        k = send.numel() // 2
        buf = send.new_empty(self.size * 2 * k)
        dist.all_gather_into_tensor(buf, send, group=self.group)
        COLLECTIVES.add("df_sum", _bytes(buf) - _bytes(send))
        offsets = [0]
        for p in parts[:-1]:
            offsets.append(offsets[-1] + p[0].numel())
        return df.Gathered(buf.view(self.size, 2 * k), k, tuple(offsets))

    def df_sum(self, parts, acc=None):
        """The double-word sums over the ranks of this rank's partial sums
        `parts` (`gather_partials`), folded by one df_rank_sum launch.
        Returns the k summed words flat, (sh, sl), the parts' in order.
        With acc, a pair of k words, also acc <- acc + sum in place."""
        g = self.gather_partials(parts)
        return df.df_rank_sum(g.hi, g.lo, acc)

    def gather_rows(self, x):
        """The global (n, ...) tensor from every rank's (n_local, ...)
        rows, in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.n, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        COLLECTIVES.add("all_gather", _bytes(out) - _bytes(x))
        return out

    def exchange(self, send, send_splits, recv_splits):
        """One all_to_all_single, started and not waited for: `send` holds
        send_splits[d] entries for rank d, in rank order; returns
        (received, work), the received entries recv_splits[s] from rank s
        in rank order, valid after `work.wait()`."""
        out = send.new_empty(sum(recv_splits))
        work = dist.all_to_all_single(out, send.contiguous(), list(recv_splits),
                                      list(send_splits), group=self.group,
                                      async_op=True)
        COLLECTIVES.add("all_to_all", _bytes(out))
        return out, work

    def halo(self, x, lo, hi):
        """x (this rank's n_local entries, or rows of them) with the `lo`
        entries of the global x before its rows and the `hi` after them, as
        a zero-padded global x has them (zeros before row 0 and past row
        n - 1): whichever ranks own those rows send them, in one
        all_to_all_single (`_halo_plan`).  lo and hi are at most n - 1."""
        if not (0 <= lo < max(self.n, 1) and 0 <= hi < max(self.n, 1)):
            raise ValueError(f"a halo of {lo} and {hi} rows is out of range "
                             f"for {self.n} rows")
        rest = tuple(x.shape[1:])
        if self.size == 1 or lo + hi == 0:
            return torch.cat((x.new_zeros((lo, *rest)), x,
                              x.new_zeros((hi, *rest))))
        plan = _halo_plan(self.n, self.size, self.rank, lo, hi)
        recv = x.new_empty((sum(plan.recv_splits), *rest))
        send = torch.cat([x[a:b] for a, b in plan.send_rows] or [x[:0]])
        dist.all_to_all_single(recv, send, list(plan.recv_splits),
                               list(plan.send_splits), group=self.group)
        COLLECTIVES.add("halo", _bytes(recv))
        left = sum(plan.recv_splits[:self.rank])
        return torch.cat((x.new_zeros((plan.pad_lo, *rest)), recv[:left], x,
                          recv[left:], x.new_zeros((plan.pad_hi, *rest))))


class _HaloPlan(NamedTuple):
    """One rank's all_to_all_single of a halo: the entries it sends each
    rank (`send_splits`, from its local rows `send_rows`, the non-empty
    (start, stop) runs in rank order), the entries it receives from each
    (`recv_splits`, in rank order: the rows before its own, then those
    after), and the zeros that stand for rows outside [0, n) before and
    after them."""

    send_splits: tuple
    recv_splits: tuple
    send_rows: tuple
    pad_lo: int
    pad_hi: int


@functools.lru_cache(maxsize=256)
def _halo_plan(n, p, r, lo, hi):
    """Rank r of p (n / p contiguous rows each) needs the global rows
    [off_r - lo, off_r) and [off_r + n/p, off_r + n/p + hi), clipped to
    [0, n); rank s owns [off_s, off_s + n/p) and sends what of it each rank
    needs.  Every rank computes the same table, so the splits agree."""
    nl = n // p

    def wanted(d):
        """The global rows rank d needs: a run before its rows, one after."""
        off = d * nl
        return ((max(0, off - lo), off), (off + nl, min(n, off + nl + hi)))

    def overlap(run, s):
        a, b = max(run[0], s * nl), min(run[1], (s + 1) * nl)
        return a, max(a, b)

    send_splits, send_rows, recv_splits = [], [], []
    for d in range(p):
        # Rank r's rows in d's runs (at most one run: the one on r's side),
        # and d's rows in r's runs; nothing to or from itself.
        sent = [] if d == r else [overlap(run, r) for run in wanted(d)]
        got = [] if d == r else [overlap(run, d) for run in wanted(r)]
        send_rows += [(a - r * nl, b - r * nl) for a, b in sent if b > a]
        send_splits.append(sum(b - a for a, b in sent))
        recv_splits.append(sum(b - a for a, b in got))
    before, after = wanted(r)
    return _HaloPlan(tuple(send_splits), tuple(recv_splits),
                     tuple(send_rows), lo - (before[1] - before[0]),
                     hi - (after[1] - after[0]))
