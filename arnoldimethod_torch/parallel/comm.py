"""The collectives of the row-sharded solver, written out.

The distribution model is the JAX package's (arnoldimethod_tpu/parallel/
mesh.py): the n-sized objects, the operator's rows and the Krylov basis V's
column axis, are split over a 1-D `rows` mesh into P contiguous runs of n/P
rows, one a rank; H, Q and the whole dense restart stay replicated,
identical on every rank.  The JAX package is a single controller and GSPMD
inserts the collectives.  This port is SPMD over torch.distributed, one
process a device, and each collective is an explicit call here:

- `all_reduce_`: every Gram-Schmidt contraction and norm (JAX's psum);
- `df_sum`: the double-word sums of the extended path (extended=True),
  one `all_gather_into_tensor` of every rank's partial pairs and one
  `df_rank_sum` launch on the gathered bits (JAX: the collectives GSPMD
  makes of df_sum's tree);
- `gather_rows`: x for an operator that reads all of it (JAX's all-gather),
  through `all_gather_into_tensor`;
- `exchange`: ShardedCsrOperator's footprint gather (JAX's ppermute
  rounds), one `all_to_all_single`;
- `halo`: a banded matvec's boundary entries from ranks -1 and +1 (JAX's
  collective-permute), one `all_to_all_single` whose splits are zero
  except to the two neighbours, so it moves the halo and nothing else.

These are collectives that NCCL and gloo both run on CUDA tensors, so one
code path serves several cards (NCCL), processes that share one card and
CPU processes (gloo).  Nothing is copied to the host here.  `COLLECTIVES`
counts the calls and the bytes of each kind: for an all-reduce the buffer's
bytes, for the others the bytes this rank receives.
"""

from __future__ import annotations

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

    def df_sum(self, parts, acc=None):
        """The double-word sums over the ranks of this rank's partial sums
        `parts`, a sequence of (hi, lo) pairs of 0-dim or 1-D tensors: one
        all_gather_into_tensor of them all (a flat buffer, gloo's form,
        seen as (P, 2k): each rank's k hi words, then its k lo), then one
        df_rank_sum (df32.df_sum's tree along the ranks; at one rank the
        partials themselves).  Every rank sums the same gathered bits, so
        every rank gets the same sums.  Returns the k summed words flat,
        (sh, sl), the parts' in order.  With acc, a pair of k words, also
        acc <- acc + sum in place.  Not dist.all_reduce: its sum is
        single-word and its order the library's."""
        send = torch.cat([p[w].reshape(-1) for w in (0, 1) for p in parts])
        k = send.numel() // 2
        buf = send.new_empty(self.size * 2 * k)
        dist.all_gather_into_tensor(buf, send, group=self.group)
        COLLECTIVES.add("df_sum", _bytes(buf) - _bytes(send))
        buf = buf.view(self.size, 2 * k)
        return df.df_rank_sum(buf[:, :k], buf[:, k:], acc)

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
        """x (this rank's n_local entries, or rows of them) with `lo`
        entries of rank - 1's tail before it and `hi` of rank + 1's head
        after it; zeros past the first and last rank, as a zero-padded
        global x has.  lo and hi are at most n_local."""
        r, p = self.rank, self.size
        rest = tuple(x.shape[1:])
        left, right = x.new_zeros((lo, *rest)), x.new_zeros((hi, *rest))
        if p > 1 and lo + hi > 0:
            send_splits, recv_splits, parts = [0] * p, [0] * p, []
            if r > 0:
                send_splits[r - 1], recv_splits[r - 1] = hi, lo
                parts.append(x[:hi])
            if r + 1 < p:
                send_splits[r + 1], recv_splits[r + 1] = lo, hi
                parts.append(x[x.shape[0] - lo:])
            recv = x.new_empty((sum(recv_splits), *rest))
            dist.all_to_all_single(recv, torch.cat(parts), recv_splits,
                                   send_splits, group=self.group)
            COLLECTIVES.add("halo", _bytes(recv))
            if r > 0:
                left = recv[:lo]
            if r + 1 < p:
                right = recv[recv.shape[0] - hi:]
        return torch.cat((left, x, right))
