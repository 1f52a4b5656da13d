"""Data parallelism over a process group, with the JAX package's semantics.

The counterpart of ``prior_diffuse_tpu/parallel/mesh.py``.  JAX's 1-D
``dp`` mesh shards the batch contiguously (``P("dp")``) and replicates the
state, and under GSPMD the BatchNorm batch statistics and the masked loss
means are *global* over the mesh.  Here each process of a
``torch.distributed`` group drives one device and holds one contiguous
share of the one global batch: the batch padded with zero rows (whose
``frame_nums`` are 0) to a multiple of the ranks, rank ``r`` holding rows
``[r * b, (r + 1) * b)``, the rows JAX gives device ``r``.  Three hooks
make a step on N ranks the step on the global batch, where
``DistributedDataParallel``'s defaults would not:

* :func:`global_sum`, for ``models/layers.py::batch_norm_train`` (the sums
  of ``x`` and ``x^2`` and the count: global statistics, whose gradient is
  global too) and the masked losses of ``losses.py`` (the mask sum: each
  rank's loss is its numerator over the global denominator, so the ranks'
  losses and gradients are *summed*, not averaged);
* :func:`draw_rows`, for the q-sample and the reverse chain: the global
  padded shape drawn from the generator every rank seeded alike, this
  rank's rows kept, so N ranks draw what one process draws;
* :func:`global_shares`, for the values a trainer reports.

The hooks act while a :class:`DataParallel` is current (``with dp:``);
outside one, and in a process that has none, each is the identity and no
collective runs.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

_CURRENT: ContextVar[Optional["DataParallel"]] = ContextVar("data_parallel", default=None)


def current() -> Optional["DataParallel"]:
    """The :class:`DataParallel` whose ``with`` block this code runs in, or None."""
    return _CURRENT.get()


def shard_rows(a, rank: int, world: int):
    """Rank ``rank``'s rows of the batch ``a`` (numpy array or tensor, rows
    first): ``a`` padded with zero rows to a multiple of ``world``, then its
    ``rank``-th contiguous share (JAX ``training/base.py::put_batch`` and
    ``P("dp")``)."""
    per = -(-len(a) // world)
    pad = per * world - len(a)
    if pad and isinstance(a, torch.Tensor):
        a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    elif pad:
        a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])
    return a[rank * per:(rank + 1) * per]


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group forward, SUM of the gradients backward: the
    gradient of a global sum with respect to one rank's addend is the sum
    of every rank's gradient of what consumed it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class DataParallel:
    """This process's place in a data-parallel group: ``rank`` of ``world``
    processes, each driving its own ``device``, over ``group`` (None: the
    default group of ``distributed.initialize``)."""

    def __init__(self, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call parallel.distributed.initialize first")
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._src = 0 if group is None else dist.get_global_rank(group, 0)
        self._tokens: List = []

    def __enter__(self) -> "DataParallel":
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._tokens.pop())

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_rows(self, a):
        """This rank's rows of the global batch ``a``: :func:`shard_rows`."""
        return shard_rows(a, self.rank, self.world)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, differentiably (:class:`_AllReduceSum`)."""
        return _AllReduceSum.apply(x, self.group)

    def gather_rows(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """Every rank's rows of ``x`` in rank order, on every rank, cut to the
        first ``rows`` (the global batch without its pad rows).  An
        all-gather written as one SUM all-reduce of a zero buffer holding
        this rank's rows at its offset: all-reduce is the collective every
        backend runs on CUDA tensors (gloo's all-gather is CPU-only), and
        adding zeros is exact."""
        n = x.shape[0]
        full = x.new_zeros((n * self.world, *x.shape[1:]))
        full[self.rank * n:(self.rank + 1) * n] = x
        dist.all_reduce(full, group=self.group)
        return full[:rows]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def _coalesced(self, tensors: Sequence[torch.Tensor], collective: Callable) -> None:
        """Run ``collective`` in place on one flat buffer per dtype of
        ``tensors`` and copy the result back into them."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = _flatten_dense_tensors(group)
            collective(flat)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)

    @torch.no_grad()
    def broadcast_modules(self, modules: Iterable[torch.nn.Module]) -> None:
        """Rank 0's parameters and buffers into every rank's ``modules``."""
        tensors = [t.data for m in modules for t in (*m.parameters(), *m.buffers())]
        self._coalesced(tensors, lambda flat: dist.broadcast(flat, src=self._src,
                                                              group=self.group))

    @torch.no_grad()
    def sum_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Each gradient summed over the ranks, in place: one all-reduce of
        the gradients that exist (a frozen net has none, on every rank)."""
        grads = [p.grad for p in params if p.grad is not None]
        self._coalesced(grads, lambda flat: dist.all_reduce(flat, group=self.group))

    def sum_scalars(self, *xs: torch.Tensor) -> tuple:
        """The 0-d tensors ``xs`` summed over the ranks (one all-reduce)."""
        s = torch.stack([x.detach().float() for x in xs])
        dist.all_reduce(s, group=self.group)
        return tuple(s.unbind())


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the current :class:`DataParallel`
    (its gradient summed too); ``x`` itself outside one."""
    dp = _CURRENT.get()
    return x if dp is None else dp.all_reduce_sum(x)


def global_shares(*xs: torch.Tensor) -> tuple:
    """Per-rank shares of global values (a loss's numerator over its global
    denominator) summed to the values; the 0-d tensors ``xs`` themselves
    outside a :class:`DataParallel`."""
    dp = _CURRENT.get()
    return xs if dp is None else dp.sum_scalars(*xs)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              dim: int = 0) -> torch.Tensor:
    """``draw(shape)`` for a batch whose rows run along ``dim``: inside a
    :class:`DataParallel`, ``draw`` of the global padded shape (``world``
    times the rows) and this rank's contiguous rows of it, so every rank
    takes the draws one process takes of the whole batch."""
    dp = _CURRENT.get()
    if dp is None:
        return draw(tuple(shape))
    rows = shape[dim]
    full = list(shape)
    full[dim] = rows * dp.world
    return draw(tuple(full)).narrow(dim, dp.rank * rows, rows).contiguous()
