"""The collectives of dp × tp training, over one torch.distributed group each.

Only `all_reduce` (sum, min) is used: gloo runs it on CUDA tensors too,
so two ranks can share one card over gloo, where NCCL refuses two ranks on
one device. A gather is an all-reduce of zero-filled full tensors.

`Group` holds a process group and its size; `TensorParallel` adds the two
autograd functions of Megatron-style tensor parallelism (GSPMD inserts the
same collectives in the JAX package):

- `copy(x)`: identity forward, all-reduce backward, where a column-parallel
  product (or any rank-local slice) takes a replicated input: each rank's
  backward gives the part of dL/dx that its columns see;
- `reduce(x)`: all-reduce forward, identity backward, after a
  row-parallel product (or a vocab / codebook partial sum): the sum is
  replicated, and so is its gradient.

`col_product(x, w)` and `row_product(x, w)` are the two products with
those collectives on either side. In 16-bit compute they keep each rank's
partial sums in f32 until the one rounding that the single process's
product makes (its f32 accumulator's): the product runs on 16-bit values
widened to f32, which TF32 holds exactly, so the tensor cores take it at
their TF32 rate; a rank's half of a product is summed over the ranks in
f32 and rounded once, in the forward (row-parallel) and in the backward
(column-parallel). On an H100 a (dp 1, tp 2) step's bf16 gradients had
a worst-leaf cosine of 0.99849 to one process's with halves rounded to
bf16 and 0.99877 with them kept in f32: as far from the f32 gradients as
one process's bf16 ones are (0.99812); a dp split gave 0.99994.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

WIDE = (torch.bfloat16, torch.float16)  # the dtypes whose products widen


@contextmanager
def _tf32():
    """TF32 products inside: exact for values widened from 16 bits."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of 16-bit values, f32 out."""
    with _tf32():
        return torch.matmul(a.float(), b.float())


def _weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Σ over the leading dims of xᵀ g, f32 out: [K, N]."""
    return _mm(x.reshape(-1, x.shape[-1]).transpose(0, 1), g.reshape(-1, g.shape[-1]))


class Group:
    """A process group (None for a world of one) and this rank's place in it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.detach().clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            dist.all_reduce(y, op=op, group=self.group)
        return y

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the group (a new tensor; no autograd)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place Σ over the group of a contiguous tensor."""
        if self.size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def gather_rows(self, local: torch.Tensor):
        """The group's rows in rank order: each rank's `local` [n_r, ...]
        (n_r may differ, or be 0) → ([Σ n_r, ...] on every rank, this rank's
        first row in it), by two all-reduces (the counts, then the
        zero-filled rows)."""
        counts = torch.zeros(self.size, dtype=torch.int64, device=local.device)
        counts[self.rank] = local.shape[0]
        counts = self.sum(counts).tolist()
        start = sum(counts[: self.rank])
        full = torch.zeros((sum(counts), *local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[start: start + local.shape[0]] = local
        return self.sum_(full), start


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.sum(grad), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ColWide(torch.autograd.Function):
    """copy(x) @ w for 16-bit x, w: the product rounds once to x's dtype;
    the input's gradient sums the ranks' f32 halves, then rounds."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        return _mm(x, w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = ctx.tp.sum(_mm(g, w.transpose(0, 1))).to(x.dtype)
        return gx, _weight_grad(x, g).to(w.dtype), None


class _RowWide(torch.autograd.Function):
    """x @ w summed over the ranks, f32 out (the caller rounds once)."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        return tp.sum(_mm(x, w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _mm(g, w.transpose(0, 1)).to(x.dtype), _weight_grad(x, g).to(w.dtype), None


class TensorParallel(Group):
    """The tp group of a rank, with the autograd pair above."""

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def col_product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w for a column slice w of a product whose input x is replicated."""
        if x.dtype in WIDE:
            return _ColWide.apply(x, w, self)
        return self.copy(x) @ w

    def row_product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of x @ w for a row slice w (x: the rank's
        columns of the layer's input) → replicated, in x's dtype."""
        if x.dtype in WIDE:
            return _RowWide.apply(x, w, self).to(x.dtype)
        return self.reduce(x @ w)
