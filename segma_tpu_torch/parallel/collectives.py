"""The collectives of a tensor- or sequence-parallel group.

The layers that split their work over ``model`` (heads, MLP features) or
``seq`` (the Whisper encoder's time axis) call a group through four names:
``rank``, ``size``, ``all_reduce_sum(x)`` and ``all_gather(x, dim)``. They
are written once against that interface:

- ``SOLO``, the group of one: the identity, so a module outside a mesh runs
  as it always did, bit for bit;
- ``ThreadGroup``, an in-process rendezvous of members that each run on a
  thread of their own (serving: one process drives every card's members);
  ``ThreadGroup.member(rank)`` is the interface one member calls;
- ``DistGroup``, a ``torch.distributed`` group of processes, this process
  one member (training: one process per mesh device; the autograd engine
  runs one card's backward passes on one thread, so members that are
  threads on one card would wait for each other inside a backward).

``SOLO`` and ``DistGroup`` also reduce tensors in place for the trainer
(``mean_``, ``sum_``): a data-parallel reduction runs over a group, and
``SOLO`` where there is one process.

Under autograd a collective needs the right backward, and the layers call
them through three functions that give it (``torch.autograd.Function``s over
any of the three groups; over a group of one each is the identity):

- ``enter(x, group)``: the identity forward, a sum over the group backward,
  where a replicated activation (or parameter) feeds work that the members
  split, such as a column-parallel layer's heads or features, so that its
  gradient is the whole one on every member;
- ``reduce_sum(x, group)``: the sum forward, the identity backward (after a
  row-parallel layer);
- ``gather(x, group, dim, summed=...)``: the members' blocks concatenated;
  the backward keeps this member's block of the gradient, summed over the
  group first (``summed=True``: every member used every block) or not
  (``summed=False``: what follows runs whole and alike on every member, so
  each holds the whole gradient already).

A call that autograd does not record (serving) calls the group's method
directly.

A collective of a ``ThreadGroup`` is a deposit and a barrier: each member
leaves its tensor (and, on a card, an event recorded on its stream) in a
slot, waits for the others, then reads every slot in rank order onto its
own device: its stream waits on the peer's event, and ``record_stream``
tells the caching allocator that the peer's memory is in use on the
reader's stream until that work is done. On one card the peer's tensor is
read in place, on another it is copied over. Sums run in rank order 0 to
size - 1 on every member, so the members' results are the same bits. The
slots alternate between two sets: a member writes round r's slot only after
every member has passed round r - 1's barrier, so no one still reads the
slot of round r - 2 that it overwrites, and the tensor stays referenced
until then.

A member that raises aborts its groups (``run_members``): the peers waiting
at a barrier raise ``GroupAborted``, and the caller gets the member's own
error. A barrier that waits longer than ``timeout`` seconds raises too.
"""

from __future__ import annotations

import threading
from concurrent.futures import Executor
from typing import Callable, Sequence, TypeVar

import torch

T = TypeVar("T")
DEFAULT_TIMEOUT_S = 600.0  # a member's wait at one barrier (a cold kernel build included)


class GroupAborted(RuntimeError):
    """A peer raised (or a barrier timed out) while this member waited."""


class Solo:
    """The group of one member: every collective is the identity."""

    rank = 0
    size = 1

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x

    def mean_(self, tensors: list[torch.Tensor]) -> None:
        pass

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        return x


SOLO = Solo()


class ThreadGroup:
    """``size`` members in one process, each on its own thread and device
    (a device may repeat: several members on one card, or ``"cpu"``)."""

    def __init__(self, devices: Sequence, timeout: float = DEFAULT_TIMEOUT_S) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout = timeout
        self._barrier = threading.Barrier(self.size)
        self.reset()

    def member(self, rank: int) -> ThreadMember:
        return ThreadMember(self, rank)

    def abort(self) -> None:
        """Break the barrier: members waiting at it, or arriving later,
        raise ``GroupAborted``."""
        self._barrier.abort()

    def reset(self) -> None:
        """Ready for a new call after an aborted one: round 0, empty slots."""
        self._barrier.reset()
        self._rounds = [0] * self.size
        self._slots = [[None] * self.size, [None] * self.size]

    def _wait(self) -> None:
        try:
            self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            raise GroupAborted(
                f"a peer of this {self.size}-member group raised, or the group waited "
                f"longer than {self.timeout} s") from None


class ThreadMember:
    """Member ``rank`` of a ``ThreadGroup``: the interface its layers call."""

    def __init__(self, group: ThreadGroup, rank: int) -> None:
        self.group = group
        self.rank = rank
        self.size = group.size

    def _exchange(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every member's ``x``, in rank order, readable on this member's
        device and stream."""
        g = self.group
        slots = g._slots[g._rounds[self.rank] % 2]
        g._rounds[self.rank] += 1
        event = None
        if x.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(x.device))
        slots[self.rank] = (x, event)
        g._wait()
        out = []
        for j, (t, ev) in enumerate(slots):
            if j == self.rank:
                out.append(x)
            elif not t.is_cuda:
                out.append(t.to(x.device))
            else:
                mine = torch.cuda.current_stream(x.device)
                mine.wait_event(ev)
                if t.device == x.device:  # one card: the peer's memory, read in place
                    t.record_stream(mine)
                    out.append(t)
                else:
                    # the copy runs on this thread's stream of the peer's card
                    # and orders itself against ``mine``
                    theirs = torch.cuda.current_stream(t.device)
                    theirs.wait_event(ev)
                    t.record_stream(theirs)
                    out.append(t.to(x.device, non_blocking=True))
        return out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The members' ``x`` summed in rank order: the same bits on each."""
        parts = self._exchange(x)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The members' ``x`` concatenated along ``dim`` in rank order."""
        return torch.cat(self._exchange(x), dim=dim)


def run_members(pool: Executor, tasks: Sequence[Callable[[], T]],
                groups: Sequence[ThreadGroup]) -> list[T]:
    """Run each task on ``pool``, every one at once (a task is one member's
    work, and its collectives wait for the others). A task that raises
    aborts ``groups``, so no peer waits for it. Returns the results in
    order; raises the first task's own error, not a peer's
    ``GroupAborted``, after every task has ended, with the groups reset."""

    def guarded(task: Callable[[], T]) -> T:
        try:
            return task()
        except BaseException:
            for group in groups:
                group.abort()
            raise

    futures = [pool.submit(guarded, task) for task in tasks]
    results, errors = [], []
    for future in futures:
        try:
            results.append(future.result())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
    if errors:
        for group in groups:
            group.reset()
        own = [e for e in errors if not isinstance(e, GroupAborted)]
        raise (own or errors)[0]
    return results


# one gather of equal blocks into one buffer (renamed all_gather_single in
# later PyTorch, which warns on the old name)
_all_gather_single = (getattr(torch.distributed, "all_gather_single", None)
                      or torch.distributed.all_gather_into_tensor)


class DistGroup:
    """A ``torch.distributed`` group (``group``, None for the whole world)
    over the world ranks ``ranks``, in group-rank order; this process is
    member ``rank``. Every member holds the same bits after a collective.

    Over NCCL no collective waits for the host, so a captured CUDA graph
    holds them (``train.EpochReplay``); every communicator must exist
    before the capture, which the replay's eager warm-up of each kind of
    step sees to. Gloo gathers host memory only: a card's tensor is
    gathered through the host (gloo on cards is the rehearsal of several
    ranks on one card), and a gloo collective on a card's tensor raises
    inside a capture instead of breaking it."""

    def __init__(self, ranks: Sequence[int], group=None) -> None:
        self.ranks = list(ranks)
        self.group = group
        self.size = len(self.ranks)
        self.rank = self.ranks.index(torch.distributed.get_rank())
        self.backend = torch.distributed.get_backend(group)

    def _through_host(self, x: torch.Tensor) -> bool:
        """Whether a collective on ``x`` waits for the host (gloo on a card's
        tensor); raises when a CUDA graph is being captured."""
        if not (x.is_cuda and self.backend == "gloo"):
            return False
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a gloo collective on a card's tensor waits for the host, so a CUDA graph "
                "cannot hold it: capture the step over NCCL, one rank per card "
                "(parallel.mesh.check_dispatch)")
        return True

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        self._through_host(x)
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The members' ``x`` concatenated along ``dim`` in rank order: one
        gather into a single buffer of the blocks in rank order, then the
        member axis moved next to ``dim`` and merged into it."""
        if self._through_host(x):
            return self.all_gather(x.cpu(), dim).to(x.device)
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        _all_gather_single(out, x, group=self.group)
        out = out.view(self.size, *x.shape)
        dim = dim % x.dim()
        shape = (*x.shape[:dim], self.size * x.shape[dim], *x.shape[dim + 1:])
        return out.movedim(0, dim).reshape(shape)

    def mean_(self, tensors: list[torch.Tensor]) -> None:
        """Each tensor replaced in place by its mean over the members: one
        all-reduce per dtype over the tensors flattened together."""
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            self._through_host(t)
            by_dtype.setdefault(t.dtype, []).append(t)
        for same in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in same])
            torch.distributed.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            offset = 0
            for t in same:
                t.copy_(flat[offset : offset + t.numel()].view_as(t))
                offset += t.numel()

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed in place over the members."""
        self._through_host(x)
        torch.distributed.all_reduce(x, group=self.group)
        return x


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The members' ``x`` summed in f32, in ``x``'s dtype."""
    return group.all_reduce_sum(x.float()).to(x.dtype)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            grad = _sum_f32(grad, ctx.group)
        return _block(grad, ctx.group, ctx.dim).contiguous(), None, None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; under autograd its gradient is summed over ``group``."""
    if group.size == 1 or not _recorded(x):
        return x
    return _Enter.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The members' ``x`` summed (``group.all_reduce_sum``); the gradient
    passes to each member unchanged."""
    if group.size == 1:
        return x
    if not _recorded(x):
        return group.all_reduce_sum(x)
    return _ReduceSum.apply(x, group)


def gather(x: torch.Tensor, group, dim: int, summed: bool = True) -> torch.Tensor:
    """The members' blocks ``x`` concatenated along ``dim``
    (``group.all_gather``). Under autograd this member's block of the
    gradient comes back, summed over ``group`` first with ``summed``, as it
    is without."""
    if group.size == 1:
        return x
    if not _recorded(x):
        return group.all_gather(x, dim)
    return _Gather.apply(x, group, dim, summed)
