"""The collectives of a tensor- or sequence-parallel group.

The layers that split their work over ``model`` (heads, MLP features) or
``seq`` (the Whisper encoder's time axis) call a group through four names:
``rank``, ``size``, ``all_reduce_sum(x)`` and ``all_gather(x, dim)``. They
are written once against that interface:

- ``SOLO``, the group of one: the identity, so a module outside a mesh runs
  as it always did, bit for bit;
- ``ThreadGroup``, an in-process rendezvous of members that each run on a
  thread of their own (serving: one process drives every card's members);
  ``ThreadGroup.member(rank)`` is the interface one member calls.

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
