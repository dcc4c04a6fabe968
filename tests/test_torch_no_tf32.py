"""``models.base.no_tf32`` under threads: the TF32 flags are process-global,
and a server runs f32 forwards on several threads at once (the
micro-batcher's and the streaming batcher's). Two threads interleave their
scopes through events: A opens, B opens, A closes while B's scope is still
open, then B closes. Inside each scope both flags must read False, B's
included after A has left; once both have left the flags are the caller's.
The flags are readable and settable without a card.
"""

from __future__ import annotations

import threading

import pytest
import torch

from segma_tpu_torch.models.base import ieee_f32, no_tf32


def _flags() -> tuple[bool, bool]:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def caller_flags():
    """TF32 on for both, as a caller may set them; restored afterwards."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield (True, True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("scope", ["no_tf32", "ieee_f32"])
def test_overlapping_scopes_on_two_threads(caller_flags, scope):
    enter = no_tf32 if scope == "no_tf32" else (lambda: ieee_f32(torch.float32))
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen: dict[str, list] = {"a": [], "b": []}
    errors: list = []

    def a() -> None:
        try:
            with enter():
                a_in.set()
                seen["a"].append(_flags())
                assert b_in.wait(10)
                seen["a"].append(_flags())
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            a_in.set()
            a_out.set()

    def b() -> None:
        try:
            assert a_in.wait(10)
            with enter():
                b_in.set()
                seen["b"].append(_flags())
                assert a_out.wait(10)  # A has left; B's f32 work goes on
                seen["b"].append(_flags())
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            b_in.set()

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not errors, errors
    assert seen["a"] == [(False, False)] * 2
    assert seen["b"] == [(False, False)] * 2, "TF32 came back on inside B's open scope"
    assert _flags() == caller_flags


def test_nested_scopes_restore_once(caller_flags):
    with no_tf32():
        with no_tf32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == caller_flags
    torch.backends.cudnn.allow_tf32 = False  # a caller's other choice is kept too
    with no_tf32():
        pass
    assert _flags() == (True, False)
    with ieee_f32(torch.bfloat16):  # not f32: no change
        assert _flags() == (True, False)


def test_many_threads_never_see_tf32(caller_flags):
    """Eight threads open and close scopes at random overlaps: no thread
    ever reads a TF32 flag on inside its scope."""
    bad: list = []
    start = threading.Barrier(8)

    def worker(k: int) -> None:
        start.wait()
        for i in range(200):
            with no_tf32():
                if _flags() != (False, False):
                    bad.append((k, i))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not bad, bad[:5]
    assert _flags() == caller_flags
