"""Seeded violation for the span-kind registry check: a span opened with
a kind invented at the call site — it renders, then silently falls out
of every kind-keyed view. The ``np.argsort(kind="stable")`` call is the
false-positive control: a ``kind=`` keyword on someone else's API must
NOT fire."""

from deequ_tpu_torch.observability import trace as _trace


def do_work(values) -> None:
    import numpy as np

    order = np.argsort(values, kind="stable")  # not ours: must not fire
    with _trace.span("fixture_work", kind="freestyle_kind", n=len(order)):
        pass
