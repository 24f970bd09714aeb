"""K8 ``state_fold``'s host work list (``FoldPlan``) and its cache, on the
CPU: the items a launch walks cover every column of every slot exactly
once, within the span width; equal slot tuples share one plan; bad slots
raise as the slot check always did. The kernel that walks the items is
held against its plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 2 and 9)."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.kernels.state_fold as K
from deequ_tpu_torch.analyzers.base import pack_states
from deequ_tpu_torch.kernels.state_fold import (
    ADD_F64,
    ADD_I64,
    COMOMENTS,
    GROUP_WIDTH,
    KIND_MATRIX,
    MAX,
    MAX_I32,
    MAX_SHARDS,
    MIN,
    MOMENTS,
    SPAN,
    FoldSlot,
    butterfly_span,
    fold_plan,
    state_fold,
)


def _widths(slots):
    widths = [0, 0, 0]
    for s in slots:
        m = KIND_MATRIX[s.kind]
        widths[m] = max(widths[m], s.offset + s.width)
    return tuple(widths)


def _every_kind_slots():
    mats, slots, _ = pack_states([states for _, states in chip_smoke.carry_groups(T, 2, 0)])
    return slots


LAYOUTS = {
    "elementwise": [FoldSlot(ADD_I64, 0, 3), FoldSlot(ADD_F64, 0, 2), FoldSlot(MIN, 2, 1),
                    FoldSlot(MAX, 3, 700), FoldSlot(MAX_I32, 0, 512), FoldSlot(ADD_I64, 3, 257)],
    "moments": [FoldSlot(MOMENTS, 3 * j) for j in range(5)],
    "co-moments": [FoldSlot(COMOMENTS, 0), FoldSlot(MOMENTS, 6), FoldSlot(COMOMENTS, 9)],
    "65,536 columns": [FoldSlot(ADD_I64, 0, 1 << 16), FoldSlot(ADD_I64, 1 << 16, 1)],
    "every kind": _every_kind_slots(),
}
SPANS = [SPAN] + [butterfly_span(n) for n in (2, 3, 8, 100, MAX_SHARDS)]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_items_cover_every_column_exactly_once(layout, span):
    slots = LAYOUTS[layout]
    widths = _widths(slots)
    owner = [[None] * w for w in widths]
    for kind, offset, cols in fold_plan(slots, widths).items(span):
        width = GROUP_WIDTH.get(kind)
        if width is not None:
            assert cols == 1
            columns = range(offset, offset + width)
        else:
            columns = range(offset, offset + cols)
        for c in columns:
            assert owner[KIND_MATRIX[kind]][c] is None, (kind, c)
            owner[KIND_MATRIX[kind]][c] = kind
    for m, column_kinds in enumerate(owner):
        assert None not in column_kinds, m
    for s in slots:
        assert set(owner[KIND_MATRIX[s.kind]][s.offset:s.offset + s.width]) == {s.kind}


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_items_stay_within_the_span_width(layout, span):
    slots = LAYOUTS[layout]
    items = fold_plan(slots, _widths(slots)).items(span)
    assert all(1 <= cols <= span for _, _, cols in items)
    # an elementwise slot splits into as few items as the span allows
    expected = sum(1 if s.kind in GROUP_WIDTH else -(-s.length // span) for s in slots)
    assert len(items) == expected


def test_the_65536_column_slot_fills_many_blocks():
    items = fold_plan(LAYOUTS["65,536 columns"], (0, (1 << 16) + 1, 0)).items()
    assert len(items) == (1 << 16) // SPAN + 1
    assert [i[1] for i in items[:3]] == [0, SPAN, 2 * SPAN]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 7, 8, 16, 64, 255, 256, 512, 513, MAX_SHARDS])
def test_butterfly_span_fits_the_block(n_dev):
    span = butterfly_span(n_dev)
    assert 1 <= span <= SPAN
    # every shard's accumulator of an item on the block's 256 threads, at
    # most four a thread
    assert n_dev * span <= 4 * 256
    assert n_dev * span >= min(n_dev, 256)


def test_equal_slot_tuples_share_the_plan():
    slots = LAYOUTS["every kind"]
    widths = _widths(slots)
    plan = fold_plan(slots, widths)
    copies = [FoldSlot(s.kind, s.offset, s.length) for s in slots]
    assert fold_plan(copies, widths) is plan
    assert fold_plan(tuple(copies), list(widths)) is plan
    moved = LAYOUTS["moments"]
    assert fold_plan(moved, _widths(moved)) is not plan


def test_a_different_layout_gets_a_new_plan():
    a = [FoldSlot(ADD_I64, 0, 4), FoldSlot(MAX_I32, 0, 2)]
    b = [FoldSlot(ADD_I64, 0, 2), FoldSlot(ADD_I64, 2, 2), FoldSlot(MAX_I32, 0, 2)]
    pa, pb = fold_plan(a, (0, 4, 2)), fold_plan(b, (0, 4, 2))
    assert pa is not pb
    assert pa.items() == [(ADD_I64, 0, 4), (MAX_I32, 0, 2)]
    assert pb.items() == [(ADD_I64, 0, 2), (ADD_I64, 2, 2), (MAX_I32, 0, 2)]


def test_device_items_are_built_once_per_device_and_span():
    slots = LAYOUTS["elementwise"]
    plan = fold_plan(slots, _widths(slots))
    cpu = torch.device("cpu")
    items = plan.device_items(cpu)
    assert plan.device_items(cpu) is items
    assert items.dtype == torch.int32 and items.is_contiguous()
    assert items.tolist() == [list(i) for i in plan.items()]
    narrow = plan.device_items(cpu, butterfly_span(8))
    assert narrow is not items and narrow.tolist() == [list(i) for i in plan.items(64)]


def test_a_repeat_call_checks_and_builds_nothing(monkeypatch):
    mats, slots, _ = pack_states([states for _, states in chip_smoke.fold_groups(T, 3, 21)])
    fresh = [FoldSlot(s.kind, s.offset, s.length) for s in slots]
    calls = []
    real = K._check_slots
    monkeypatch.setattr(K, "_check_slots", lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(K, "_PLANS", {})
    first = state_fold(*mats, fresh)
    again = state_fold(*mats, [FoldSlot(s.kind, s.offset, s.length) for s in slots])
    assert len(calls) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, again))


BAD = {
    "no slot": ([], ValueError, "at least one slot"),
    "unknown kind": ([FoldSlot(9, 0, 3)], ValueError, "bad slot"),
    "empty slot": ([FoldSlot(ADD_I64, 0, 0), FoldSlot(ADD_I64, 0, 3)], ValueError, "bad slot"),
    "negative offset": ([FoldSlot(ADD_I64, -1, 4)], ValueError, "runs past"),
    "past the matrix": ([FoldSlot(ADD_I64, 0, 4)], ValueError, "runs past"),
    "a gap": ([FoldSlot(ADD_I64, 0, 1), FoldSlot(ADD_I64, 2, 1)], ValueError, "exactly one"),
    "an overlap": ([FoldSlot(ADD_I64, 0, 2), FoldSlot(ADD_I64, 1, 2)], ValueError, "exactly one"),
    "a column nobody folds": ([FoldSlot(ADD_I64, 0, 2)], ValueError, "exactly one"),
    "a moments group past the matrix": ([FoldSlot(ADD_I64, 0, 3), FoldSlot(MOMENTS, 0)],
                                        ValueError, "runs past"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_slots_raise_as_the_slot_check_does(case):
    slots, error, message = BAD[case]
    f = torch.zeros((2, 0), dtype=torch.float64)
    i = torch.zeros((2, 3), dtype=torch.int64)
    r = torch.zeros((2, 0), dtype=torch.int32)
    with pytest.raises(error, match=message):
        K._check_slots((0, 3, 0), slots)
    # the wrapper raises the same, every time: a bad layout is never cached
    for _ in range(2):
        with pytest.raises(error, match=message):
            state_fold(f, i, r, slots)
    with pytest.raises(error, match=message):
        K.state_fold_carry([f[0], i[0], r[0]], [f, i, r], slots)
    with pytest.raises(error, match=message):
        K.state_fold_butterfly(f, i, r, slots, 2)
