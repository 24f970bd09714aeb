"""The KLL quantile sketch: its state and the two kernels that update it.

The state is the JAX reference's (deequ_tpu/ops/kll.py): levelled
compactors in one ``float32[L, 4k]`` array, +inf past each level's size,
with ``int32[L]`` sizes and compaction parities, an update counter, the
exact count and the float64 min and max of the folded values. Level ``l``
holds items of weight ``2^l``; every level has capacity ``k`` before it
compacts (4k is the worst-case occupancy of a merge).

A batch update runs two kernels and reads nothing back to the host:
``kll_sample`` (K4) pre-collapses the batch into at most ``k`` items of
weight ``2^h`` (sort, stride-``2^h`` subsampling), and ``kll_compact`` (K5)
appends them at level ``h`` and compacts upward while a level overflows.
A merge is K5's second mode; the host ingest tier's sampled blocks (at
most ``2k`` items each, sampled on the host by the native library) enter
through its third, :func:`kll_ingest_sampled`. All give the reference's
state bit for bit, items' layout included.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from ..config import ACC_DTYPE, COUNT_DTYPE, DeviceLike
from ..kernels.kll_compact import kll_compact_ingest, kll_compact_merge, kll_compact_update
from ..kernels.kll_sample import kll_sample

#: sketch items are float32, as in the reference (whose module docstring
#: gives the reasons); min, max and count stay float64 and int64
ITEM_DTYPE = torch.float32

#: defaults matching the reference (`analyzers/KLLSketch.scala:172-176`)
DEFAULT_SKETCH_SIZE = 2048
DEFAULT_SHRINKING_FACTOR = 0.64
MAXIMUM_ALLOWED_DETAIL_BINS = 100

#: number of levels: 32 cover k * 2^31 rows before the top level saturates
MAX_LEVELS = 32


@dataclass
class KLLSketchState:
    """Mergeable sketch state plus global min/max and exact count (the
    reference's ``KLLSketchState``, same fields in the same order)."""

    items: torch.Tensor   # float32[L, 4k], +inf beyond sizes[l]
    sizes: torch.Tensor   # int32[L]
    parity: torch.Tensor  # int32[L], alternating compaction offsets
    ticks: torch.Tensor   # int32, update counter (turns the sample offset)
    count: torch.Tensor   # int64, exact number of folded values
    g_min: torch.Tensor   # float64
    g_max: torch.Tensor   # float64

    #: a static field: not a tensor, not fetched, not carried as a leaf
    sketch_size: int = field(default=DEFAULT_SKETCH_SIZE, metadata={"static": True})

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.items, self.sizes, self.parity, self.ticks, self.count,
                self.g_min, self.g_max)

    def merge(self, other: "KLLSketchState") -> "KLLSketchState":
        return kll_merge(self, other)


def kll_init(
    sketch_size: int = DEFAULT_SKETCH_SIZE, levels: int = MAX_LEVELS, device: DeviceLike = "cpu"
) -> KLLSketchState:
    k = int(sketch_size)
    return KLLSketchState(
        items=torch.full((levels, 4 * k), float("inf"), dtype=ITEM_DTYPE, device=device),
        sizes=torch.zeros(levels, dtype=torch.int32, device=device),
        parity=torch.zeros(levels, dtype=torch.int32, device=device),
        ticks=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=COUNT_DTYPE, device=device),
        g_min=torch.tensor(float("inf"), dtype=ACC_DTYPE, device=device),
        g_max=torch.tensor(float("-inf"), dtype=ACC_DTYPE, device=device),
        sketch_size=k,
    )


def _state(leaves, k: int) -> KLLSketchState:
    return KLLSketchState(*leaves, sketch_size=k)


def kll_update(
    state: KLLSketchState,
    values: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor] = None,
    present: Optional[torch.Tensor] = None,
) -> KLLSketchState:
    """Fold one batch into the sketch (the reference's
    ``kll_update(state, values, rows & where & present)``). NaN values are
    left out. K4 then K5; on the CPU their plain versions."""
    k = state.sketch_size
    sample = kll_sample(values, rows, where, present, state.ticks, k)
    return _state(kll_compact_update(state.tensors(), sample, k), k)


def kll_ingest_sampled(
    state: KLLSketchState, samples, m: int, h: int, nv: int, g_min: float, g_max: float,
) -> KLLSketchState:
    """Fold one host-sampled block into the sketch (the reference's
    ``kll_ingest_sampled``, deequ_tpu/ops/kll.py:284): ``samples`` is an
    ascending, +inf-padded float64 vector of the sketch's row width holding
    ``m`` items of weight ``2^h``, covering ``nv`` values whose min and max
    are ``g_min`` and ``g_max``. Its items are clipped to the finite float32
    range and rounded to float32. K5's ingest entry on a stack of one
    sketch and one block; the state passed in is left as it was."""
    k = state.sketch_size
    dev = state.items.device
    sketches = [leaf.clone().reshape(1, *leaf.shape) for leaf in state.tensors()]
    block = [
        torch.as_tensor(samples, dtype=ACC_DTYPE).to(dev).reshape(1, 1, -1).contiguous(),
        *(torch.tensor([[x]], dtype=dtype, device=dev) for x, dtype in (
            (m, torch.int32), (h, torch.int32), (nv, COUNT_DTYPE), (g_min, ACC_DTYPE),
            (g_max, ACC_DTYPE))),
    ]
    kll_compact_ingest(sketches, block, k)
    return _state([leaf[0] for leaf in sketches], k)


def kll_merge(a: KLLSketchState, b: KLLSketchState) -> KLLSketchState:
    """Semigroup sum: concatenate per-level buffers and re-compact
    (reference ``kll_merge``; `analyzers/QuantileNonSample.scala:215-230`)."""
    if a.sketch_size != b.sketch_size:
        raise ValueError("cannot merge sketches of different size")
    return _state(kll_compact_merge(a.tensors(), b.tensors(), a.sketch_size), a.sketch_size)


def compactor_buffers(state: KLLSketchState) -> List[List[float]]:
    """Per-level item lists (weights 2^level), each sorted — the
    ``getCompactorItems`` payload of ``BucketDistribution.data`` (reference
    `analyzers/KLLSketch.scala:150`)."""
    items = state.items.cpu().numpy()
    sizes = state.sizes.cpu().numpy()
    top = 0
    for lvl in range(items.shape[0]):
        if sizes[lvl] > 0:
            top = lvl + 1
    return [sorted(items[lvl][: sizes[lvl]].tolist()) for lvl in range(max(top, 1))]

