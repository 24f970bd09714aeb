"""Carry analyzer states across between the JAX reference package
(``deequ_tpu``) and this port.

A reference state travels as its class name and its leaves as numpy
arrays in flax field order — what ``jax.tree_util.tree_leaves(state)``
gives. The port's states keep the reference's class names and field order,
so leaf i of one is field i of the other (a static field, such as a KLL
sketch's size, is no leaf in either package). A run can fold its first batches
in the reference, carry the state over with :func:`from_reference`, and
fold the rest here (or back with :func:`to_reference`); nothing of the
reference package is imported. Frequency-table keys are uint64 in the
reference and int64 here: the two are views of the same bits. The exact
quantile mode's :class:`ExactQuantileState` is a host state in both
packages, not a pytree: its leaves are its float64 value chunks, as
``ExactQuantileState(tuple(leaves))`` takes them back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .analyzers import states as S
from .analyzers.sketches import ExactQuantileState
from .config import DeviceLike
from .ops.kll import kll_init

STATE_CLASSES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        S.NumMatches,
        S.NumMatchesAndCount,
        S.MeanState,
        S.SumState,
        S.MinState,
        S.MaxState,
        S.StandardDeviationState,
        S.CorrelationState,
        S.ApproxCountDistinctState,
        S.FrequencyCountsState,
        S.FrequencyTableState,
        S.DataTypeHistogram,
        S.KLLSketchState,
    )
}


def _identity(cls, leaves: Sequence[np.ndarray]):
    """An identity state of ``cls`` shaped like these leaves."""
    if cls is S.FrequencyCountsState:
        return cls.init(0, "cpu")
    if cls is S.FrequencyTableState:
        # table and buffer sizes ride the key leaves' shapes
        if len(leaves) != 9:
            raise ValueError(f"FrequencyTableState has 9 leaves, got {len(leaves)}")
        return cls.init(len(leaves[0]), len(leaves[3]), "cpu")
    if cls is S.KLLSketchState:
        # the sketch size is static in both packages: it rides the items'
        # shape, float32[L, 4k]
        shape = np.shape(leaves[0]) if len(leaves) else ()
        if len(shape) != 2 or shape[1] % 4:
            raise ValueError(f"KLLSketchState items must be float32[L, 4k], got shape {shape}")
        return kll_init(shape[1] // 4, shape[0])
    return cls.init("cpu")


def from_reference(class_name: str, leaves: Sequence[np.ndarray], device: DeviceLike = "cpu"):
    """The port's state equal to the reference state ``class_name`` with
    these leaves. Values are copied bit for bit; a leaf whose dtype does
    not match the field's raises (no silent casts). An accumulator or
    counter leaf may carry the other accumulator mode's dtype (float32 /
    int32 in a 64-bit process, float64 / int64 under ``DEEQU_TPU_NO_X64``)
    and keeps it, as the reference keeps a blob's leaves as written
    (``states.accepted_dtypes``; merges cast them, ``base.merge_operands``)."""
    if class_name == "ExactQuantileState":
        return _exact_from_reference(leaves)
    cls = STATE_CLASSES.get(class_name)
    if cls is None:
        raise NotImplementedError(f"state {class_name} is not carried by this port")
    identity = _identity(cls, leaves)
    dtypes = tuple(leaf.dtype for leaf in S.leaves(identity))
    if len(leaves) != len(dtypes):
        raise ValueError(f"{class_name} has {len(dtypes)} leaves, got {len(leaves)}")
    u64 = _u64_leaves(identity)
    names = [f.name for f in S.tensor_fields(identity)]
    tensors = []
    for i, (leaf, dtype) in enumerate(zip(leaves, dtypes)):
        arr = np.asarray(leaf)
        if i in u64 and arr.dtype == np.uint64:
            arr = arr.view(np.int64)  # the same bits
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.dtype not in S.accepted_dtypes(cls, names[i], dtype):
            raise TypeError(f"{class_name} leaf {i}: expected {dtype}, got {arr.dtype}")
        tensors.append(t.to(device))
    state = S.with_leaves(identity, tensors)
    if cls is S.FrequencyTableState:
        state = dataclasses.replace(state, fill=int(tensors[4]))
    return state


def _exact_from_reference(chunks: Sequence[np.ndarray]) -> ExactQuantileState:
    """The port's exact-quantile state holding copies of these chunks."""
    copied = []
    for i, chunk in enumerate(chunks):
        arr = np.asarray(chunk)
        if arr.dtype != np.float64 or arr.ndim != 1:
            raise TypeError(f"ExactQuantileState chunk {i}: expected float64[n], got "
                            f"{arr.dtype}{list(arr.shape)}")
        copied.append(arr.copy())
    return ExactQuantileState(tuple(copied))


def _u64_leaves(state) -> set:
    """Leaf positions that hold uint64 keys in the reference (int64 bits
    here)."""
    names = getattr(type(state), "KEY_FIELDS", ())
    return {i for i, f in enumerate(S.tensor_fields(state)) if f.name in names}


def to_reference(state) -> Tuple[str, List[np.ndarray]]:
    """``(class_name, leaves)`` of a port state, leaves as host numpy
    arrays in field order — what the reference's state class takes back
    as ``cls(*leaves)``."""
    name = type(state).__name__
    if isinstance(state, ExactQuantileState):
        return name, [chunk.copy() for chunk in state.chunks]
    if name not in STATE_CLASSES:
        raise NotImplementedError(f"state {name} is not carried by this port")
    u64 = _u64_leaves(state)
    return name, [
        leaf.detach().cpu().numpy().view(np.uint64) if i in u64 else leaf.detach().cpu().numpy()
        for i, leaf in enumerate(S.leaves(state))
    ]


def from_reference_stacked(class_name: str, leaves: Sequence[np.ndarray],
                           device: DeviceLike = "cpu"):
    """The port's stacked per-shard state equal to the reference's stacked
    state (every leaf with a leading shard axis, as the reference's mesh
    functions take and return them): shard by shard :func:`from_reference`,
    stacked on ``device``."""
    arrays = [np.asarray(leaf) for leaf in leaves]
    shards = int(arrays[0].shape[0]) if arrays else 0
    per_shard = [from_reference(class_name, [a[j] for a in arrays], device)
                 for j in range(shards)]
    return S.with_leaves(per_shard[0], [torch.stack(column) for column in
                                        zip(*(S.leaves(st) for st in per_shard))])


def to_reference_stacked(state) -> Tuple[str, List[np.ndarray]]:
    """``(class_name, leaves)`` of a stacked per-shard port state: each
    leaf a host numpy array with the leading shard axis."""
    shards = int(S.leaves(state)[0].shape[0])
    per_shard = [to_reference(S.with_leaves(state, [leaf[j] for leaf in S.leaves(state)]))[1]
                 for j in range(shards)]
    return type(state).__name__, [np.stack(column) for column in zip(*per_shard)]
