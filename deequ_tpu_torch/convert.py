"""Carry analyzer states across between the JAX reference package
(``deequ_tpu``) and this port.

A reference state travels as its class name and its leaves as numpy
arrays in flax field order — what ``jax.tree_util.tree_leaves(state)``
gives. The port's states keep the reference's class names and field order,
so leaf i of one is field i of the other. A run can fold its first batches
in the reference, carry the state over with :func:`from_reference`, and
fold the rest here (or back with :func:`to_reference`); nothing of the
reference package is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .analyzers import states as S
from .config import DeviceLike

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
        S.ApproxCountDistinctState,
        S.FrequencyCountsState,
    )
}


def _leaf_dtypes(cls) -> Tuple[torch.dtype, ...]:
    """Leaf dtypes of a state class, in field order (from its identity)."""
    init = cls.init(0, "cpu") if cls is S.FrequencyCountsState else cls.init("cpu")
    return tuple(leaf.dtype for leaf in S.leaves(init))


def from_reference(class_name: str, leaves: Sequence[np.ndarray], device: DeviceLike = "cpu"):
    """The port's state equal to the reference state ``class_name`` with
    these leaves. Values are copied bit for bit; a leaf whose dtype does
    not match the field's raises (no silent casts)."""
    cls = STATE_CLASSES.get(class_name)
    if cls is None:
        raise NotImplementedError(f"state {class_name} is not carried by this port")
    dtypes = _leaf_dtypes(cls)
    if len(leaves) != len(dtypes):
        raise ValueError(f"{class_name} has {len(dtypes)} leaves, got {len(leaves)}")
    tensors = []
    for i, (leaf, dtype) in enumerate(zip(leaves, dtypes)):
        arr = np.asarray(leaf)
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.dtype != dtype:
            raise TypeError(f"{class_name} leaf {i}: expected {dtype}, got {arr.dtype}")
        tensors.append(t.to(device))
    return cls(*tensors)


def to_reference(state) -> Tuple[str, List[np.ndarray]]:
    """``(class_name, leaves)`` of a port state, leaves as host numpy
    arrays in field order — what the reference's state class takes back
    as ``cls(*leaves)``."""
    name = type(state).__name__
    if name not in STATE_CLASSES:
        raise NotImplementedError(f"state {name} is not carried by this port")
    return name, [
        getattr(state, f.name).detach().cpu().numpy() for f in dataclasses.fields(state)
    ]
