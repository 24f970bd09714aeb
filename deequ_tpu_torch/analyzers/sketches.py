"""Sketch-backed analyzers: approximate distinct counts.

The reference implements HLL++ as a Spark ImperativeAggregate with per-row
imperative buffer updates (`analyzers/catalyst/StatefulHyperloglogPlus.
scala`); here the host hashes and packs each row once (``ops/hll.py``) and
the ``hll_registers`` kernel folds a whole batch into the registers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from ..data import Schema
from ..expr import Predicate
from ..kernels.hll_registers import hll_registers
from ..metrics import Entity
from .base import (
    FeatureSpec,
    Preconditions,
    StandardScanShareableAnalyzer,
    hll_feature,
    mask_feature,
    predicate_feature,
    rows_feature,
)
from .states import ApproxCountDistinctState


@dataclass(frozen=True)
class ApproxCountDistinct(StandardScanShareableAnalyzer[ApproxCountDistinctState]):
    """Approximate distinct count via HLL++ (relativeSD=0.05, p=9, 512
    registers), matching the reference's accuracy envelope and hash (xxhash64
    seed 42) bit-for-bit (reference `analyzers/ApproxCountDistinct.scala:
    26-64`, kernel `analyzers/catalyst/StatefulHyperloglogPlus.scala:89-139`).
    Merge is an elementwise register max."""

    column: str = ""
    where: Optional[Predicate] = None
    name: str = field(default="ApproxCountDistinct", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column)]

    def feature_specs(self) -> List[FeatureSpec]:
        specs = [rows_feature(), mask_feature(self.column), hll_feature(self.column)]
        if self.where is not None:
            specs.append(predicate_feature(self.where))
        return specs

    def init_state(self, device) -> ApproxCountDistinctState:
        return ApproxCountDistinctState.init(device)

    def update(self, state: ApproxCountDistinctState, features) -> ApproxCountDistinctState:
        # wire format: uint16 (idx << 6) | pw, 2 bytes/row; nulls arrive
        # packed as 0, which never wins a register max
        key = self._where_key()
        batch_regs = hll_registers(
            features[hll_feature(self.column).key],
            features["rows"],
            None if key is None else features[key],
            features[mask_feature(self.column).key],
        )
        return ApproxCountDistinctState(torch.maximum(state.registers, batch_regs))

    def merge(self, a, b):
        return a.merge(b)

    def metric_value(self, state) -> float:
        # on empty data the estimate is 0.0, matching the reference where the
        # HLL agg buffer always exists (`ApproxCountDistinct.scala:49-56`)
        return state.metric_value()
