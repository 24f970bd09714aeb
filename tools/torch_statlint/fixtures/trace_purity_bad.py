"""Seeded violations for the fold-body purity check: a state class whose
merge reads the wall clock (two runs over the same data would fold
differently), a helper it calls that fetches to the host, and a
ScanShareable fold body that syncs the card by taking ``float`` of a
tensor in the middle of a pass."""

import time
from dataclasses import dataclass

import torch


@dataclass
class FixtureState:
    total: torch.Tensor

    def merge(self, other: "FixtureState") -> "FixtureState":
        stamp = time.time()  # wall clock inside a fold
        return FixtureState(chained_helper(self.total + other.total) + stamp)


def chained_helper(total):
    return total.item()  # a device sync per fold


class FixtureAnalyzer(StandardScanShareableAnalyzer):  # noqa: F821
    def fold_slot(self, state, p):
        if float(p.sum()) > 0:  # a device sync per batch
            return state
        return state
