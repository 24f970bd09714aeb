"""Seeded violations for the lock-discipline check.

1. ``CommitLedger`` reproduces the cross-key commit-inversion BUG
   SHAPE: a shared field written both under its owning lock and on a path
   that provably does not hold it (the class of race behind three of the
   scheduler's flake fixes).
2. ``AccountA``/``AccountB`` acquire each other's locks in opposite
   orders — the textbook acquisition-order deadlock cycle.
"""

import threading


class CommitLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self._committed = 0

    def commit(self, n):
        with self._lock:
            self._committed += n

    def commit_unlocked(self, n):
        # the commit-inversion shape: same shared field, no owning lock held
        self._committed += n


class AccountA:
    def __init__(self, peer):
        self._lock = threading.Lock()
        self.peer = peer

    def transfer_from_a(self):
        with self._lock:
            self.peer.credit_b()

    def credit_a(self):
        with self._lock:
            pass


class AccountB:
    def __init__(self, peer):
        self._lock = threading.Lock()
        self.peer = peer

    def credit_b(self):
        with self._lock:
            self.peer.credit_a()
