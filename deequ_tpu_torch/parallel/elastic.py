"""Elastic degraded-mesh execution: a sharded fold that survives shard loss
(the reference's ``deequ_tpu/parallel/elastic.py``).

The host tier over a mesh folds per-shard algebraic states: each shard's
state covers exactly the batch partials its shard folded, and states merge
by construction. So a lost shard costs only its own batches:

1. **Detection**: a fold raising :class:`ShardLossError` (an injected
   ``mesh_loss`` or ``shard_stall`` fault, a failed device, a heartbeat
   probe declaring a shard dead, ``health.py``) names the lost positions;
   a raw error that ``classify_failure`` reads as ``"device"`` (a CUDA
   error) on a mesh of more than one shard probes the shards and recovers
   the dead ones (shard 0 when no probe fails) as a shard loss.
2. **Salvage**: the surviving shards' states merge into one canonical
   state per analyzer, on the rebuilt mesh's first device
   (:func:`device_merge_states`), or on the host when no device is left
   (:func:`host_merge_states`, no device involved).
3. **Re-shard**: the mesh is rebuilt over the surviving devices at the
   next rung of the ladder (``DEEQU_TPU_MESH_LADDER``, default 8,4,2,1);
   the canonical merge becomes shard 0's state and the fold resumes. When
   no rung fits, the fold drops to **host mode**: the canonical states
   fold on the host from then on, so folded state is never lost. A mesh
   whose shards all lie on one card has no other device to go to: there
   the loss raises :class:`MeshExhaustedError` instead, and the run fails
   rather than finish on the host.
4. **Replay**: every fold records which batches each shard owns; the
   engine recomputes and re-folds exactly the lost shards' batches, so the
   final merge covers every batch once.

Checkpoints compose: the engine checkpoints the canonical merged states
(:meth:`ElasticMeshFold.canonical`), and :meth:`ElasticMeshFold.seed`
resumes them as shard 0's state, so a checkpoint taken on 8 shards resumes
on 4, on 1 or on the plain host tier.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..analyzers.states import leaves, with_leaves
from ..exceptions import MeshExhaustedError

_logger = logging.getLogger(__name__)

#: env var: comma-separated device counts the re-shard ladder walks after a
#: loss (e.g. "8,4,2,1"); unparseable values warn once and keep the default
MESH_LADDER_ENV = "DEEQU_TPU_MESH_LADDER"
DEFAULT_MESH_LADDER = (8, 4, 2, 1)

_ENV_WARNED = False


def mesh_ladder() -> Tuple[int, ...]:
    """The configured re-shard ladder, descending."""
    from ..utils import env_str

    raw = env_str(MESH_LADDER_ENV)
    if raw is None:
        return DEFAULT_MESH_LADDER
    try:
        rungs = tuple(sorted({int(p) for p in raw.split(",") if p.strip()}, reverse=True))
        if not rungs or any(r < 1 for r in rungs):
            raise ValueError(raw)
    except ValueError:
        global _ENV_WARNED
        if not _ENV_WARNED:
            _ENV_WARNED = True
            _logger.warning(
                "ignoring unparseable %s=%r (expected comma-separated positive device "
                "counts); keeping the default ladder %s",
                MESH_LADDER_ENV, raw, DEFAULT_MESH_LADDER,
            )
        return DEFAULT_MESH_LADDER
    return rungs


def next_rung(ladder: Sequence[int], survivors: int) -> Optional[int]:
    """The largest rung a mesh of ``survivors`` devices can fill, or None
    (the ladder is exhausted: host mode)."""
    fitting = [r for r in ladder if r <= survivors]
    return max(fitting) if fitting else None


def mesh_batch_quantum(n_dev: int, ladder: Optional[Sequence[int]] = None) -> int:
    """The multiple a mesh run's batch size rounds to: ``lcm(n_dev, the
    largest rung)``, the same for every rung of the (power-of-two) ladder,
    so batch boundaries stay put when the mesh shrinks."""
    rungs = mesh_ladder() if ladder is None else tuple(ladder)
    return math.lcm(max(1, int(n_dev)), max(rungs))


def _to_host(state):
    return with_leaves(state, [leaf.detach().cpu() for leaf in leaves(state)])


def host_merge_states(analyzers: Sequence[Any], shard_states: List[Tuple]) -> Tuple:
    """Merge per-shard states into one canonical state per analyzer with a
    left fold of each analyzer's merge on the host (no mesh, so it works
    while the mesh is broken). ``shard_states``: per shard a tuple of
    states, one per analyzer; none gives the identity states. The result
    lives on the CPU."""
    if not shard_states:
        return tuple(a.init_state(torch.device("cpu")) for a in analyzers)
    merged = []
    for i, a in enumerate(analyzers):
        acc = _to_host(shard_states[0][i])
        for shard in shard_states[1:]:
            acc = a.merge(acc, _to_host(shard[i]))
        merged.append(acc)
    return tuple(merged)


def device_merge_states(analyzers: Sequence[Any], shard_states: List[Tuple], device) -> Tuple:
    """:func:`host_merge_states` on ``device`` (a surviving card): the same
    left fold, as ``merge_states_batched_many`` runs it (one ``state_fold``
    launch, ``kll_compact``'s merge for a sketch)."""
    from ..analyzers.base import merge_states_batched_many

    if not shard_states:
        return tuple(a.init_state(device) for a in analyzers)
    return tuple(merge_states_batched_many(list(zip(analyzers, zip(*shard_states))), device))


def _one_card(devices: Sequence[torch.device]) -> bool:
    """Whether every shard of a mesh lies on one card."""
    return len(set(devices)) == 1 and devices[0].type == "cuda"


def stack_canonical_states(analyzers: Sequence[Any], canonical: Tuple, n_dev: int,
                           device=None) -> Tuple:
    """Canonical states stacked back into per-shard form for a fresh
    (perhaps smaller) mesh on ``device`` (the states' own when None):
    shard 0 carries the merge, shards 1..n-1 the identity."""
    out = []
    for a, state in zip(analyzers, canonical):
        dev = device if device is not None else leaves(state)[0].device
        ident = a.init_state(dev)
        out.append(with_leaves(state, [
            torch.cat([c.to(dev)[None],
                       i[None].expand((n_dev - 1,) + tuple(i.shape)).to(c.dtype)])
            for c, i in zip(leaves(state), leaves(ident))
        ]))
    return tuple(out)


def salvage_stacked_states(analyzers: Sequence[Any], stacked: Tuple, lost: Sequence[int],
                           device=None) -> Tuple[List[Tuple], List[int]]:
    """The surviving shards of stacked per-shard states, on ``device`` (the
    host when None): ``(shard_states, salvaged_positions)``, one tuple of
    states per salvaged shard in ascending position. A shard whose copy
    fails counts as lost too; salvage never raises for a copyable
    subset."""
    target = torch.device("cpu") if device is None else torch.device(device)
    lost_set = {int(i) for i in lost}
    first = leaves(stacked[0]) if stacked else []
    n_shards = int(first[0].shape[0]) if first else 0
    shard_states: List[Tuple] = []
    salvaged: List[int] = []
    for pos in range(n_shards):
        if pos in lost_set:
            continue
        try:
            state = tuple(with_leaves(tree, [leaf[pos].to(target) for leaf in leaves(tree)])
                          for tree in stacked)
        except Exception as exc:  # noqa: BLE001 - a dead buffer is a lost shard
            _logger.warning("shard %d unsalvageable (%s); treating it as lost", pos, exc)
            continue
        shard_states.append(state)
        salvaged.append(pos)
    return shard_states, salvaged


#: subscribers told which shards a salvage declared lost (the fleet
#: scheduler re-packs tenants off them); advisory: a raising listener is
#: logged and never breaks the recovery
_SHARD_LOSS_LISTENERS: List[Any] = []


class LostShards(list):
    """What a shard-loss listener hears: the lost shards' devices (a list,
    as the reference's listeners hear them) and, for a fleet's sub-mesh,
    their positions in that fleet's device table (``fleet_positions``,
    with the fleet's ``fleet_token``; both None for any other mesh)."""

    def __init__(self, devices: Sequence, fleet_positions: Optional[Sequence[int]] = None,
                 fleet_token: Any = None):
        super().__init__(devices)
        self.fleet_positions = None if fleet_positions is None else list(fleet_positions)
        self.fleet_token = fleet_token


def _lost_shards(mesh, lost: Sequence[int]) -> LostShards:
    """The report of the shards at mesh positions ``lost``."""
    lost = [i for i in lost if 0 <= i < mesh.size]
    positions = mesh.fleet_positions
    return LostShards([mesh.devices[i] for i in lost],
                      None if positions is None else [positions[i] for i in lost],
                      mesh.fleet_token)


def add_shard_loss_listener(fn) -> None:
    if fn not in _SHARD_LOSS_LISTENERS:
        _SHARD_LOSS_LISTENERS.append(fn)


def remove_shard_loss_listener(fn) -> None:
    try:
        _SHARD_LOSS_LISTENERS.remove(fn)
    except ValueError:
        pass


def _notify_shard_loss(lost: LostShards) -> None:
    for fn in list(_SHARD_LOSS_LISTENERS):
        try:
            fn(lost)
        except Exception:  # noqa: BLE001 - listeners are advisory
            _logger.warning("shard-loss listener failed", exc_info=True)


class ElasticMeshFold:
    """A shard-loss-tolerant wrapper around ``sharded_ingest_fold``.

    The engine feeds it stacked chunk partials as it would feed the raw
    fold; the wrapper owns the per-shard states, the ledger of which batch
    each shard folded, the heartbeat gate and the recovery (salvage,
    re-shard, host mode). After the last chunk the engine replays
    :meth:`take_lost_batches`, then calls :meth:`finish` for the final
    collective merge."""

    def __init__(self, analyzers: Sequence[Any], mesh, monitor=None,
                 ladder: Optional[Sequence[int]] = None,
                 heartbeat_s: Optional[float] = None):
        from . import stack_identity_states
        from .health import HeartbeatGate

        self.analyzers = tuple(analyzers)
        self.mesh = mesh
        self.monitor = monitor
        self.ladder = tuple(ladder) if ladder is not None else mesh_ladder()
        self.host_mode = False
        self.reshards = 0
        self.states = stack_identity_states(self.analyzers, mesh.size, mesh.home)
        #: per mesh position: the global batch indices folded into its state
        self._owned: List[Set[int]] = [set() for _ in range(mesh.size)]
        #: batches lost with dead shards, pending recompute and re-fold
        self._lost_batches: Set[int] = set()
        self._gate = HeartbeatGate(heartbeat_s)

    @property
    def n_dev(self) -> int:
        return 1 if self.host_mode else self.mesh.size

    @property
    def pending_replay(self) -> bool:
        return bool(self._lost_batches)

    def take_lost_batches(self) -> List[int]:
        """Pop the batches lost with dead shards (the engine replays them)."""
        todo = sorted(self._lost_batches)
        self._lost_batches.clear()
        return todo

    def seed(self, canonical: Tuple, folded_batches: int) -> None:
        """Resume from a checkpoint's canonical states, which cover batches
        ``[0, folded_batches)`` (the reference's ``ElasticMeshFold.seed``,
        deequ_tpu/parallel/elastic.py:270). The merge becomes shard 0's
        state on a mesh of any rung, the other shards start from the
        identity, and its batches enter shard 0's ledger, so a later loss
        of shard 0 replays them instead of dropping the resumed history."""
        if self.host_mode:
            self.states = tuple(canonical)
        else:
            self.states = stack_canonical_states(self.analyzers, tuple(canonical), self.n_dev,
                                                 self.mesh.home)
        self._owned = [set() for _ in range(self.n_dev)]
        self._owned[0] = set(range(int(folded_batches)))

    def fold(self, stacked: Tuple, flags, batch_indices: Sequence[int]):
        """Fold one chunk of stacked partials. ``batch_indices`` names the
        global batch behind each real slot (slot j real iff ``flags[j]``).
        A shard loss is survived inside: the chunk retries on the rebuilt
        mesh, or folds on the host once the ladder is exhausted."""
        from ..exceptions import ShardLossError, ShardStallError
        from . import sharded_ingest_fold

        flags = np.asarray(flags, dtype=bool)
        batch_indices = [int(i) for i in batch_indices]
        while not self.host_mode:
            if self._gate.due():
                dead = self._gate.check(self.mesh)
                if dead:
                    self._recover(ShardStallError(dead, "heartbeat",
                                                  detail="shard heartbeat missed"))
                    continue
            try:
                self.states = sharded_ingest_fold(self.analyzers, self.mesh, self.states,
                                                  stacked, flags)
            except ShardLossError as exc:
                self._recover(exc)
                continue
            except Exception as exc:  # noqa: BLE001 - classified below
                from ..reliability.isolation import classify_failure

                if classify_failure(exc) != "device" or self.n_dev <= 1:
                    raise
                # a raw device error on a mesh of more than one shard:
                # probe which shards died rather than abandon every
                # survivor (the reference's elastic.py:305-325)
                from .health import probe_shards

                dead = probe_shards(self.mesh)
                self._recover(ShardLossError(dead or [0], "sharded_fold",
                                             detail=f"{type(exc).__name__}: {exc}"))
                continue
            self._record_ownership(flags, batch_indices)
            return self.states
        self._host_fold(stacked, flags)
        return self.states

    def _record_ownership(self, flags, batch_indices: List[int]) -> None:
        local = max(1, len(flags) // self.n_dev)
        real = 0
        for j in range(len(flags)):
            if not flags[j]:
                continue
            self._owned[min(j // local, self.n_dev - 1)].add(batch_indices[real])
            real += 1

    def _host_fold(self, stacked: Tuple, flags) -> None:
        """The host's last resort: each real partial folds eagerly on the
        host, in batch order."""
        from . import _take

        states = list(self.states)
        for j in range(len(flags)):
            if not flags[j]:
                continue
            for i, a in enumerate(self.analyzers):
                states[i] = a.ingest_partial(states[i], _take(stacked[i], j))
        self.states = tuple(_to_host(s) for s in states)

    def _recover(self, exc) -> None:
        """Salvage the survivors, rebuild the mesh one rung down (or drop to
        host mode), queue the lost shards' batches for replay."""
        from ..observability import trace as _trace
        from ..observability.recorder import record_failure
        lost = sorted(set(exc.lost)) or [0]
        devices = list(self.mesh.devices)
        old_n = len(devices)
        record_failure(exc)
        _notify_shard_loss(_lost_shards(self.mesh, lost))
        _trace.add_event("shard_loss", site=getattr(exc, "site", ""), lost=lost,
                         mesh_devices=old_n, error=f"{type(exc).__name__}: {str(exc)[:200]}")
        if self.monitor is not None:
            self.monitor.bump("shard_losses", len(lost))
        _logger.warning("mesh shard loss (%d of %d shards: %s); salvaging the surviving "
                        "states and re-sharding", len(lost), old_n, lost)
        alive = [i for i in range(old_n) if i not in set(lost)]
        survivors = [devices[i] for i in alive]
        rung = next_rung(self.ladder, len(survivors))
        if rung is None and _one_card(devices):
            # every shard lay on this card: host mode would move the rest
            # of the pass off the card that failed, so the run fails
            raise MeshExhaustedError(
                f"all {old_n} shards of the mesh lie on {devices[0]} and the re-shard ladder "
                f"{self.ladder} fits none of the {len(survivors)} survivors") from exc
        t0 = time.perf_counter()
        if rung is None:
            shard_states, salvaged = salvage_stacked_states(self.analyzers, self.states, lost)
            canonical = host_merge_states(self.analyzers, shard_states)
        else:
            # the survivors merge on the rebuilt mesh's first device
            shard_states, salvaged = salvage_stacked_states(self.analyzers, self.states, lost,
                                                            device=survivors[0])
            canonical = device_merge_states(self.analyzers, shard_states, survivors[0])
        if self.monitor is not None:
            self.monitor.bump("salvaged_states", len(salvaged))
        salvaged_set = set(salvaged)
        kept: Set[int] = set()
        for pos, owned in enumerate(self._owned):
            if pos in salvaged_set:
                kept |= owned
            else:
                self._lost_batches |= owned
        _trace.add_event("salvage", shards=len(salvaged), batches_kept=len(kept),
                         batches_lost=len(self._lost_batches),
                         seconds=round(time.perf_counter() - t0, 4))
        self.reshards += 1
        if self.monitor is not None:
            self.monitor.bump("mesh_reshards")
        if rung is None:
            self.host_mode = True
            self.states = canonical
            self._owned = [kept]
            if self.monitor is not None:
                self.monitor.note_degraded("mesh:host")
            _trace.add_event("mesh_reshard", from_devices=old_n, to_devices=0, tier="host")
            _logger.warning("re-shard ladder exhausted (%d survivors, ladder %s); the fold "
                            "continues on the host with the salvaged canonical states",
                            len(survivors), self.ladder)
            return
        self.mesh = self.mesh.sub_mesh(alive[:rung])
        self.states = stack_canonical_states(self.analyzers, canonical, rung, self.mesh.home)
        self._owned = [set() for _ in range(rung)]
        self._owned[0] = kept
        if self.monitor is not None:
            self.monitor.note_degraded(f"mesh:{old_n}->{rung}")
        _trace.add_event("mesh_reshard", from_devices=old_n, to_devices=rung, tier="mesh")
        _logger.warning("mesh rebuilt over %d surviving devices (ladder %s); the fold "
                        "resumes from the salvaged merge", rung, self.ladder)

    def canonical(self) -> Tuple:
        """The canonical merged states now, without consuming the per-shard
        states. A merge that itself loses a shard recovers (salvage and
        re-shard) and merges again."""
        from ..exceptions import ShardLossError
        from . import collective_merge_states

        while not self.host_mode:
            try:
                return collective_merge_states(self.analyzers, self.mesh, self.states)
            except ShardLossError as exc:
                self._recover(exc)
        return self.states

    def finish(self) -> Tuple:
        """The final canonical merge. The engine replays
        :meth:`take_lost_batches` first: finishing with replays pending
        would under-count exactly the lost shards' batches."""
        if self.pending_replay:
            raise RuntimeError("ElasticMeshFold.finish() called with lost batches pending "
                               "replay; drain take_lost_batches() first")
        return self.canonical()
