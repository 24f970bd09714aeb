"""Fold and merge across processes (the reference's
``deequ_tpu/parallel/dcn.py``) on ``torch.distributed``.

N processes, each with its own device (a card, or the CPU), join one
process group; each folds its share of a run's host partials into its own
states on its device, then :func:`merge_host_states` merges the processes'
states with the collective merge's schedule, each process a shard: log2(N)
rounds in which a process exchanges its states with its XOR partner and
merges ``merge(own, partner)``, or, when N is not a power of two, one
gather and the ordered fold in rank order; every process ends with rank
0's result (the collective merge's shard 0).

- Each round exchanges one packed buffer per dtype (every state leaf of
  that dtype, flattened and concatenated), with ``dist.batch_isend_irecv``;
  the gather route uses ``dist.all_gather`` on the same buffers. The merge
  of a round runs on the process's device: one ``state_fold`` launch at
  N = 2 for every scalar, DataType, HLL and Correlation state (own state
  first), ``kll_compact``'s merge for a sketch.
- The caller names the backend (:func:`initialize_dcn`): ``"gloo"`` moves
  the packed buffers through pinned host memory, ``"nccl"`` sends the
  device's buffers. Nothing switches one for the other.
- The rendezvous is a ``FileStore`` in a directory the processes share
  unless the caller gives a ``tcp://host:port`` address; no network is
  needed on one host.
- A dead peer makes the next exchange raise or hang, so the merge runs
  under a deadline (:func:`with_deadline`); on a loss the survivor keeps
  its own states (:func:`salvage_local_states`) and replays what the dead
  peer owned (:func:`replay_partials`), eagerly, with each analyzer's
  ``ingest_partial``.

:func:`worker_main` is the body of one spawned process (it imports only
torch and this package): the multi-process tests and ``chip_smoke.py``
run it.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyzers.base import merge_states_batched_many, stack_states, state_to
from ..analyzers.states import leaves, with_leaves
from ..config import DeviceLike, resolve_device, synchronize
from . import (  # noqa: F401  (collective_merge_states: the reference's name here)
    collective_merge_states,
    make_mesh,
    sharded_ingest_fold,
    stack_identity_states,
)

#: seconds a cross-process merge may take before a peer counts as lost
DEFAULT_DCN_DEADLINE_S = 15.0
BACKENDS = ("gloo", "nccl")


#: the environment of a worker process on one host: one thread for
#: PyTorch's CPU operations (the processes share the host's cores) and
#: gloo's sockets on the loopback interface
WORKER_ENV = {"OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}


def dcn_worker_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of a worker process spawned on this host:
    ``base`` (the process's own when None) with :data:`WORKER_ENV` where it
    sets nothing else."""
    env = dict(os.environ if base is None else base)
    for key, value in WORKER_ENV.items():
        env.setdefault(key, value)
    return env


def initialize_dcn(store: str, num_processes: int, process_id: int, backend: str = "gloo",
                   timeout_s: float = 4 * DEFAULT_DCN_DEADLINE_S) -> None:
    """Join this process into the group: ``store`` is the path of a
    ``FileStore`` file every process names (or a ``tcp://host:port``
    address), ``backend`` ``"gloo"`` or ``"nccl"``."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if store.startswith("tcp://"):
        dist.init_process_group(backend, init_method=store, world_size=num_processes,
                                rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.FileStore(store, num_processes),
                                world_size=num_processes, rank=process_id, timeout=timeout)


def with_deadline(fn, seconds: float):
    """Run ``fn`` on a daemon thread under a deadline; returns ``(value,
    error, timed_out)``. A dead peer makes a cross-process step raise or
    hang: the deadline turns the hang into a loss the caller can see."""
    box: dict = {}
    done = threading.Event()

    def body():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - reported to the caller
            box["error"] = exc
        finally:
            done.set()

    threading.Thread(target=body, daemon=True).start()
    timed_out = not done.wait(seconds)
    return box.get("value"), box.get("error"), timed_out


def host_partials(analyzers: Sequence[Any], data, batch_rows: int) -> List[Tuple]:
    """Per batch of ``data``, the tuple of the analyzers' host partials
    (the sharded fold's input)."""
    from ..analyzers.base import HostBatchContext

    token = object()
    return [tuple(a.host_partial(HostBatchContext(batch, batch_index=index, run_token=token))
                  for a in analyzers)
            for index, batch in enumerate(data.batches(batch_rows, pad_to_batch_size=False))]


def stack_partials(analyzers: Sequence[Any], partials: Sequence[Tuple]) -> Tuple:
    """Per analyzer, its partials of ``partials`` stacked on a leading axis:
    a state whose leaves are stacked (on the host), or a KLL sample's six
    fields as arrays."""
    out = []
    for i in range(len(analyzers)):
        column = [p[i] for p in partials]
        if isinstance(column[0], tuple):
            out.append(tuple(np.stack([np.asarray(f) for f in fields])
                             for fields in zip(*column)))
        else:
            out.append(stack_states(column, torch.device("cpu")))
    return tuple(out)


def fold_partials(analyzers: Sequence[Any], mesh, states, partials: Sequence[Tuple]):
    """Fold host partials into the per-shard ``states`` over ``mesh``
    (every partial real; none leaves the states as they are), waiting for
    the device."""
    if not partials:
        return states
    flags = np.ones(len(partials), dtype=bool)
    out = sharded_ingest_fold(analyzers, mesh, states, stack_partials(analyzers, partials), flags)
    synchronize(mesh.home)
    return out


def salvage_local_states(states) -> Tuple:
    """Shard 0 of this process's stacked states, on the host: what
    survives when a peer died."""
    return tuple(with_leaves(st, [leaf[0].cpu() for leaf in leaves(st)]) for st in states)


def replay_partials(analyzers: Sequence[Any], salvaged: Sequence[Any],
                    partials: Sequence[Tuple], indices: Sequence[int]) -> Tuple:
    """Fold the partials a dead peer owned into the salvaged states, in
    order, with each analyzer's ``ingest_partial`` (no collective: the
    group is gone). The states are algebraic, so this is exact."""
    finished = []
    for i, a in enumerate(analyzers):
        acc = salvaged[i]
        for j in indices:
            acc = a.ingest_partial(acc, partials[j][i])
        finished.append(acc)
    return tuple(finished)


def _pack(states: Sequence[Any]):
    """Every leaf of ``states`` flattened into one buffer per dtype, and
    where each leaf lies: ``{dtype: buffer}``, ``[(dtype, offset, shape)]``
    in leaf order."""
    parts: Dict[torch.dtype, List[torch.Tensor]] = {}
    places = []
    sizes: Dict[torch.dtype, int] = {}
    for st in states:
        for leaf in leaves(st):
            at = sizes.get(leaf.dtype, 0)
            places.append((leaf.dtype, at, tuple(leaf.shape)))
            parts.setdefault(leaf.dtype, []).append(leaf.reshape(-1))
            sizes[leaf.dtype] = at + leaf.numel()
    return {dt: torch.cat(ts) for dt, ts in parts.items()}, places


def _unpack(templates: Sequence[Any], buffers: Dict[torch.dtype, torch.Tensor], places):
    out = []
    pos = 0
    for st in templates:
        n = len(leaves(st))
        got = [buffers[dt][off:off + int(np.prod(shape))].reshape(shape)
               for dt, off, shape in places[pos:pos + n]]
        out.append(with_leaves(st, got))
        pos += n
    return out


def _fold_states(analyzers: Sequence[Any], rows: List[Sequence[Any]], device) -> List[Any]:
    """Each analyzer's states of ``rows`` (a list of state tuples) folded
    left to right on ``device`` (:func:`merge_states_batched_many`: one
    ``state_fold`` launch, ``kll_compact``'s merge for a sketch)."""
    merged = merge_states_batched_many(list(zip(analyzers, zip(*rows))), device)
    return [state_to(st, device) for st in merged]


class _PeerLost(Exception):
    """An exchange with a peer failed: the peer is gone (or its link)."""


def _exchange(fn, *args):
    """Run one collective step; its failure is a lost peer. The merges
    between the steps run outside, so a failing kernel raises as itself."""
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001 - any failed exchange loses the peer
        raise _PeerLost(f"{type(exc).__name__}: {exc}") from exc


def _butterfly(analyzers: Sequence[Any], states: Sequence[Any], device: torch.device):
    """The collective merge's schedule across the group's processes."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    staged = dist.get_backend() == "gloo" and device.type == "cuda"

    def to_wire(buf: torch.Tensor) -> torch.Tensor:
        return buf.cpu().pin_memory() if staged else buf

    def from_wire(buf: torch.Tensor) -> torch.Tensor:
        return buf.to(device, non_blocking=True) if staged else buf

    def empty_like_wire(buf: torch.Tensor) -> torch.Tensor:
        if staged:
            return torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        return torch.empty_like(buf)

    states = list(states)
    if world & (world - 1) == 0:
        shift = 1
        while shift < world:
            partner = rank ^ shift
            buffers, places = _pack(states)
            send = {dt: to_wire(b) for dt, b in buffers.items()}
            recv = {dt: empty_like_wire(b) for dt, b in send.items()}
            ops = []
            for dt in sorted(send, key=str):
                ops.append(dist.P2POp(dist.isend, send[dt], partner))
                ops.append(dist.P2POp(dist.irecv, recv[dt], partner))
            for req in _exchange(dist.batch_isend_irecv, ops):
                _exchange(req.wait)
            theirs = _unpack(states, {dt: from_wire(b) for dt, b in recv.items()}, places)
            states = _fold_states(analyzers, [states, theirs], device)
            shift <<= 1
    else:
        buffers, places = _pack(states)
        gathered: Dict[torch.dtype, List[torch.Tensor]] = {}
        for dt in sorted(buffers, key=str):
            mine = to_wire(buffers[dt])
            gathered[dt] = [empty_like_wire(mine) for _ in range(world)]
            _exchange(dist.all_gather, gathered[dt], mine)
        rows = [_unpack(states, {dt: from_wire(g[r]) for dt, g in gathered.items()}, places)
                for r in range(world)]
        states = _fold_states(analyzers, rows, device)
    # every process takes rank 0's accumulator
    buffers, places = _pack(states)
    final = {}
    for dt in sorted(buffers, key=str):
        wire = to_wire(buffers[dt].contiguous())
        _exchange(dist.broadcast, wire, 0)
        final[dt] = from_wire(wire)
    synchronize(device)
    return tuple(_unpack(states, final, places))


def merge_host_states(analyzers: Sequence[Any], local_states: Sequence[Any],
                      device: DeviceLike = None,
                      deadline_s: float = DEFAULT_DCN_DEADLINE_S):
    """Merge every process's states (one per analyzer) across the group,
    on this process's ``device`` (``cuda`` unless the caller names
    another): returns ``(merged_states, None)``, the same on every
    process, or ``(None, reason)`` when an exchange with a peer failed or
    the merge ran past ``deadline_s``: a lost peer, which the caller
    survives with :func:`salvage_local_states` and :func:`replay_partials`.
    Any other error (a merge kernel's) raises. Outside a group (or in a
    group of one) the local states are the merge."""
    import torch.distributed as dist

    dev = resolve_device(device)
    states = [with_leaves(st, [leaf.to(dev) for leaf in leaves(st)]) for st in local_states]
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tuple(states), None
    merged, err, timed_out = with_deadline(lambda: _butterfly(analyzers, states, dev),
                                           deadline_s)
    if timed_out:
        return None, "collective merge timed out"
    if isinstance(err, _PeerLost):
        return None, f"collective merge failed: {err}"
    if err is not None:
        raise err
    return merged, None


def worker_main(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    """The body of one process of a cross-process fold and merge: join the
    group, fold this rank's host partials on its device, merge with
    :func:`merge_host_states`, and write the merged states (host tensors)
    to ``out_path`` with ``torch.save``. ``job_path`` holds (``torch.save``)
    a dict: ``analyzers``, ``partials`` (per rank its list of partial
    tuples), ``device``, ``backend``, ``deadline_s``, and optionally
    ``die`` (a rank that kills itself before the merge: a lost peer) with
    ``replay`` (the survivors replay the dead rank's partials). The
    process ends with ``os._exit``, so an abandoned exchange cannot keep
    it alive."""
    code = 0
    try:
        os.environ.update(dcn_worker_env())
        torch.set_num_threads(1)
        job = torch.load(job_path, weights_only=False)
        analyzers = job["analyzers"]
        device = resolve_device(job["device"])
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        initialize_dcn(store, world, rank, job.get("backend", "gloo"))
        mesh = make_mesh(1, device=device)
        folded = fold_partials(analyzers, mesh, stack_identity_states(analyzers, 1, device),
                               job["partials"][rank])
        local = salvage_local_states(folded)
        if job.get("die") == rank:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        merged, reason = merge_host_states(analyzers, local, device,
                                           job.get("deadline_s", DEFAULT_DCN_DEADLINE_S))
        salvaged = merged is None
        if salvaged:
            dead = job["die"]
            merged = replay_partials(analyzers, local, job["partials"][dead],
                                     range(len(job["partials"][dead])))
        torch.save({"rank": rank, "world": world, "salvaged": salvaged, "reason": reason,
                    "states": [with_leaves(st, [leaf.cpu() for leaf in leaves(st)])
                               for st in merged]}, out_path)
    except Exception as exc:  # noqa: BLE001 - reported through the exit code
        import traceback

        traceback.print_exc()
        print(f"dcn worker {rank} failed: {exc}", flush=True)
        code = 1
    os._exit(code)

