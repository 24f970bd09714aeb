"""Row-sharded runs over a device mesh (the reference's
``deequ_tpu/parallel/__init__.py``, B11).

The reference's only parallelism is data parallelism over row shards with
an algebraic state merge (Spark's partial aggregation and ``treeReduce``).
Here a :class:`Mesh` is a 1-D sequence of ``torch.device``s, one per row
shard. A device may repeat: shards that share a card are logical shards,
and they do their work stacked into one launch per kernel, the shard the
stacked axis (``make_mesh(8, device="cuda")`` gives eight shards on one
card, the port's form of the reference's eight virtual host devices).

1. **The device tier** (:func:`sharded_update`): per batch the rows split
   into ``mesh.size`` equal contiguous slices; the scalar reductions
   (``scan_reduce``'s stacked entry) and the HLL registers
   (``hll_registers``' stacked entry) run with the shard as the stacked
   axis, one launch per card, and the shards' partial states fold into the
   replicated state in shard order on the mesh's first device (one
   ``state_fold`` launch). Sketches and frequency tables see the whole
   batch, as the reference's GSPMD program reads them as global arrays.
2. **The host tier** (:func:`sharded_ingest_fold`): per-shard states, each
   folding its own contiguous slice of a chunk of host partials
   (``state_fold``'s stacked-carry entry; ``kll_compact``'s ingest entry
   over every shard's sketches).
3. **The collective merge** (:func:`collective_merge_states`): every
   shard's local fold, then log2(n) XOR rounds of ``merge(acc, partner)``
   or, for a mesh size that is not a power of two, the ordered fold of the
   gathered accumulators; the result is shard 0's accumulator. On one
   device that is one ``state_fold_butterfly`` launch and
   ``kll_compact_merge_stacked`` launches; the states of a mesh live on its
   first device, so shards of other cards reach it by a peer copy.

Per-shard states are stacked: one state per analyzer whose leaves carry a
leading shard axis. The cross-process leg is :mod:`.dcn`; shard loss is
:mod:`.elastic` and :mod:`.health`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyzers.base import fold_layout, pack_stacked, unpack_stacked
from ..analyzers.states import leaves, with_leaves
from ..config import DeviceLike, resolve_device
from ..ops.kll import KLLSketchState
from ..reliability.faults import fault_point

ROW_AXIS = "rows"


class Mesh:
    """A 1-D mesh over the row axis: one device per shard, in shard order.
    Devices may repeat (shards of one card); the mesh's states live on its
    first device, :attr:`home`.

    A fleet scheduler's sub-mesh also knows where its shards sit in the
    fleet's device table: ``fleet_positions`` (one table position per
    shard) and ``fleet_token`` (what identifies that fleet), so a shard
    loss reports positions, which devices cannot name when shards share a
    card. Both are None on any other mesh."""

    def __init__(self, devices: Sequence[DeviceLike],
                 fleet_positions: Optional[Sequence[int]] = None, fleet_token: Any = None):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {d}")
        if fleet_positions is not None and len(fleet_positions) != len(self.devices):
            raise ValueError("a mesh needs one fleet position per shard")
        self.fleet_positions = None if fleet_positions is None else tuple(fleet_positions)
        self.fleet_token = fleet_token

    def sub_mesh(self, keep: Sequence[int]) -> "Mesh":
        """The mesh of the shards at positions ``keep`` (in that order),
        their fleet positions carried along."""
        return Mesh([self.devices[i] for i in keep],
                    None if self.fleet_positions is None
                    else [self.fleet_positions[i] for i in keep], self.fleet_token)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """The distinct devices in order of first appearance, each with the
        shard positions it holds."""
        out: Dict[torch.device, List[int]] = {}
        for pos, d in enumerate(self.devices):
            out.setdefault(d, []).append(pos)
        return list(out.items())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(num_devices: Optional[int] = None, devices=None,
              device: DeviceLike = None) -> Mesh:
    """A 1-D mesh over the row axis (the reference's ``make_mesh``).

    ``devices`` names the shards' devices (the first ``num_devices`` of
    them when both are given). Otherwise ``device`` (``cuda`` unless the
    caller names another) picks them: ``"cuda"`` every visible card, a
    device with an index (``"cuda:1"``, ``"cpu"``) that one device. With
    ``num_devices`` above the number of devices, the devices repeat: each
    takes a contiguous block of shards (``make_mesh(8, device="cuda")`` on
    one card: eight shards on it)."""
    if devices is not None:
        devs = list(devices)
        return Mesh(devs if num_devices is None else devs[:num_devices])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        base = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        base = [dev]
    n = len(base) if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {num_devices}")
    if n <= len(base):
        return Mesh(base[:n])
    return Mesh([base[s * len(base) // n] for s in range(n)])


def _is_stacked_kernel(analyzer) -> bool:
    """Whether the analyzer has a stacked kernel of its own (its
    ``update_stacked`` is overridden: the HLL registers)."""
    from ..analyzers.base import ScanShareableAnalyzer

    return type(analyzer).update_stacked is not ScanShareableAnalyzer.update_stacked


def shard_features(features: Dict[str, torch.Tensor], mesh: Mesh,
                   batch_rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The batch's ``[B]`` feature arrays as ``[n, B / n]`` views, shard s
    owning rows ``s*B/n .. (s+1)*B/n - 1`` (the engine pads batches to a
    multiple of the mesh size). Arrays of another length stay as they
    are."""
    n = mesh.size
    rows = int(batch_rows if batch_rows is not None else features["rows"].shape[0])
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} shards")
    return {k: v.view(n, rows // n) if v.dim() == 1 and v.shape[0] == rows else v
            for k, v in features.items()}


def sharded_update(analyzers: Sequence[Any], mesh: Mesh):
    """The device tier's update of a battery over ``mesh``: a function
    ``(states, features) -> states`` with the states replicated on
    ``mesh.home`` and the batch's features there too (the reference's
    GSPMD program; see the module docstring)."""
    from ..runners.engine import _fused_program

    program = _fused_program(tuple(analyzers))

    def update(states: Sequence[Any], features: Dict[str, torch.Tensor]) -> List[Any]:
        return program.call_sharded(states, features, mesh)

    return update


def _shards_of(state) -> int:
    ls = leaves(state)
    return int(ls[0].shape[0]) if ls else 0


def stack_identity_states(analyzers: Sequence[Any], n_dev: int,
                          device: DeviceLike = None) -> Tuple[Any, ...]:
    """``n_dev`` copies of each analyzer's identity state, stacked on a
    leading axis on ``device``: the initial per-shard states of
    :func:`sharded_ingest_fold`."""
    dev = resolve_device(device)
    return tuple(_tile(a.init_state(dev), n_dev) for a in analyzers)


def _tile(state, n: int):
    return with_leaves(state, [leaf[None].expand((n,) + tuple(leaf.shape)).clone()
                               for leaf in leaves(state)])


def _take(stacked, j: int):
    """Entry ``j`` of a stacked state (views) or of a stacked host sample
    (a tuple of arrays)."""
    if isinstance(stacked, tuple):
        return tuple(f[j] for f in stacked)
    return with_leaves(stacked, [leaf[j] for leaf in leaves(stacked)])


def _real_ranges(counts: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Runs of consecutive shards with the same positive count of real
    partials: ``(first shard, end shard, count)``."""
    runs: List[Tuple[int, int, int]] = []
    for s, c in enumerate(counts):
        if c == 0:
            continue
        if runs and runs[-1][1] == s and runs[-1][2] == c:
            runs[-1] = (runs[-1][0], s + 1, c)
        else:
            runs.append((s, s + 1, c))
    return runs


def sharded_ingest_fold(analyzers: Sequence[Any], mesh: Mesh, states_stacked: Sequence[Any],
                        partials_stacked: Sequence[Any], flags) -> Tuple[Any, ...]:
    """Fold a chunk of host partials into the per-shard states over the
    mesh (the reference's ``sharded_ingest_fold``): the stacked partials
    (leading axis ``n * local_chunk``) split into ``n`` contiguous slices,
    and shard s folds its slice, in order, into its own state; ``flags``
    marks the real partials (padding skips all work).

    ``states_stacked``: per analyzer its ``n`` shards' states, stacked, on
    ``mesh.home``. ``partials_stacked``: per analyzer the chunk's host
    partials stacked (:func:`.dcn.stack_partials`): a state with a leading
    axis, or a KLL sample's six fields as arrays. Every state but a KLL
    sketch folds in one ``state_fold_carry_stacked`` launch; the sketches
    of one shape in ``kll_compact_ingest`` launches over every shard's
    sketch (S = n x sketches), one per run of shards with the same number
    of real partials. Returns the new stacked states."""
    from ..kernels.kll_compact import kll_compact_ingest
    from ..kernels.state_fold import state_fold_carry_stacked
    from ..runners.engine import stack_samples

    n = mesh.size
    home = mesh.home
    flags = np.asarray(flags, dtype=bool)
    if len(flags) % n:
        raise ValueError(f"a chunk of {len(flags)} partials does not split over {n} shards")
    local = len(flags) // n
    fault_point("sharded_fold")
    layout = fold_layout()
    out = list(states_stacked)
    carried = [i for i, st in enumerate(states_stacked) if type(st) in layout]
    sketched = [i for i, st in enumerate(states_stacked) if isinstance(st, KLLSketchState)]
    if len(carried) + len(sketched) != len(out):
        raise NotImplementedError("sharded_ingest_fold folds the states state_fold or "
                                  "kll_compact folds")

    def to_home(t: torch.Tensor) -> torch.Tensor:
        if home.type == "cpu":
            return t
        return t.pin_memory().to(home, non_blocking=True)

    if carried:
        mats, slots, places = pack_stacked([states_stacked[i] for i in carried], layout)
        parts = pack_stacked([partials_stacked[i] for i in carried], layout)[0]
        carry = [m.contiguous() for m in mats]
        state_fold_carry_stacked(carry, [to_home(p.contiguous()) for p in parts], slots,
                                 to_home(torch.from_numpy(flags)))
        for i, st in zip(carried, unpack_stacked([states_stacked[i] for i in carried],
                                                 places, carry)):
            out[i] = st
    counts = [int(flags[s * local:(s + 1) * local].sum()) for s in range(n)]
    groups: Dict[Tuple, List[int]] = {}
    for i in sketched:
        st = states_stacked[i]
        groups.setdefault((st.sketch_size, *st.items.shape[1:]), []).append(i)
    for (k, _levels, width), idx in groups.items():
        # shard-major: row s * S + j is shard s's sketch of analyzer idx[j]
        stacked = [torch.stack(col, dim=1).reshape((n * len(idx),) + tuple(col[0].shape[1:]))
                   .contiguous()
                   for col in zip(*(states_stacked[i].tensors() for i in idx))]
        for first, end, count in _real_ranges(counts):
            samples = []
            for s in range(first, end):
                rows = [r for r in range(s * local, (s + 1) * local) if flags[r]]
                samples += [[_take(partials_stacked[i], r) for r in rows] for i in idx]
            view = [leaf[first * len(idx):end * len(idx)] for leaf in stacked]
            kll_compact_ingest(view, stack_samples(samples, width, to_home), k)
        for j, i in enumerate(idx):
            out[i] = KLLSketchState(*(leaf.view((n, len(idx)) + tuple(leaf.shape[1:]))[:, j]
                                      for leaf in stacked), sketch_size=k)
    return tuple(out)


def _pad_states(analyzers: Sequence[Any], per_shard_states: Sequence[Any], total: int,
                device: torch.device) -> List[Any]:
    out = []
    for a, st in zip(analyzers, per_shard_states):
        st = with_leaves(st, [leaf.to(device) for leaf in leaves(st)])
        pad = total - _shards_of(st)
        if pad:
            ident = a.init_state(device)
            st = with_leaves(st, [
                torch.cat([x, i[None].expand((pad,) + tuple(i.shape)).to(x.dtype)])
                for x, i in zip(leaves(st), leaves(ident))
            ])
        out.append(st)
    return out


def _kll_butterfly(sketch: KLLSketchState, n_dev: int, k: int) -> KLLSketchState:
    """The collective merge's schedule for one stacked sketch
    (``[n_dev * k]`` sketches) on ``kll_compact_merge_stacked``: k - 1
    local steps of n_dev pairs, then one launch of n_dev pairs per XOR
    round (the partners a gather on the sketch axis), or n_dev - 1
    one-pair launches of the ordered gather fold."""
    from ..kernels.kll_compact import kll_compact_merge_stacked

    size = sketch.sketch_size
    tensors = sketch.tensors()
    device = tensors[0].device
    base = torch.arange(n_dev, device=device) * k
    acc = tuple(t[base].contiguous() for t in tensors)
    for i in range(1, k):
        acc = kll_compact_merge_stacked(acc, tuple(t[base + i].contiguous() for t in tensors),
                                        size)
    if n_dev > 1 and n_dev & (n_dev - 1) == 0:
        shift = 1
        while shift < n_dev:
            partner = torch.arange(n_dev, device=device) ^ shift
            acc = kll_compact_merge_stacked(acc, tuple(t[partner].contiguous() for t in acc),
                                            size)
            shift <<= 1
    elif n_dev > 1:
        first = tuple(t[:1] for t in acc)
        for s in range(1, n_dev):
            first = kll_compact_merge_stacked(first, tuple(t[s:s + 1] for t in acc), size)
        acc = first
    return KLLSketchState(*(t[0] for t in acc), sketch_size=size)


def collective_merge_states(analyzers: Sequence[Any], mesh: Mesh,
                            per_shard_states: Sequence[Any]) -> Tuple[Any, ...]:
    """Fold per-shard states with each analyzer's merge, the reference's
    ``collective_merge_states`` (deequ_tpu/parallel/__init__.py:266).

    ``per_shard_states`` holds per analyzer its shards' states, stacked; the
    shard count comes from that leading axis, not the mesh size (8 states
    on a mesh of 4: k = 2 per shard). The shards pad with identity states
    to ``n * k``; shard s owns ``s*k .. s*k+k-1`` and folds them; then the
    mesh size picks the route (XOR rounds for a power of two, else the
    ordered fold of the gathered accumulators), and the result is shard
    0's accumulator, on ``mesh.home``. Zero shards give the identity
    states. Scalar, DataType, HLL, Correlation and dictionary-count states
    fold in one ``state_fold_butterfly`` launch; KLL sketches on
    ``kll_compact_merge_stacked``."""
    from ..kernels.state_fold import state_fold_butterfly

    n_dev = mesh.size
    home = mesh.home
    total = max((_shards_of(st) for st in per_shard_states), default=0)
    if total == 0:
        return tuple(a.init_state(home) for a in analyzers)
    k = -(-total // n_dev)
    padded = _pad_states(analyzers, per_shard_states, n_dev * k, home)
    fault_point("collective_merge")
    layout = fold_layout()
    out: List[Any] = [None] * len(padded)
    carried = [i for i, st in enumerate(padded) if type(st) in layout]
    if carried:
        mats, slots, places = pack_stacked([padded[i] for i in carried], layout)
        rows = state_fold_butterfly(*(m.contiguous() for m in mats), slots, n_dev)
        merged = unpack_stacked([padded[i] for i in carried], places, [r[0] for r in rows])
        for i, st in zip(carried, merged):
            out[i] = st
    for i, st in enumerate(padded):
        if isinstance(st, KLLSketchState):
            out[i] = _kll_butterfly(st, n_dev, k)
        elif out[i] is None:
            raise NotImplementedError(f"collective_merge_states folds the states state_fold or "
                                      f"kll_compact folds, not {type(st).__name__}")
    return tuple(out)


# the elastic layer and the health probe ride on the primitives above;
# imported last so that they can import them from this module
from .elastic import (  # noqa: E402,F401
    MESH_LADDER_ENV,
    ElasticMeshFold,
    add_shard_loss_listener,
    host_merge_states,
    mesh_batch_quantum,
    mesh_ladder,
    next_rung,
    remove_shard_loss_listener,
    salvage_stacked_states,
    stack_canonical_states,
)
from .health import (  # noqa: E402,F401
    HEARTBEAT_ENV,
    HeartbeatGate,
    probe_devices,
    probe_shards,
    shard_heartbeat_s,
)
