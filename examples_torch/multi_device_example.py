"""Scale a verification run over a device mesh — the port's counterpart of
the JAX package's multi-device example: the rows shard over a mesh and the
shards' states merge with the same semigroup state algebra
(`analyzers/Analyzer.scala:34-53` in the reference).

Three equivalent ways to use many shards:

1. **Sharded streaming scan** — hand the engine a mesh
   (``make_mesh``); every batch splits into the shards' row slices and the
   shards' states fold into one on the card.
2. **Independent shard scans + collective merge** — run one engine per data
   shard, then merge the per-shard states with ``collective_merge_states``
   (the `rdd.treeReduce` analog, reference
   `analyzers/runners/KLLRunner.scala:104-112`).
3. **Persisted states + `run_on_aggregated_states`** — no collective at
   all: shard states round-trip through a StateProvider and merge offline,
   exactly like the reference's partitioned-table refresh
   (`AnalysisRunner.scala:385-460`).

The mesh is ``make_mesh(8, device=device)``: eight shards of one card (or
of the CPU), where the JAX example takes the devices JAX sees. The three
routes must give identical metrics.
"""

from __future__ import annotations

import numpy as np

from . import run_main

#: shards of the mesh (the JAX example's ``min(len(jax.devices()), 8)``
#: on its 8-device test platform)
N_SHARDS = 8


def main(device="cuda"):
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct,
        Completeness,
        KLLParameters,
        KLLSketch,
        Mean,
        Size,
        StandardDeviation,
    )
    from deequ_tpu_torch.analyzers.base import stack_states
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.config import resolve_device
    from deequ_tpu_torch.data import Dataset
    from deequ_tpu_torch.parallel import collective_merge_states, make_mesh
    from deequ_tpu_torch.runners import AnalysisRunner
    from deequ_tpu_torch.runners.engine import ScanEngine, fetch_states

    n_devices = N_SHARDS
    mesh = make_mesh(n_devices, device=device)
    analyzers = [
        Size(),
        Completeness("latency_ms"),
        Mean("latency_ms"),
        StandardDeviation("latency_ms"),
        ApproxCountDistinct("endpoint"),
        KLLSketch("latency_ms", KLLParameters(256, 0.64, 10)),
    ]

    rng = np.random.default_rng(0)
    rows = 4096 * n_devices
    latency = rng.gamma(2.0, 30.0, rows)
    endpoint = rng.integers(0, 200, rows)
    data = Dataset.from_dict({"latency_ms": latency, "endpoint": endpoint})

    # 1) sharded streaming scan: ONE engine over the whole mesh
    ctx_sharded = AnalysisRunner.do_analysis_run(
        data, analyzers, batch_size=rows, sharding=mesh, placement="device", device=device
    )

    # 2) per-shard scans + explicit collective merge (ONE engine reused)
    shard_rows = rows // n_devices
    shard_engine = ScanEngine(analyzers, resolve_device(device), placement="device")
    per_shard_states = []
    for d in range(n_devices):
        shard = Dataset.from_dict(
            {
                "latency_ms": latency[d * shard_rows : (d + 1) * shard_rows],
                "endpoint": endpoint[d * shard_rows : (d + 1) * shard_rows],
            }
        )
        per_shard_states.append(shard_engine.run(shard))
    stacked = [
        stack_states([s[i] for s in per_shard_states], device=mesh.home)
        for i in range(len(analyzers))
    ]

    # scalar metrics only: the KLL quantile sketch is compared via its own
    # rank-error tests, not exact equality. Filtering happens BEFORE the
    # value is computed, so excluded metrics are never evaluated.
    def scalar_metrics(pairs, value_of):
        return {
            a.name: value_of(a, x) for a, x in pairs if a.name != "KLLSketch"
        }

    merged = fetch_states(collective_merge_states(analyzers, mesh, stacked))
    metrics_merged = scalar_metrics(
        zip(analyzers, merged), lambda a, m: a.compute_metric_from(m).value.get()
    )

    # 3) offline: persist per-shard states, refresh metrics with no rescan
    providers = []
    for states in per_shard_states:
        provider = InMemoryStateProvider()
        for a, s in zip(analyzers, states):
            provider.persist(a, s)
        providers.append(provider)
    ctx_offline = AnalysisRunner.run_on_aggregated_states(
        data.schema, analyzers, providers, device=device
    )

    get_value = lambda a, m: m.value.get()  # noqa: E731
    metrics_sharded = scalar_metrics(ctx_sharded.metric_map.items(), get_value)
    metrics_offline = scalar_metrics(ctx_offline.metric_map.items(), get_value)
    for name, want in metrics_sharded.items():
        for variant, got_map in (("merged", metrics_merged), ("offline", metrics_offline)):
            got = got_map[name]
            assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), (
                name, variant, got, want,
            )

    print(f"mesh: {n_devices} devices; all three distribution modes agree:")
    for name, value in sorted(metrics_sharded.items()):
        print(f"  {name}: {value:.6g}")
    return metrics_sharded, metrics_merged, metrics_offline


if __name__ == "__main__":
    run_main(main)
