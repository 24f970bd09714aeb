"""The self-tuning plane of the PyTorch/CUDA port (``deequ_tpu_torch.tuning``)
held against the JAX reference's (``deequ_tpu.tuning``), case by case after
``tests/test_tuning.py``.

- **Registry**: the same 13 knobs with the same env names, bounds, casts
  and env minimums; the one documented difference is ``prefetch_depth``'s
  static default (the port's 0, the reference's 2). Every knob resolves
  env override > tuned (autotune on) > static identically, and
  ``set_tuned`` clamps identically.
- **derive_knobs**: dicts equal bit for bit on 200 seeded probe dicts.
- **Controller**: one sequence of proposals, records, route choices and
  tuned-layer writes fed to both controllers gives equal decisions
  (without their timestamps), equal snapshots and equal counters after
  every step.
- **Profiles**: files cross between the packages at their fingerprint;
  torn, tampered and stale files quarantine under the same names; two
  substrates share a directory.
- **Calibration and boot** on the CPU.

Every test pins ``DEEQU_TPU_TUNING_PROFILE_DIR`` to its own temporary
directory and clears both packages' tuned layers before and after.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import pytest
import torch

from deequ_tpu.exceptions import CorruptStateError as JCorrupt
from deequ_tpu.service.metrics import ServiceMetrics as JMetrics
from deequ_tpu.tuning import calibrate as JC
from deequ_tpu.tuning import controller as JCtl
from deequ_tpu.tuning import knobs as JK
from deequ_tpu.tuning import profile as JP
from deequ_tpu_torch.exceptions import CorruptStateError as TCorrupt
from deequ_tpu_torch.service.metrics import ServiceMetrics as TMetrics
from deequ_tpu_torch.tuning import calibrate as TC
from deequ_tpu_torch.tuning import controller as TCtl
from deequ_tpu_torch.tuning import knobs as TK
from deequ_tpu_torch.tuning import profile as TP

pytestmark = pytest.mark.tuning

#: the one registry field that differs on purpose
DOCUMENTED_DEFAULTS = {"prefetch_depth": (0, 2)}  # (port, reference)
SERIES = ("deequ_service_tuning_proposals_total", "deequ_service_tuning_promotions_total",
          "deequ_service_tuning_demotions_total", "deequ_service_tuning_shadow_folds_total")


@pytest.fixture(autouse=True)
def _clean_tuned_layers(tmp_path, monkeypatch):
    for env in (TK.AUTOTUNE_ENV, TK.TUNING_SHADOW_FRACTION_ENV, TK.TUNING_MIN_SAMPLES_ENV,
                TK.TUNING_BAND_ENV, *(k.env for k in TK.REGISTRY.values() if k.env)):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv(TK.TUNING_PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    JK.clear_tuned()
    TK.clear_tuned()
    yield
    JK.clear_tuned()
    TK.clear_tuned()


# ---------------------------------------------------------------------------
# the registry: fields, resolution order, clamping
# ---------------------------------------------------------------------------

def test_registries_agree_but_for_the_documented_default():
    assert list(TK.REGISTRY) == list(JK.REGISTRY)
    assert len(TK.REGISTRY) == 13
    for name, port in TK.REGISTRY.items():
        ref = JK.REGISTRY[name]
        assert (port.env, port.cast, port.lo, port.hi, port.env_minimum,
                port.substrate_sensitive) == (ref.env, ref.cast, ref.lo, ref.hi,
                                              ref.env_minimum, ref.substrate_sensitive), name
        want = DOCUMENTED_DEFAULTS.get(name, (ref.static_default,) * 2)
        assert (port.static_default, ref.static_default) == want, name
        assert port.lo <= port.static_default <= port.hi, name
    assert "28% slower" in TK.REGISTRY["prefetch_depth"].description
    for env in ("AUTOTUNE_ENV", "TUNING_PROFILE_DIR_ENV", "TUNING_SHADOW_FRACTION_ENV",
                "TUNING_MIN_SAMPLES_ENV", "TUNING_BAND_ENV"):
        assert getattr(TK, env) == getattr(JK, env)


def _both_value(name):
    port, ref = TK.value(name), JK.value(name)
    if name in DOCUMENTED_DEFAULTS and port != ref:
        assert (port, ref) == DOCUMENTED_DEFAULTS[name]
        return port
    assert port == ref and type(port) is type(ref), name
    return port


@pytest.mark.parametrize("autotune", ["1", "0"])
@pytest.mark.parametrize("name", list(JK.REGISTRY))
def test_resolution_order_agrees(name, autotune, monkeypatch):
    monkeypatch.setenv(TK.AUTOTUNE_ENV, autotune)
    k = TK.REGISTRY[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    static = _both_value(name)
    assert static == k.static_default
    tuned = k.cast(rng.uniform(k.lo, k.hi) if k.cast is float
                   else rng.integers(max(k.lo, 1), min(k.hi, 1 << 20)))
    assert TK.set_tuned(name, tuned, source="test") == JK.set_tuned(name, tuned, source="test")
    got = _both_value(name)
    assert got == (tuned if autotune == "1" else static)
    if k.env is None:
        return
    # an env override wins over the tuned layer, under either setting
    override = k.cast(k.env_minimum if k.env_minimum is not None else 1) + 3
    monkeypatch.setenv(k.env, str(override))
    assert _both_value(name) == override
    # an invalid env value falls back to the next layer down
    monkeypatch.setenv(k.env, "not-a-number")
    assert _both_value(name) == (tuned if autotune == "1" else static)


def test_set_tuned_clamps_identically():
    rng = np.random.default_rng(20)
    for name, k in TK.REGISTRY.items():
        span = float(k.hi) - float(k.lo)
        for raw in rng.uniform(float(k.lo) - span, float(k.hi) + span, size=40):
            assert TK.set_tuned(name, raw) == JK.set_tuned(name, raw), (name, raw)
        for raw in (k.lo, k.hi, -(1 << 40), 1 << 40):
            assert TK.set_tuned(name, raw) == JK.set_tuned(name, raw), (name, raw)
    for module in (TK, JK):
        with pytest.raises(KeyError):
            module.set_tuned("not_a_knob", 1)


def test_clear_and_snapshot_round_trip():
    for module, static in ((TK, 0), (JK, 2)):
        assert not module.any_tuned()
        module.set_tuned("prefetch_depth", 4, source="test")
        module.set_tuned("coalesce_max_width", 8, source="profile")
        assert module.any_tuned()
        assert module.tuned_snapshot()["prefetch_depth"] == {
            "value": 4, "source": "test", "static": static}
        module.clear_tuned("prefetch_depth")
        assert "prefetch_depth" not in module.tuned_snapshot()
        module.clear_tuned()
        assert not module.any_tuned()


@pytest.mark.parametrize("env, raw", [
    ("TUNING_SHADOW_FRACTION_ENV", None), ("TUNING_SHADOW_FRACTION_ENV", "0.2"),
    ("TUNING_SHADOW_FRACTION_ENV", "0.9"), ("TUNING_SHADOW_FRACTION_ENV", "-1"),
    ("TUNING_MIN_SAMPLES_ENV", "8"), ("TUNING_MIN_SAMPLES_ENV", "0"),
    ("TUNING_BAND_ENV", "0.1"), ("TUNING_BAND_ENV", "x"), ("AUTOTUNE_ENV", "0"),
])
def test_plane_readers_agree(env, raw, monkeypatch):
    if raw is not None:
        monkeypatch.setenv(getattr(TK, env), raw)
    for reader in ("autotune_enabled", "shadow_fraction", "tuning_min_samples", "tuning_band"):
        assert getattr(TK, reader)() == getattr(JK, reader)(), reader
    assert TK.shadow_fraction() <= 0.5


def test_readers_resolve_through_the_registry(monkeypatch):
    """The hot-path readers: tuned values with autotune on, the static
    defaults with it off, equal to the reference's readers."""
    from deequ_tpu.analyzers import grouping as JG
    from deequ_tpu.ingest.prefetch import prefetch_depth as j_depth
    from deequ_tpu.service import coalesce as JS
    from deequ_tpu_torch.ingest.prefetch import prefetch_depth as t_depth
    from deequ_tpu_torch.service import coalesce as TS

    readers = [
        ("fast_path_max_rows", TS.fast_path_max_rows, JS.fast_path_max_rows, 0),
        ("coalesce_max_width", TS.coalesce_max_width, JS.coalesce_max_width, 4),
        ("prefetch_depth", t_depth, j_depth, 5),
        # the port's runner reads these three through knobs.value itself
        ("device_freq_max_cardinality", lambda: TK.value("device_freq_max_cardinality"),
         JG.device_freq_max_cardinality, 1 << 10),
        ("freq_table_slots", lambda: TK.value("freq_table_slots"), JG.freq_table_slots,
         1 << 12),
        ("freq_buffer_entries", lambda: TK.value("freq_buffer_entries"),
         JG.freq_buffer_entries, 1 << 17),
    ]
    for name, port, ref, tuned in readers:
        want = DOCUMENTED_DEFAULTS.get(name, (ref(),))[0]
        assert port() == want == TK.static_value(name), name
        TK.set_tuned(name, tuned, source="test")
        JK.set_tuned(name, tuned, source="test")
        assert port() == ref() == tuned, name
    monkeypatch.setenv(TK.AUTOTUNE_ENV, "0")
    for name, port, ref, _ in readers:
        assert port() == TK.static_value(name), f"{name}: AUTOTUNE=0 must be static"


def test_probably_low_cardinality_follows_the_tuned_layer(monkeypatch):
    """The probe's floor and slice size are knobs: a tuned layer flips the
    answer in both packages alike, and AUTOTUNE=0 restores the static one."""
    from deequ_tpu.analyzers.grouping import probably_low_cardinality as j_probe
    from deequ_tpu.data import Dataset as JD
    from deequ_tpu_torch.analyzers.grouping import probably_low_cardinality as t_probe
    from deequ_tpu_torch.data import Dataset as TD

    rng = np.random.default_rng(7)
    cols = {"k": rng.integers(0, 50, size=1 << 14)}
    jds, tds = JD.from_dict(cols), TD.from_dict(cols)
    assert t_probe(tds, ["k"]) is j_probe(jds, ["k"]) is False
    for module in (TK, JK):
        module.set_tuned("freq_host_route_min_rows", 0, source="test")
        module.set_tuned("freq_probe_rows", 1024, source="test")
    assert t_probe(tds, ["k"]) is j_probe(jds, ["k"]) is True
    monkeypatch.setenv(TK.AUTOTUNE_ENV, "0")
    assert t_probe(tds, ["k"]) is j_probe(jds, ["k"]) is False


def test_router_reseeds_from_tuned_knobs():
    from deequ_tpu_torch.service.coalesce import CrossoverRouter

    static = CrossoverRouter()
    assert (static._default_host_rate, static._device_fixed_s, static._device_rows_per_s) == (
        TK.static_value("router_host_rows_per_s"), TK.static_value("router_device_fixed_s"),
        TK.static_value("router_device_rows_per_s"))
    TK.set_tuned("router_host_rows_per_s", 1e12, source="test")
    TK.set_tuned("router_device_fixed_s", 0.5, source="test")
    tuned = CrossoverRouter()
    assert tuned._default_host_rate == 1e12 and tuned._device_fixed_s == 0.5
    # a measured device launch outranks any later reseed of the fixed cost
    tuned.observe_device(rows=1 << 20, seconds=0.5, folds=1)
    fixed = tuned._device_fixed_s
    TK.set_tuned("router_device_fixed_s", 5.0, source="test")
    tuned.reseed_from_knobs()
    assert tuned._device_fixed_s == fixed


# ---------------------------------------------------------------------------
# derive_knobs: the reference's arithmetic, bit for bit
# ---------------------------------------------------------------------------

def _probe_dicts(n: int, seed: int = 17) -> list:
    rng = np.random.default_rng(seed)
    keys = ["device_fixed_s", "device_rows_per_s", "device_stack_slope_s",
            "staging_rows_per_s", "group_host_rows_per_s", "group_device_rows_per_s"]
    out = []
    for i in range(n):
        probes = {
            f"host_rows_per_s_{c}": float(10 ** rng.uniform(5, 10))
            for c in ("Completeness", "Mean", "Sum", "Minimum", "Maximum")[:rng.integers(0, 6)]
        }
        probes.update({
            "device_fixed_s": float(10 ** rng.uniform(-6, 0)),
            "device_rows_per_s": float(10 ** rng.uniform(4, 12)),
            "device_stack_slope_s": float(10 ** rng.uniform(-9, -2)),
            "staging_rows_per_s": float(10 ** rng.uniform(5, 11)),
            "group_host_rows_per_s": float(10 ** rng.uniform(5, 9)),
            "group_device_rows_per_s": float(10 ** rng.uniform(5, 9)),
        })
        case = i % 5
        if case == 1:  # a missing key
            del probes[keys[rng.integers(0, len(keys))]]
        elif case == 2:  # a zero staging rate
            probes["staging_rows_per_s"] = 0.0
        elif case == 3:  # a slope below the probe's resolution
            probes["device_stack_slope_s"] = float(rng.uniform(0, 1e-7))
        elif case == 4:  # nothing measured on the grouping side
            probes.pop("group_host_rows_per_s")
            probes["group_device_rows_per_s"] = 0.0
        out.append(probes)
    out.append({})
    return out


def test_derive_knobs_bit_for_bit():
    for probes in _probe_dicts(200):
        got, want = TC.derive_knobs(dict(probes)), JC.derive_knobs(dict(probes))
        assert list(got) == list(want), probes
        for name in want:
            assert type(got[name]) is type(want[name]), name
            assert repr(got[name]) == repr(want[name]), (name, probes)


def test_derive_knobs_cost_model():
    derived = TC.derive_knobs({
        "host_rows_per_s_Mean": 40e6,
        "device_fixed_s": 0.004,
        "device_rows_per_s": 64e6,
        "device_stack_slope_s": 0.0005,
        "staging_rows_per_s": 16e6,
        "group_host_rows_per_s": 64e6,
        "group_device_rows_per_s": 16e6,
    })
    assert derived["router_host_rows_per_s"] == 40e6
    assert derived["fleet_stream_min_rows"] == 32768   # 0.25 x 4 ms x 64M
    assert derived["coalesce_max_width"] == 8          # fixed / slope
    assert derived["prefetch_depth"] == 5              # device 4x the staging rate
    assert derived["freq_host_route_max_distinct"] == (1 << 15) * 4
    # every derived depth is at least 1: a calibrated process turns the
    # feed thread on (the reference's formula, kept)
    assert TC.derive_knobs({"staging_rows_per_s": 1e15})["prefetch_depth"] == 1


# ---------------------------------------------------------------------------
# the online controller: one sequence through both, step by step
# ---------------------------------------------------------------------------

def _scenario(name: str) -> list:
    """Operations: ("propose", knob, candidate, mode), ("record", rows,
    seconds, arm), ("choose", rows), ("shadow_fold", rows, seconds) (a
    choose whose answer sets the record's arm), ("set", knob, value),
    ("clear", knob or None), ("refit",)."""
    fp = "fast_path_max_rows"
    if name == "shadow promote":
        ops = [("propose", fp, 8192, "shadow"), ("propose", fp, 4096, "shadow")]
        ops += [("record", 4096, 0.010, None), ("record", 4096, 0.001, fp)] * 8
    elif name == "shadow reject":
        ops = [("propose", fp, 8192, "shadow")]
        ops += [("record", 4096, 0.010, None), ("record", 4096, 0.009, fp)] * 8
    elif name == "starvation":
        ops = [("propose", fp, 8192, "shadow")] + [("record", 4096, 0.005, None)] * 80
    elif name == "trial rollback":
        ops = [("record", 4096, 0.002, None)] * 6 + [("propose", "coalesce_max_width", 8, "trial")]
        ops += [("record", 4096, 0.004, None)] * 4
    elif name == "trial promote":
        ops = [("record", 4096, 0.010, None)] * 6 + [("propose", "coalesce_max_width", 8, "trial")]
        ops += [("record", 4096, 0.001, None)] * 10
    elif name == "floor demotion and re-arm":
        ops = []
        for _ in range(2):
            ops += [("record", 4096, 0.002, None)] * 8
            ops += [("set", "coalesce_max_width", 1), ("set", "prefetch_depth", 0)]
            ops += [("record", 4096, 0.020, None)] * 8
        ops += [("record", 4096, 0.002, None)] * 50  # at static: the floor never fires
    elif name == "shadow routing":
        ops = [("propose", fp, 8192, "shadow")] + [("choose", 4096)] * 12
        ops += [("choose", 1 << 20)] * 4
        ops += [("shadow_fold", int(r), 0.004) for r in (512, 4096, 9000, 1 << 20) * 40]
    elif name == "bounded history":
        ops = []
        for i in range(JCtl._MAX_DECISIONS + 40):
            ops.append(("propose", "coalesce_max_width", 8 if i % 2 else 4, "trial"))
            ops += [("record", 4096, 0.002, None)] * 4
            ops.append(("clear", None))
    elif name == "refit":
        ops = [("set", "coalesce_max_width", 8), ("refit",), ("refit",)]
        ops += [("record", 4096, 0.003, None)] * 8 + [("refit",)]
    elif name == "seeded mix":
        rng = np.random.default_rng(5)
        knobs = [k for k in JK.REGISTRY if k != "prefetch_depth"]
        ops = []
        for _ in range(600):
            r = rng.random()
            if r < 0.05:
                k = knobs[rng.integers(0, len(knobs))]
                lo, hi = JK.REGISTRY[k].lo, JK.REGISTRY[k].hi
                ops.append(("propose", k, JK.REGISTRY[k].cast(rng.uniform(lo, min(hi, 1 << 20))),
                            "shadow" if k == fp else "trial"))
            elif r < 0.07:
                ops.append(("set", knobs[rng.integers(0, len(knobs))], int(rng.integers(1, 64))))
            elif r < 0.08:
                ops.append(("clear", None))
            else:
                ops.append(("shadow_fold", int(rng.integers(1, 1 << 15)),
                            float(10 ** rng.uniform(-4, -1))))
    else:
        raise KeyError(name)
    return ops


def _strip(snapshot: dict) -> dict:
    out = dict(snapshot)
    out["decisions"] = [{k: v for k, v in d.items() if k != "at"} for d in snapshot["decisions"]]
    out["tuned"] = {k: (v["value"], v["source"]) for k, v in snapshot["tuned"].items()}
    return out


SCENARIOS = ["shadow promote", "shadow reject", "starvation", "trial rollback",
             "trial promote", "floor demotion and re-arm", "shadow routing",
             "bounded history", "refit", "seeded mix"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_controller_decisions_agree(scenario, monkeypatch):
    monkeypatch.setenv(TK.TUNING_MIN_SAMPLES_ENV, "4")
    monkeypatch.setenv(TK.TUNING_SHADOW_FRACTION_ENV, "0.25")
    profile_values = {"coalesce_max_width": 8, "freq_host_route_min_rows": 1 << 20,
                      "router_device_fixed_s": 0.001}
    substrate = {"backend": "cpu", "device_kind": "cpu", "chip_count": 1, "host": "x"}
    sides = []
    for ctl, metrics, knobs, prof in ((TCtl, TMetrics, TK, TP), (JCtl, JMetrics, JK, JP)):
        m = metrics()
        profile = (prof.SubstrateProfile(substrate=substrate, knob_values=dict(profile_values))
                   if scenario == "refit" else None)
        sides.append((ctl.TuningController(metrics=m, profile=profile), m, knobs))
    for step, op in enumerate(_scenario(scenario)):
        answers = []
        for controller, _, knobs in sides:
            kind = op[0]
            if kind == "propose":
                answers.append(controller.propose(op[1], op[2], mode=op[3]))
            elif kind == "record":
                answers.append(controller.record(op[1], op[2], arm=op[3]))
            elif kind == "choose":
                answers.append(controller.choose(op[1]))
            elif kind == "shadow_fold":
                arm = controller.choose(op[1])
                controller.record(op[1], op[2], arm="fast_path_max_rows" if arm else None)
                answers.append(arm)
            elif kind == "set":
                answers.append(knobs.set_tuned(op[1], op[2], source="drill"))
            elif kind == "clear":
                answers.append(knobs.clear_tuned(op[1]))
            elif kind == "refit":
                answers.append(controller.refit())
        assert answers[0] == answers[1], (step, op, answers)
        (port, pm, _), (ref, rm, _) = sides
        assert _strip(port.snapshot()) == _strip(ref.snapshot()), (step, op)
        for series in SERIES:
            assert pm.counter_value(series) == rm.counter_value(series), (step, op, series)
    snap = sides[0][0].snapshot()
    verdicts = [d["verdict"] for d in snap["decisions"]]
    expected = {
        "shadow promote": ["promote"], "shadow reject": ["reject"], "starvation": ["reject"],
        "trial rollback": ["reject"], "trial promote": ["promote"],
        "floor demotion and re-arm": ["floor_demotion", "floor_demotion"],
    }
    if scenario in expected:
        assert verdicts == expected[scenario]
    if scenario == "bounded history":
        assert len(verdicts) == JCtl._MAX_DECISIONS == TCtl._MAX_DECISIONS
    if scenario == "shadow routing":
        assert sides[0][1].counter_value("deequ_service_tuning_shadow_folds_total") > 0


# ---------------------------------------------------------------------------
# profiles: round trip, crossing packages, quarantine, substrates
# ---------------------------------------------------------------------------

_SUBSTRATE = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "chip_count": 1,
              "host": "x86_64-8cpu", "engine": "torch"}


def _profile(prof, substrate=None, knob_values=None):
    return prof.SubstrateProfile(
        substrate=dict(substrate or _SUBSTRATE),
        probes={"device_fixed_s": 0.002, "staging_rows_per_s": 3.5e9},
        knob_values=knob_values if knob_values is not None else {"coalesce_max_width": 8,
                                                                 "prefetch_depth": 3},
        created_at=1_700_000_000.25, calibration_wall_s=1.5,
    )


def test_substrate_key_on_the_cpu():
    key = TP.substrate_key("cpu")
    assert key == {"backend": "cpu", "device_kind": "cpu", "chip_count": 1,
                   "host": JP.substrate_key()["host"], "engine": "torch"}
    assert TP.substrate_fingerprint(key) == JP.substrate_fingerprint(key)
    assert TP.substrate_fingerprint(device="cpu") == TP.substrate_fingerprint(key)


def test_profile_round_trip(tmp_path):
    d = str(tmp_path)
    saved = _profile(TP, TP.substrate_key("cpu"))
    path = TP.save_profile(saved, d)
    assert os.path.basename(path) == f"profile-{saved.fingerprint}.json"
    assert not [f for f in os.listdir(d) if ".tmp." in f]
    loaded = TP.load_profile(d, device="cpu")
    assert loaded == saved
    assert TP.load_profile(str(tmp_path / "empty"), device="cpu") is None


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_profiles_cross_between_packages(writer, tmp_path):
    d = str(tmp_path)
    prof, other = (TP, JP) if writer == "torch" else (JP, TP)
    saved = _profile(prof)
    prof.save_profile(saved, d)
    loaded = other.load_profile(d, fingerprint=saved.fingerprint)
    assert loaded is not None and loaded.to_payload() == saved.to_payload()
    assert loaded.fingerprint == saved.fingerprint
    # the files the two packages write are the same bytes
    twin = tmp_path / "twin"
    other.save_profile(_profile(other), str(twin))
    name = f"profile-{saved.fingerprint}.json"
    assert (twin / name).read_bytes() == (tmp_path / name).read_bytes()


def _corrupt(path: str, how: str, prof) -> None:
    if how == "torn":
        with open(path, "w") as fh:
            fh.write("{ torn json")
    elif how == "checksum":
        with open(path) as fh:
            record = json.load(fh)
        record["payload"]["knob_values"]["coalesce_max_width"] = 1024
        with open(path, "w") as fh:
            json.dump(record, fh)


@pytest.mark.parametrize("how, match", [("torn", "unreadable"), ("checksum", "checksum"),
                                        ("stale", "version")])
def test_quarantine_names_agree(how, match, tmp_path):
    names = []
    for prof, corrupt_error in ((TP, TCorrupt), (JP, JCorrupt)):
        d = str(tmp_path / prof.__name__.split(".")[0])
        profile = _profile(prof)
        if how == "stale":
            profile.version = prof.PROFILE_VERSION + 1
        path = prof.save_profile(profile, d)
        _corrupt(path, how, prof)
        with pytest.raises(corrupt_error, match=match):
            prof.load_profile(d, fingerprint=profile.fingerprint)
        assert not os.path.exists(path)
        # the quarantined file can never affect a later boot
        assert prof.load_profile(d, fingerprint=profile.fingerprint) is None
        names.append(sorted(os.listdir(os.path.join(d, ".quarantine"))))
    assert names[0] == names[1] and len(names[0]) == 1


def test_apply_skips_unknown_knobs_and_clamps():
    for prof, knobs in ((TP, TK), (JP, JK)):
        profile = _profile(prof, knob_values={"coalesce_max_width": 10_000,
                                              "knob_from_the_future": 42})
        assert profile.apply(source="test") == {"coalesce_max_width": 1024}
        assert knobs.value("coalesce_max_width") == 1024
        assert "knob_from_the_future" not in knobs.tuned_snapshot()


def test_profile_dir_honors_env_and_shares_the_default(tmp_path, monkeypatch):
    monkeypatch.setenv(TK.TUNING_PROFILE_DIR_ENV, str(tmp_path / "p"))
    assert TP.profile_dir() == JP.profile_dir() == str(tmp_path / "p")
    monkeypatch.delenv(TK.TUNING_PROFILE_DIR_ENV)
    monkeypatch.setenv("DEEQU_TPU_COMPILE_CACHE", str(tmp_path / "cache" / "xla"))
    assert TP.profile_dir() == JP.profile_dir() == str(tmp_path / "cache" / "deequ_tpu_tuning")


def test_two_substrates_coexist(tmp_path):
    """The port's CPU substrate, a card's, and the reference's share one
    directory: three files, each loader resolves only its own."""
    d = str(tmp_path)
    cpu = _profile(TP, TP.substrate_key("cpu"), {"coalesce_max_width": 4})
    card = _profile(TP, _SUBSTRATE, {"coalesce_max_width": 32})
    ref = _profile(JP, JP.substrate_key(), {"coalesce_max_width": 2})
    for prof, p in ((TP, cpu), (TP, card), (JP, ref)):
        prof.save_profile(p, d)
    assert len({cpu.fingerprint, card.fingerprint, ref.fingerprint}) == 3
    assert len([f for f in os.listdir(d) if f.startswith("profile-")]) == 3
    assert TP.load_profile(d, device="cpu").knob_values == {"coalesce_max_width": 4}
    assert TP.load_profile(d, fingerprint=card.fingerprint).knob_values == {
        "coalesce_max_width": 32}
    assert JP.load_profile(d).knob_values == {"coalesce_max_width": 2}


# ---------------------------------------------------------------------------
# calibration on the CPU, and its refusals
# ---------------------------------------------------------------------------

def test_calibrate_on_the_cpu_derives_in_bounds_and_persists(tmp_path):
    d = str(tmp_path)
    profile = TC.calibrate(device="cpu", rows=4096, repeats=1, profile_dir=d)
    assert profile.calibration_wall_s > 0
    assert profile.substrate == TP.substrate_key("cpu")
    for probe in ("device_fixed_s", "device_rows_per_s", "staging_rows_per_s",
                  "group_host_rows_per_s", "group_device_rows_per_s",
                  "host_rows_per_s_Mean"):
        assert profile.probes[probe] > 0, probe
    assert profile.knob_values == TC.derive_knobs(profile.probes)
    for name, value in profile.knob_values.items():
        k = TK.REGISTRY[name]
        assert k.lo <= value <= k.hi and k.cast(value) == value, name
    assert profile.knob_values["prefetch_depth"] >= 1
    # calibrate() measures; it never installs into the live registry
    assert not TK.any_tuned()
    assert TP.load_profile(d, device="cpu") == profile


def test_calibrate_cli_prints_the_profile(tmp_path, capsys):
    assert TC._main(["--json", "--device", "cpu", "--rows", "4096", "--repeats", "1",
                     "--dir", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["substrate"]["engine"] == "torch"
    assert printed["knobs"] == TC.derive_knobs(printed["probes"])
    assert os.path.exists(tmp_path / f"profile-{printed['fingerprint']}.json")


def test_a_probe_that_left_the_device_tier_raises(monkeypatch):
    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

    def failed_over(data, analyzers, monitor=None, **kwargs):
        monitor.placement = "host"
        monitor.device_failovers = 1

    monkeypatch.setattr(AnalysisRunner, "do_analysis_run", staticmethod(failed_over))
    with pytest.raises(RuntimeError, match="did not run on the device tier"):
        TC._run_analysis(TC._probe_dataset(16), [Mean("v")], torch.device("cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_calibration_and_service_default_to_the_card():
    from deequ_tpu_torch.service import VerificationService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.calibrate(save=False, rows=16, repeats=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.substrate_key()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VerificationService(background_warm=False)


# ---------------------------------------------------------------------------
# the service's boot
# ---------------------------------------------------------------------------

def _boot_service():
    from deequ_tpu_torch.service import VerificationService

    return VerificationService(workers=1, background_warm=False, device="cpu")


def test_autotune_off_boots_no_controller(monkeypatch):
    monkeypatch.setenv(TK.AUTOTUNE_ENV, "0")
    with _boot_service() as service:
        assert service.tuning_controller is None
        # a disabled plane still exports described zeros
        assert service.metrics.counter_value("deequ_service_tuning_promotions_total") == 0.0
        assert "deequ_service_tuning_promotions_total" in service.metrics._help
        assert service.statusz.snapshot()["planes"]["tuning"] == {"enabled": False}


def test_boot_applies_profile_and_reseeds_the_router(tmp_path, monkeypatch):
    d = str(tmp_path / "profiles")
    profile = _profile(TP, TP.substrate_key("cpu"), {"coalesce_max_width": 8,
                                                     "router_host_rows_per_s": 1e12,
                                                     "router_device_fixed_s": 0.125})
    TP.save_profile(profile, d)
    with _boot_service() as service:
        ctl = service.tuning_controller
        assert ctl is not None and ctl.profile == profile
        assert {k: v["value"] for k, v in TK.tuned_snapshot().items()} == profile.knob_values
        assert TK.tuned_snapshot()["coalesce_max_width"]["source"] == "profile"
        router = service.coalescer.router
        assert (router._default_host_rate, router._device_fixed_s) == (1e12, 0.125)
        tuning = service.statusz.snapshot()["planes"]["tuning"]
        assert tuning["enabled"] is True
        assert set(tuning) == {"enabled", "active_knobs", "experiments", "decisions", "floor"}
        assert tuning["active_knobs"]["coalesce_max_width"]["value"] == 8
        text = service.metrics.prometheus_text()
        assert "deequ_service_tuning_tuned_knobs 3" in text


def test_corrupt_profile_boots_static_with_quarantine(tmp_path):
    d = str(tmp_path / "profiles")
    path = TP.save_profile(_profile(TP, TP.substrate_key("cpu")), d)
    with open(path, "w") as fh:
        fh.write("not json")
    with _boot_service() as service:
        assert service.tuning_controller is not None
        assert service.tuning_controller.profile is None
        assert not TK.any_tuned()
    assert os.listdir(os.path.join(d, ".quarantine"))
