"""The port's tuning report (``tools/torch_tuning_report.py``) on the CPU,
held to the reference's ``tools/tuning_report.py``.

- a profile saved by the port reports the reference's knobs, calibrated
  and static values, and probes (the reference reads the same blob under
  its own substrate's file name: the blob's format is shared, the
  substrate keys are not);
- a corrupted blob reports ``quarantined`` in both;
- ``controller_report`` on a service with the controller and on one
  without (``DEEQU_TPU_AUTOTUNE=0``), with the reference's keys;
- ``main --json`` and ``--snapshot`` round-trip;
- ``bench_point`` returns the reference's keys.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

from tools import torch_tuning_report as report_tool
from tools import tuning_report as ref_tool

pytestmark = pytest.mark.tuning

#: one derived value for every knob of the registry, inside its bounds
KNOB_VALUES = {
    "coalesce_max_width": 4,
    "device_freq_max_cardinality": 131072,
    "fast_path_max_rows": 8192,
    "fleet_stream_min_rows": 32768,
    "freq_buffer_entries": 1 << 24,
    "freq_host_route_max_distinct": 16384,
    "freq_host_route_min_rows": 1 << 20,
    "freq_probe_rows": 32768,
    "freq_table_slots": 1 << 21,
    "prefetch_depth": 1,
    "router_device_fixed_s": 0.00134,
    "router_device_rows_per_s": 7.45e8,
    "router_host_rows_per_s": 3.1e7,
}
#: knobs whose static default the port changed on purpose: the feed's
#: depth is 0 in the port (depth 2 measured no gain on the card)
PORT_STATIC_DEFAULTS = {"prefetch_depth": 0}


@pytest.fixture(autouse=True)
def _clean_tuning(monkeypatch, tmp_path):
    from deequ_tpu.tuning import knobs as ref_knobs
    from deequ_tpu_torch.tuning import knobs

    for env in (knobs.AUTOTUNE_ENV, "DEEQU_TPU_FAST_PATH_MAX_ROWS"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv(knobs.TUNING_PROFILE_DIR_ENV, str(tmp_path / "boot-profiles"))
    knobs.clear_tuned()
    ref_knobs.clear_tuned()
    yield
    knobs.clear_tuned()
    ref_knobs.clear_tuned()


def _saved_pair(tmp_path):
    """A profile saved by the port in ``port``, and the same file under the
    reference's substrate name in ``ref``."""
    from deequ_tpu.tuning import profile as ref_profile
    from deequ_tpu_torch.tuning import profile

    prof = profile.SubstrateProfile(
        substrate=profile.substrate_key("cpu"),
        probes={"device_fixed_s": 0.00134, "device_rows_per_s": 7.45e8,
                "host_rows_per_s": 3.1e7, "device_stack_slope_s": 2.5e-6},
        knob_values=dict(KNOB_VALUES), created_at=1_700_000_000.0, calibration_wall_s=0.15,
    )
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    path = profile.save_profile(prof, str(port_dir))
    os.makedirs(ref_dir)
    shutil.copy(path, ref_dir / f"profile-{ref_profile.substrate_fingerprint()}.json")
    return str(port_dir), str(ref_dir)


def test_profile_report_is_the_references(tmp_path):
    port_dir, ref_dir = _saved_pair(tmp_path)
    got = report_tool.profile_report(port_dir, device="cpu")
    want = ref_tool.profile_report(ref_dir)
    assert got["substrate"]["engine"] == "torch" and got["profile_dir"] == port_dir
    assert sorted(got) == sorted(want)
    mine, theirs = got["profile"], want["profile"]
    assert sorted(mine["knobs"]) == sorted(theirs["knobs"]) == sorted(KNOB_VALUES)
    for name, row in mine["knobs"].items():
        assert row["calibrated"] == theirs["knobs"][name]["calibrated"] == KNOB_VALUES[name]
        assert row["static"] == PORT_STATIC_DEFAULTS.get(name, theirs["knobs"][name]["static"])
    assert mine["probes"] == theirs["probes"]
    assert (mine["created_at"], mine["calibration_wall_s"]) == (
        theirs["created_at"], theirs["calibration_wall_s"])
    assert report_tool.render_text(got).splitlines()[2:] != []


def test_a_corrupted_profile_reports_quarantined(tmp_path):
    port_dir, ref_dir = _saved_pair(tmp_path)
    for directory in (port_dir, ref_dir):
        [name] = [n for n in os.listdir(directory) if n.endswith(".json")]
        path = os.path.join(directory, name)
        with open(path) as fh:
            record = json.load(fh)
        record["payload"]["probes"]["device_fixed_s"] = -1.0
        with open(path, "w") as fh:
            json.dump(record, fh)
    got = report_tool.profile_report(port_dir, device="cpu")
    want = ref_tool.profile_report(ref_dir)
    for report in (got, want):
        assert report["profile"] is None
        assert "content checksum" in report["quarantined"]
    assert len(os.listdir(os.path.join(port_dir, ".quarantine"))) == 1
    assert "PROFILE QUARANTINED" in report_tool.render_text(got)
    # nothing left to load: the next report finds no profile
    assert report_tool.profile_report(port_dir, device="cpu")["profile"] is None


@pytest.mark.parametrize("autotune", [True, False])
def test_controller_report_with_and_without_a_controller(autotune, monkeypatch):
    from deequ_tpu.service import VerificationService as RefService
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.tuning import knobs

    if not autotune:
        monkeypatch.setenv(knobs.AUTOTUNE_ENV, "0")
    with VerificationService(workers=1, background_warm=False, device="cpu") as svc:
        got = report_tool.controller_report(svc)
    with RefService(workers=1, background_warm=False, fleet=False) as ref_svc:
        want = ref_tool.controller_report(ref_svc)
    assert sorted(got) == sorted(want)
    assert got["enabled"] is want["enabled"] is autotune
    assert got["series"] == want["series"] == dict.fromkeys(report_tool.TUNING_SERIES, 0)
    if autotune:
        assert got["decisions"] == [] and got["experiments"] == {} and got["tuned"] == {}
    assert report_tool.controller_report(object()) == {"enabled": False}


def test_main_json_and_snapshot_round_trip(tmp_path, capsys):
    port_dir, _ = _saved_pair(tmp_path)
    assert report_tool.main(["--json", "--dir", port_dir, "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(report_tool.profile_report(port_dir, device="cpu")))

    snapshot = {"decisions": [{"knob": "fast_path_max_rows", "verdict": "floor_demotion"}],
                "tuned": {}, "live_samples": 3}
    snap_path = tmp_path / "snapshot.json"
    snap_path.write_text(json.dumps(snapshot))
    assert report_tool.main(["--json", "--dir", port_dir, "--device", "cpu",
                             "--snapshot", str(snap_path)]) == 0
    assert json.loads(capsys.readouterr().out)["controller"] == snapshot
    assert report_tool.main(["--dir", port_dir, "--device", "cpu",
                             "--snapshot", str(snap_path)]) == 0
    text = capsys.readouterr().out
    assert "coalesce_max_width" in text
    assert text.rstrip().endswith("controller: 1 decision(s), 0 tuned knob(s)")


def test_bench_point_has_the_references_keys():
    got = report_tool.bench_point(sessions=4, rows=512, group_rows=4096, device="cpu")
    want = ref_tool.bench_point(sessions=4, rows=512, group_rows=4096)
    assert sorted(got) == sorted(want)
    assert (got["sessions"], got["rows"], got["group_rows"]) == (4, 512, 4096)
    assert got["sessions_per_s"] > 0 and got["grouping_rows_per_s"] > 0
    assert got["autotune"] is want["autotune"] is True
    assert got["tuned_knobs"] == want["tuned_knobs"] == []
