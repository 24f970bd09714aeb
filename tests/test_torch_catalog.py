"""The tenant catalog of the PyTorch/CUDA port
(deequ_tpu_torch.service.catalog, the scheduler's tenant quotas, the
ingest endpoint's catalog auto-open) against the JAX reference: the cases
of ``tests/test_catalog.py`` run through both packages (``m`` is either
package, its service on the CPU), and a catalog root written by either
package loads in the other with the same documents, file for file.

Tolerances: none are needed — documents, versions, counters and HTTP
statuses are compared exactly, and the metrics of a session the catalog
opened equal the reference's session's bit for bit (moments within 1e-12
relative).
"""

import json
import os
import time

import numpy as np
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)


pytestmark = pytest.mark.catalog

NAMES = {
    'CatalogError': 'service:CatalogError',
    'CatalogPlane': 'service:CatalogPlane',
    'Priority': 'service.scheduler:Priority',
    'QuotaExceeded': 'service:QuotaExceeded',
    'ServiceMetrics': 'service.metrics:ServiceMetrics',
    'TenantCatalog': 'service:TenantCatalog',
    'TenantQuota': 'service:TenantQuota',
    'VerificationService': 'service:VerificationService',
    'encode_ipc_stream': 'ingest:encode_ipc_stream',
    'metrics': 'metrics',
}
REF, PORT = pair(NAMES)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def _doc(priority="normal", max_len=3, quotas=None, watches=False):
    doc = {
        "checks": [{"name": "base", "constraints": [
            {"kind": "complete", "column": "id"},
            {"kind": "min", "column": "v", "min": 0},
        ]}],
        "row_gate": {"columns": [
            {"name": "id", "type": "int", "nullable": False},
            {"name": "s", "type": "string", "max_length": max_len},
        ]},
        "priority": priority,
    }
    if quotas is not None:
        doc["quotas"] = quotas
    if watches:
        doc["watches"] = [{
            "analyzer": {"kind": "mean", "column": "v"},
            "strategy": {"kind": "simple_threshold", "upper_bound": 1e9},
        }]
    return doc


def _frame(rows=3, start=0, s="ab"):
    return {
        "id": np.arange(start, start + rows),
        "s": np.array([s] * rows),
        "v": np.ones(rows, dtype=np.float64),
    }


@pytest.fixture
def catalog(m, tmp_path):
    return m.TenantCatalog(str(tmp_path / "catalog"))


@pytest.fixture
def service(m, catalog):
    with m.VerificationService(
        workers=2, max_queue_depth=32, background_warm=False,
        catalog=catalog, **m.svc,
    ) as svc:
        yield svc


class TestTenantCatalog:
    def test_register_versions_and_load(self, m, catalog):
        d1 = catalog.register("acme", _doc())
        d2 = catalog.register("acme", _doc(priority="high"))
        assert (d1.version, d2.version) == (1, 2)
        assert catalog.registered("acme")
        assert not catalog.registered("ghost")
        assert catalog.current_version("acme") == 2
        loaded = catalog.load("acme")
        assert loaded.version == 2
        assert loaded.doc["priority"] == "high"

    def test_invalid_document_bounces_at_register(self, m, catalog):
        with pytest.raises(m.CatalogError, match="constraint"):
            catalog.register("t", {"checks": [
                {"name": "x", "constraints": [{"kind": "no-such-kind"}]}
            ]})
        with pytest.raises(m.CatalogError):
            catalog.register("t", {"row_gate": {"columns": [
                {"name": "c", "type": "no-such-type"}
            ]}})
        # an invalid regex validates structurally but cannot BUILD —
        # it must bounce at registration, not on the ingest path
        with pytest.raises(m.CatalogError):
            catalog.register("t", {"checks": [{"name": "x", "constraints": [
                {"kind": "pattern", "column": "c", "pattern": "(unclosed"}
            ]}]})
        assert not catalog.registered("t")  # nothing was written

    def test_unregistered_tenant_load_is_typed(self, m, catalog):
        with pytest.raises(m.CatalogError, match="ghost"):
            catalog.load("ghost")

    def test_corrupt_edit_serves_last_good_quarantines_once(
        self, m, catalog, tmp_path
    ):

        catalog.metrics = m.ServiceMetrics()
        catalog.register("acme", _doc())
        catalog.register("acme", _doc(priority="high"))
        # a torn write lands as version 3
        tdir = os.path.join(str(tmp_path / "catalog"), "t-acme")
        with open(os.path.join(tdir, "v00000003.json"), "w") as fh:
            fh.write('{"torn": tru')
        for _ in range(3):  # repeated loads must not re-quarantine
            loaded = catalog.load("acme")
            assert loaded.version == 2
            assert loaded.doc["priority"] == "high"
        assert catalog.metrics.counter_value(
            "deequ_service_catalog_quarantined_total", tenant="acme"
        ) == 1
        qdir = str(tmp_path / "catalog") + ".quarantine"
        names = os.listdir(qdir)
        assert len(names) == 1 and names[0].startswith("v00000003.json-")

    def test_tampered_checksum_quarantined(self, m, catalog, tmp_path):
        catalog.register("acme", _doc())
        tdir = os.path.join(str(tmp_path / "catalog"), "t-acme")
        path = os.path.join(tdir, "v00000001.json")
        with open(path) as fh:
            payload = json.load(fh)
        payload["doc"]["priority"] = "high"  # edit without re-checksumming
        with open(path, "w") as fh:
            json.dump(payload, fh)
        with pytest.raises(m.CatalogError, match="no servable document"):
            catalog.load("acme")

    def test_registered_scale_is_listing_only(self, m, catalog):
        """1M registered / 1k active must cost 1k tenants: registration
        writes one file; current_version is a pure listing, no parse."""
        for i in range(50):
            catalog.register(f"t{i:03d}", _doc())
        assert catalog.registered_count() == 50
        assert sorted(catalog.tenants())[0] == "t000"
        assert catalog.current_version("t007") == 1


class TestCatalogPlane:
    def test_materialize_from_document(self, m, service, catalog):
        catalog.register("acme", _doc(priority="high",
                                      quotas={"rows_per_s": 1e6}))
        plane = service.catalog_plane
        session = plane.ensure_session("acme", "clicks")

        assert session.priority is m.Priority.HIGH
        assert session.row_gate is not None
        assert service.scheduler.get_quota("acme") == m.TenantQuota(
            rows_per_s=1e6
        )
        r = session.ingest(_frame())
        assert r.status.name == "SUCCESS"
        assert plane.hot_count() == 1
        assert plane.ensure_session("acme", "clicks") is session

    def test_ensure_session_unregistered_is_typed(self, m, service):
        with pytest.raises(m.CatalogError):
            service.catalog_plane.ensure_session("ghost", "d")

    def test_hot_reload_at_fold_boundary(self, m, service, catalog):
        catalog.register("acme", _doc(priority="high"))
        plane = service.catalog_plane
        plane.poll_s = 0.0  # poll every fold boundary
        session = plane.ensure_session("acme", "clicks")
        session.ingest(_frame())
        catalog.register("acme", _doc(priority="low", max_len=10))
        plane.on_fold_boundary(session)

        assert session.priority is m.Priority.LOW
        # the new gate (max_len=10) is live: a frame the old gate would
        # have quarantined now folds
        session.ingest(_frame(s="longer-now", start=100))
        assert service.metrics.counter_value(
            "deequ_service_catalog_reloads_total", tenant="acme"
        ) == 1

    def test_corrupt_edit_keeps_live_config(self, m, service, catalog, tmp_path):
        catalog.register("acme", _doc(priority="high"))
        plane = service.catalog_plane
        plane.poll_s = 0.0
        session = plane.ensure_session("acme", "clicks")
        tdir = os.path.join(catalog.path, "t-acme")
        with open(os.path.join(tdir, "v00000002.json"), "w") as fh:
            fh.write("not json at all")
        plane.on_fold_boundary(session)

        assert session.priority is m.Priority.HIGH  # unchanged
        assert service.metrics.counter_value(
            "deequ_service_catalog_reloads_total", tenant="acme"
        ) == 0
        assert service.metrics.counter_value(
            "deequ_service_catalog_quarantined_total", tenant="acme"
        ) == 1

    def test_ttl_eviction_to_cold_and_rematerialization(
        self, m, service, catalog
    ):
        catalog.register("acme", _doc())
        plane = service.catalog_plane
        session = plane.ensure_session("acme", "clicks")
        session.ingest(_frame())
        assert plane.sweep() == 0  # fresh: not idle yet
        plane.hot_ttl_s = 0.0
        assert plane.sweep() == 1
        assert plane.hot_count() == 0
        assert session.closed
        assert catalog.registered("acme")  # cold, not gone
        # next ensure re-materializes a fresh session from the document
        plane.hot_ttl_s = 300.0
        again = plane.ensure_session("acme", "clicks")
        assert again is not session and not again.closed


class TestAdmissionBudgets:
    def test_over_quota_shed_typed_neighbor_unaffected(self, m, service):
        service.scheduler.set_quota("hog", m.TenantQuota(rows_per_s=50))
        hog = service.session("hog", "d", [])
        neighbor = service.session("calm", "d", [])
        with pytest.raises(m.QuotaExceeded) as exc_info:
            for i in range(5):
                hog.ingest(_frame(rows=40, start=i * 40), block_s=0.0)
        assert exc_info.value.tenant == "hog"
        assert exc_info.value.resource == "rows_per_s"
        assert service.metrics.counter_value(
            "deequ_service_quota_shed_total", tenant="hog",
            resource="rows_per_s",
        ) >= 1
        for i in range(5):  # the neighbor has no quota: all 5 fold
            neighbor.ingest(_frame(rows=40, start=i * 40))
        assert neighbor.rows_ingested == 200

    def test_quota_raise_does_not_inherit_debt(self, m, service):
        service.scheduler.set_quota("t", m.TenantQuota(rows_per_s=10))
        # the deficit bucket admits the first over-burst charge (going
        # into debt) and refuses the next until the debt drains
        service.scheduler.charge_quota("t", rows=100, block_s=0.0)
        with pytest.raises(m.QuotaExceeded):
            service.scheduler.charge_quota("t", rows=100, block_s=0.0)
        service.scheduler.set_quota("t", m.TenantQuota(rows_per_s=1e6))
        service.scheduler.charge_quota("t", rows=100, block_s=0.0)

    def test_queue_share_shed_typed(self, m):
        with m.VerificationService(
            workers=1, max_queue_depth=8, background_warm=False, **m.svc,
        ) as svc:
            svc.scheduler.set_quota("t", m.TenantQuota(queue_share=0.25))
            # stall the single worker so submissions pile up
            import threading

            gate = threading.Event()
            svc.scheduler.submit(lambda ctx: gate.wait(10), tenant="x")
            time.sleep(0.05)
            svc.scheduler.submit(lambda ctx: None, tenant="t")
            svc.scheduler.submit(lambda ctx: None, tenant="t")
            with pytest.raises(m.QuotaExceeded) as exc_info:
                svc.scheduler.submit(
                    lambda ctx: None, tenant="t", block_s=0.0
                )
            assert exc_info.value.resource == "queue_share"
            gate.set()


class TestEndpointAutoOpen:
    def _post(self, exporter, path, body, headers=None):
        import http.client

        conn = http.client.HTTPConnection(
            exporter.host, exporter.port, timeout=30
        )
        try:
            conn.request("POST", path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode())
        finally:
            conn.close()

    def _payload(self, m, rows=3, s="ab"):
        import pyarrow as pa


        f = _frame(rows=rows, s=s)
        return m.encode_ipc_stream(pa.table({
            k: pa.array(v) for k, v in f.items()
        }))

    def test_registered_tenant_auto_opens(self, m, service, catalog):
        catalog.register("acme", _doc())
        exporter = service.start_exporter()
        assert service.get_session("acme", "clicks") is None
        status, body = self._post(
            exporter, "/ingest/v1/acme/clicks", self._payload(m)
        )
        assert status == 200 and body["rows"] == 3
        session = service.get_session("acme", "clicks")
        assert session is not None and session.row_gate is not None

    def test_unregistered_stays_404(self, m, service):
        """The endpoint's documented contract survives the catalog: an
        UNREGISTERED tenant is still 404, never auto-created."""
        exporter = service.start_exporter()
        status, body = self._post(
            exporter, "/ingest/v1/ghost/clicks", self._payload(m)
        )
        assert status == 404 and body["error"] == "unknown_session"
        assert service.get_session("ghost", "clicks") is None

    def test_fully_rejected_frame_is_422(self, m, service, catalog):
        catalog.register("acme", _doc(max_len=3))
        exporter = service.start_exporter()
        status, body = self._post(
            exporter, "/ingest/v1/acme/clicks",
            self._payload(m, s="way-too-long"),
        )
        assert status == 422 and body["error"] == "frame_quarantined"

    def test_over_quota_is_429_with_resource(self, m, service, catalog):
        doc = _doc(quotas={"rows_per_s": 5})
        doc["session"] = {"admission_block_s": 0.0}
        catalog.register("acme", doc)
        exporter = service.start_exporter()
        last = None
        for i in range(4):
            last = self._post(
                exporter, "/ingest/v1/acme/clicks", self._payload(m, rows=4)
            )
            if last[0] == 429:
                break
        status, body = last
        assert status == 429
        assert body["error"] == "quota_exceeded"
        assert body["resource"] == "rows_per_s"

    def test_unservable_catalog_is_503(self, m, service, catalog, tmp_path):
        catalog.register("acme", _doc())
        # tamper the ONLY version: registered but nothing servable
        tdir = os.path.join(catalog.path, "t-acme")
        with open(os.path.join(tdir, "v00000001.json"), "w") as fh:
            fh.write("garbage")
        exporter = service.start_exporter()
        status, body = self._post(
            exporter, "/ingest/v1/acme/clicks", self._payload(m)
        )
        assert status == 503 and body["error"] == "catalog_error"



@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_catalog_root_written_by_either_package_loads_in_the_other(writer, tmp_path):
    """Versions, checksums and the quarantine sidecar are the reference's
    layout byte for byte: the other package loads the writer's documents,
    quarantines the same torn version, and serves the same last-good."""
    first, second = (REF, PORT) if writer == "jax" else (PORT, REF)
    root = str(tmp_path / "catalog")
    written = first.TenantCatalog(root)
    written.register("acme", _doc())
    written.register("acme", _doc(priority="high", quotas={"rows_per_s": 5}))
    written.register("team/b", _doc(watches=True))
    with open(os.path.join(root, "t-acme", "v00000003.json"), "w") as fh:
        fh.write('{"torn": tru')
    reader = second.TenantCatalog(root)
    assert sorted(reader.tenants()) == ["acme", "team/b"]
    loaded = reader.load("acme")
    assert (loaded.version, loaded.doc) == (2, _doc(priority="high", quotas={"rows_per_s": 5}))
    assert reader.load("team/b").doc == _doc(watches=True)
    assert os.listdir(root + ".quarantine")[0].startswith("v00000003.json-")
    assert first.TenantCatalog(root).load("acme").version == 2


def test_both_packages_write_the_same_bytes(tmp_path):
    for m in (REF, PORT):
        catalog = m.TenantCatalog(str(tmp_path / m.name))
        catalog.register("acme", _doc(quotas={"queue_share": 0.5}))
        catalog.register("acme", _doc(priority="low", watches=True))
    for name in ("v00000001.json", "v00000002.json"):
        with open(tmp_path / "jax" / "t-acme" / name, "rb") as a, \
                open(tmp_path / "torch" / "t-acme" / name, "rb") as b:
            assert a.read() == b.read()


def _metric_values(result):
    return {repr(a): mt.value.get() for a, mt in result.metrics.items()}


def test_a_catalog_session_folds_the_reference_metrics(tmp_path, monkeypatch):
    """A session the catalog materialized (checks, gate, quota, priority
    from the document) folds the same frames to the reference's metrics:
    the gate rejects the same rows in both packages and the port's states
    stay on their device across the hot reload."""
    monkeypatch.setenv("DEEQU_TPU_COALESCE", "0")
    rng = np.random.default_rng(14)
    frames = []
    for i in range(3):
        f = _frame(rows=64, start=64 * i)
        f["v"] = rng.normal(5.0, 2.0, 64)
        f["s"] = np.array(["ab", "abcdef"] * 32)  # half fail max_length=3
        frames.append(f)
    got = {}
    for m in (REF, PORT):
        catalog = m.TenantCatalog(str(tmp_path / m.name))
        catalog.register("acme", _doc(quotas={"rows_per_s": 1e9}))
        with m.VerificationService(workers=1, background_warm=False, catalog=catalog,
                                   **m.svc) as svc:
            plane = svc.catalog_plane
            plane.poll_s = 0.0
            session = plane.ensure_session("acme", "clicks")
            results = [session.ingest(frames[0]), session.ingest(frames[1])]
            catalog.register("acme", _doc(max_len=10))
            plane.on_fold_boundary(session)
            results.append(session.ingest(frames[2]))
            got[m.name] = ([_metric_values(r) for r in results], session.rows_ingested,
                           svc.metrics.counter_value("deequ_service_rowgate_rejected_rows_total",
                                                     tenant="acme", dataset="clicks"))
    (want, want_rows, want_rejected), (have, have_rows, have_rejected) = got["jax"], got["torch"]
    assert (have_rows, have_rejected) == (want_rows, want_rejected) == (64 + 64 + 64 - 64, 64)
    for w, h in zip(want, have):
        assert set(w) == set(h)
        for key in w:
            assert h[key] == pytest.approx(w[key], rel=1e-12, abs=0.0), key
