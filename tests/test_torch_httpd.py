"""The port's metrics server and shipper against the JAX package's.

* The server on port 0 answers every route: ``/metrics``,
  ``/metrics.json``, ``/healthz`` (503 with its JSON on CRIT),
  ``/flight``, ``/requests``, ``/roofline``, ``/memory``, ``/slo``,
  ``/tenants``; anything else gets the reference's 404 text. The
  ``/slo``, ``/tenants`` and ``/roofline`` bodies equal the reference
  server's on the same feeds.
* ``/profile`` answers 400 on bad input and 409 while a capture runs as
  the reference's does, 500 with both locks released when the capture
  fails, and a real CPU capture with ``torch.profiler`` writes a
  Chrome-trace JSON into ``PT_PROFILE_DIR`` holding the operators of
  another thread.
* The shipper ships the reference's deltas, rotates its files, refreshes
  the device-memory gauges, and starts and stops its thread.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import paddle_tpu.observability.httpd as j_httpd
import paddle_tpu.observability.shipper as j_shipper
import paddle_tpu.serving.telemetry  # noqa: F401  (registers the metrics)
from paddle_tpu.observability import GOODPUT as J_GOODPUT
from paddle_tpu.observability import METRICS as J_METRICS
from paddle_tpu.observability import roofline as j_roof
from paddle_tpu.observability import slo as j_slo
from paddle_tpu_torch.core.device import CAPTURE_LOCK
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS, httpd, roofline,
                                            shipper, slo)
from paddle_tpu_torch.serving import telemetry as TEL


def _get(url, timeout=30):
    """(status, body text) — error statuses arrive as HTTPError with the
    same body."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        METRICS.reset()
        FLIGHT.clear()
        REQUESTS.disable()
        REQUESTS.clear()
        GOODPUT.attach_sink(None)
        TEL.reset_tenant_labels()
        roofline.reset_serving_roofline()
        j_roof.reset_serving_roofline()
    clean()
    yield
    clean()


@pytest.fixture()
def servers():
    """(reference server, port server), both on free ports."""
    js = j_httpd.MetricsServer(port=0, host="127.0.0.1")
    ts = httpd.MetricsServer(port=0, host="127.0.0.1")
    yield (f"http://127.0.0.1:{js.port}", f"http://127.0.0.1:{ts.port}")
    js.stop()
    ts.stop()


ROUTES = ("/metrics", "/metrics.json", "/healthz", "/flight", "/requests",
          "/roofline", "/memory", "/slo", "/tenants")


@pytest.mark.parametrize("route", ROUTES)
def test_every_route_answers(servers, route):
    TEL._TOKENS.inc(3)
    status, body = _get(servers[1] + route)
    assert status == 200, body
    if route == "/metrics":
        assert "serving_tokens_total 3" in body
    else:
        doc = json.loads(body)
        if route == "/memory":
            assert "pools" in doc and "cpu" in doc["device"]
        if route == "/healthz":
            assert doc["status"] == "OK"


def test_healthz_is_503_with_its_json_on_crit(servers):
    TEL._DEGRADE_LEVEL.set(4)
    J_METRICS.get("serving_degrade_level").set(4)
    docs = []
    for base in servers:
        status, body = _get(base + "/healthz")
        assert status == 503
        docs.append(json.loads(body))
    assert docs[1] == docs[0]
    assert docs[1]["status"] == "CRIT"


@pytest.mark.parametrize("path", ["/nope", "/", "/metrics/x", "/PROFILE"])
def test_unknown_path_gives_the_reference_404(servers, path):
    got = [_get(base + path) for base in servers]
    assert got[1] == got[0]
    assert got[1][0] == 404
    for route in ROUTES + ("/profile?seconds=N",):
        assert route in got[1][1]


def _only(doc, seq):
    (snap,) = [s for s in doc["trackers"] if s["tracker"] == seq]
    snap = dict(snap)
    snap.pop("tracker")
    return snap


def test_slo_and_tenants_bodies_equal_the_reference(servers):
    trackers = []
    for m, reg, g in ((j_slo, J_METRICS, J_GOODPUT), (slo, METRICS, GOODPUT)):
        clock = iter([0.0, 1.0, 2.0]).__next__
        t = m.SLOTracker({"*": [m.Objective("availability", target=0.99)],
                          "acme": [m.Objective("ttft_p95", target=0.1)]},
                         clock=clock)
        t.poll()
        reg.get("serving_tenant_finished_total").inc(
            9, tenant="acme", reason="eos")
        reg.get("serving_tenant_finished_total").inc(
            1, tenant="acme", reason="timeout")
        reg.get("serving_tenant_ttft_seconds").observe(0.3, tenant="acme")
        t.poll()
        g.good(7, tenant="acme")
        g.waste("spec_rejected", 3, tenant="acme")
        g.saved(2, tenant=None)
        trackers.append(t)
    for route in ("/slo", "/tenants"):
        docs = []
        for base, t in zip(servers, trackers):
            status, body = _get(base + route)
            assert status == 200
            doc = json.loads(body)
            assert doc["enabled"] is True
            docs.append(_only(doc, t.seq))
        assert docs[1] == docs[0], route
    assert docs[1]["tenants"]["acme"]["good_tokens"] == 7


def test_roofline_body_equals_the_reference(servers):
    docs = []
    for m in (j_roof, roofline):
        g = m.ModelGeometry(num_layers=2, hidden=8, intermediate=16,
                            vocab=32, heads=2, kv_heads=1, head_dim=4)
        for phase, sec in (("decode", 1.0), ("prefill", 0.5)):
            m.record_serving_throughput(
                phase, seconds=sec, tokens=4, weight_passes=1,
                kv_read_positions=16, geom=g, peak_flops=989e12,
                peak_hbm_bps=3.35e12)
    for base in servers:
        status, body = _get(base + "/roofline")
        assert status == 200
        docs.append(json.loads(body))
    assert docs[1] == docs[0]
    assert docs[1]["phases"]["decode"]["bound"] == "bandwidth-bound"


# ---------------------------------------------------------------- profile
@pytest.mark.parametrize("query", ["", "?seconds=", "?seconds=abc",
                                   "?seconds=0", "?seconds=-3",
                                   "?seconds=601", "?seconds=nan"])
def test_profile_bad_seconds_is_400_as_the_reference(servers, query):
    got = [_get(base + "/profile" + query) for base in servers]
    assert got[1] == got[0]
    assert got[1][0] == 400


def test_profile_second_capture_while_busy_is_409(servers, monkeypatch):
    release, started = threading.Event(), threading.Event()

    def fake_capture(seconds):
        started.set()
        assert release.wait(timeout=10)
        return {"dir": "fake", "seconds": seconds}

    monkeypatch.setattr(httpd, "_run_profile_capture", fake_capture)
    base = servers[1]
    first = {}
    t = threading.Thread(
        target=lambda: first.update(resp=_get(base + "/profile?seconds=1")),
        name="pt-test-profile")
    t.start()
    try:
        assert started.wait(timeout=10)
        status, body = _get(base + "/profile?seconds=1")
        assert status == 409 and "already running" in body
    finally:
        release.set()
        t.join(timeout=10)
    assert first["resp"][0] == 200
    status, body = _get(base + "/profile?seconds=1")
    assert status == 200 and json.loads(body)["dir"] == "fake"


def test_profile_failure_is_500_and_releases_both_locks(servers, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("PT_PROFILE_DIR", str(tmp_path))

    def boom(*a, **k):
        raise RuntimeError("no backend")

    # fail inside the real capture, after the capture lock is taken
    monkeypatch.setattr(torch.profiler, "profile", boom)
    status, body = _get(servers[1] + "/profile?seconds=0.1")
    assert status == 500 and "RuntimeError: no backend" in body
    assert httpd._PROFILE_LOCK.acquire(blocking=False)
    httpd._PROFILE_LOCK.release()
    got = []
    t = threading.Thread(target=lambda: got.append(
        CAPTURE_LOCK.acquire(timeout=1) and CAPTURE_LOCK.release() is None))
    t.start()
    t.join()
    assert got == [True]                     # free for another thread
    monkeypatch.setattr(httpd, "_run_profile_capture",
                        lambda s: {"dir": "ok", "seconds": s})
    assert _get(servers[1] + "/profile?seconds=1")[0] == 200


def test_profile_real_cpu_capture_writes_a_chrome_trace(servers, tmp_path,
                                                        monkeypatch):
    """A real 0.3 s capture while another thread runs matmuls: 200, the
    JSON names the trace, which parses and holds that thread's
    operators (where the profiler takes ``profile_all_threads``)."""
    out = tmp_path / "cap"
    monkeypatch.setenv("PT_PROFILE_DIR", str(out))
    stop = threading.Event()

    def work():
        x = torch.randn(32, 32)
        while not stop.is_set():
            torch.mm(x, x)
            time.sleep(0.001)

    w = threading.Thread(target=work, name="pt-test-work")
    w.start()
    try:
        t0 = time.monotonic()
        status, body = _get(servers[1] + "/profile?seconds=0.3",
                            timeout=240)
    finally:
        stop.set()
        w.join()
    assert status == 200, body
    assert time.monotonic() - t0 >= 0.3
    doc = json.loads(body)
    assert doc["dir"] == str(out) and doc["seconds"] == 0.3
    assert doc["cuda"] is False and doc["wall_s"] >= 0.3 + doc["start_s"]
    assert os.path.dirname(doc["trace"]) == str(out)
    assert os.path.getsize(doc["trace"]) == doc["bytes"] > 0
    with open(doc["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    if doc["all_threads"]:
        assert "aten::mm" in names


def test_module_default_server_starts_once_and_stops():
    a = httpd.start_metrics_server(port=0, host="127.0.0.1")
    try:
        assert httpd.start_metrics_server(port=0) is a
        assert a.url.endswith(f":{a.port}/metrics")
        assert _get(a.url)[0] == 200
    finally:
        httpd.stop_metrics_server()
    httpd.stop_metrics_server()                  # idempotent


# ---------------------------------------------------------------- shipper
def test_shipper_ships_the_reference_deltas(tmp_path):
    shippers = (j_shipper.MetricsShipper(tmp_path / "j.jsonl"),
                shipper.MetricsShipper(tmp_path / "t.jsonl"))
    recs = [[], []]
    for step in range(3):
        for reg in (J_METRICS, METRICS):
            reg.get("serving_tokens_total").inc(5 + step)
            reg.get("serving_tick_seconds").observe(0.01 * (step + 1))
            reg.get("serving_rejections_total").inc(reason="degraded")
        for side, s in enumerate(shippers):
            recs[side].append(s.ship_now())
    for jr, tr in zip(*recs):
        assert tr["deltas"] == pytest.approx(jr["deltas"])
        assert tr["seq"] == jr["seq"]
    assert recs[1][0]["deltas"] == {}            # first line: no baseline
    assert recs[1][2]["deltas"]["serving_tokens_total"] == 7
    gauges = recs[1][-1]["snapshot"]["gauges"]
    assert 'device_bytes_in_use{device="cpu"}' in gauges
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert [json.loads(ln)["seq"] for ln in lines] == [0, 1, 2]


def test_shipper_rotates_its_ring(tmp_path):
    path = tmp_path / "m.jsonl"
    s = shipper.MetricsShipper(path, max_bytes=200, max_files=3)
    for _ in range(6):
        METRICS.get("serving_tokens_total").inc()
        s.ship_now()
    names = sorted(os.listdir(tmp_path))
    assert names == ["m.jsonl", "m.jsonl.1", "m.jsonl.2"]
    one = shipper.MetricsShipper(tmp_path / "one.jsonl", max_bytes=10,
                                 max_files=1)
    one.ship_now()
    one.ship_now()
    assert len((tmp_path / "one.jsonl").read_text().splitlines()) == 1
    with pytest.raises(ValueError):
        shipper.MetricsShipper(tmp_path / "x", max_files=0)


def test_shipper_thread_starts_ships_and_stops(tmp_path):
    path = tmp_path / "bg.jsonl"
    s = shipper.start_metrics_shipper(str(path), interval_s=0.05)
    try:
        assert shipper.start_metrics_shipper(str(path)) is s
        assert any(t.name == "pt-metrics-shipper"
                   for t in threading.enumerate())
        deadline = time.monotonic() + 10
        while s.shipped < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s.shipped >= 2 and s.errors == 0
    finally:
        shipper.stop_metrics_shipper()
    n = len(path.read_text().splitlines())
    assert n == s.shipped                        # stop shipped the tail
    assert not any(t.name == "pt-metrics-shipper" and t.is_alive()
                   for t in threading.enumerate())
    with shipper.MetricsShipper(tmp_path / "ctx.jsonl",
                                interval_s=10.0) as c:
        pass
    assert c.shipped == 1
