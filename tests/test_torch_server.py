"""The port's HTTP front-end (`serve/server.py`) against the
reference's: the payload boundary gives the reference's requests and
its 400 messages for the same malformed payloads, and a live server on
port 0 (on the CPU) answers a search with the direct search's result,
streams its events, dedups, refuses what cannot run with a 400, and
serves stats, Prometheus metrics and the request's span tree."""
import json
import urllib.error
import urllib.request

import pytest
import torch

from _torch_parity import port_workload
from repro.core.problem import Layer, Workload
from repro.serve import server as ref_server
from repro_torch.core.search import SearchConfig, dosa_search
from repro_torch.serve import server as port_server
from repro_torch.serve.cosearch_service import ServiceConfig

WL_JSON = {"name": "t", "layers": [{"matmul": [16, 16, 16], "name": "a"}]}
CFG_JSON = {"steps": 4, "round_every": 2, "n_start_points": 2, "seed": 21}
MALFORMED = [
    [1, 2],
    {"workload": WL_JSON, "bogus": 1},
    {},
    {"workload": {"layers": []}},
    {"workload": {"layers": [{"dims": [1, 2]}]}},
    {"workload": {"layers": [{"nope": 1}]}},
    {"workload": WL_JSON, "config": {"stepz": 4}},
    {"workload": WL_JSON, "config": {"steps": "many"}},
    {"workload": WL_JSON, "config": {"spec": "hal9000"}},
    {"workload": WL_JSON, "config": {"ordering_mode": "wat"}},
    {"workload": WL_JSON, "priority": "high"},
    {"workload": WL_JSON, "deadline_s": -1},
    {"workload": WL_JSON, "request_id": 7},
    {"workload": {"layers": [{"dims": [0, 1, 1, 1, 1, 1, 1]}]}},
    {"workload": WL_JSON, "config": {"steps": 0}},
]


# ---------------------------------------------------------------------------
# The payload boundary
# ---------------------------------------------------------------------------

def test_parse_payload_matches_reference():
    body = {"workload": {"name": "n", "layers": [
        {"matmul": [16, 16, 16], "name": "a"},
        {"conv": [8, 16, 3, 8], "stride": 2},
        {"dims": [1, 1, 8, 1, 8, 8, 1], "repeat": 2}]},
        "config": dict(CFG_JSON, spec="tpu_v5e", lr=1),
        "priority": 2, "segment_budget": 3}
    ref = ref_server.parse_search_payload(body)
    got = port_server.parse_search_payload(body, device="cpu")
    assert got.workload == port_workload(ref.workload)
    assert got.request_id == ref.request_id
    assert got.config.spec.name == ref.config.spec.name == "tpu_v5e"
    assert got.config.lr == 1.0 and isinstance(got.config.lr, float)
    assert (got.priority, got.segment_budget, got.device) == (2, 3, "cpu")


@pytest.mark.parametrize("payload", MALFORMED,
                         ids=[str(i) for i in range(len(MALFORMED))])
def test_malformed_payload_messages_match_reference(payload):
    with pytest.raises(ValueError) as ref:
        ref_server.parse_search_payload(payload)
    with pytest.raises(ValueError) as got:
        port_server.parse_search_payload(payload, device="cpu")
    assert str(got.value) == str(ref.value)
    assert type(got.value).__name__ == type(ref.value).__name__


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        port_server.CoSearchServer(ServiceConfig())


# ---------------------------------------------------------------------------
# Live HTTP round trip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    srv = port_server.CoSearchServer(ServiceConfig(bucket_workloads=False),
                                     device="cpu")
    host, port = srv.start()
    yield srv, f"http://{host}:{port}"
    srv.stop()


def _post(base, path, body, raw=None):
    req = urllib.request.Request(
        base + path, data=raw if raw is not None else json.dumps(body)
        .encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_search_matches_direct(server):
    srv, base = server
    code, sub = _post(base, "/v1/search",
                      {"workload": WL_JSON, "config": CFG_JSON})
    assert code == 202 and not sub["deduplicated"]
    rid = sub["request_id"]
    code, again = _post(base, "/v1/search",
                        {"workload": WL_JSON, "config": CFG_JSON})
    assert again == {"request_id": rid, "deduplicated": True}
    assert srv.wait_idle(timeout=300)
    code, out = _get(base, f"/v1/result/{rid}")
    assert code == 200 and out["status"] == "ok" and out["ok"]
    wl = Workload(layers=(Layer.matmul(16, 16, 16, name="a"),), name="t")
    direct = dosa_search(port_workload(wl), SearchConfig(**CFG_JSON),
                         population=2, device="cpu")
    assert out["best_edp"] == direct.best_edp
    assert out["n_evals"] == direct.n_evals
    assert out["history"] == [[e, v] for e, v in direct.history]
    code, evs = _get(base, f"/v1/events/{rid}")
    assert code == 200
    assert [ev["segment"] for ev in evs["events"]] == [1, 2]
    assert evs["events"][-1]["done"]
    code, front = _get(base, "/v1/frontier")
    assert code == 200 and [p[0] for p in front["frontier"]] == [rid]
    code, tr = _get(base, f"/v1/trace/{rid}")
    assert code == 200 and tr["trace"]["name"] == "request"
    # (the duplicate may land before or after the search drains)
    names = [e["name"] for e in tr["trace"]["events"]]
    assert names[0] == "submitted"
    assert {"batch_join", "dedup_hit", "drain"} <= set(names)
    kids = [c["name"] for c in tr["trace"]["children"]]
    assert kids[0] == "queue_wait" and kids.count("segment") == 2


def test_http_rejects_with_the_reference_messages(server):
    _, base = server
    for body in MALFORMED[:-1]:
        code, out = _post(base, "/v1/search", body)
        assert code == 400
        with pytest.raises(ValueError) as ref:
            ref_server.parse_search_payload(body)
        assert out["error"] == {"type": "ValueError",
                                "message": str(ref.value)}
    code, out = _post(base, "/v1/search", None, raw=b"{nope")
    assert code == 400 and out["error"]["type"] == "JSONDecodeError"
    # a feature the port has not taken yet: refused at submission
    code, out = _post(base, "/v1/search", {"workload": WL_JSON,
                                           "config": {"shards": 2}})
    assert code == 400
    assert out["error"]["type"] == "NotImplementedError"
    assert "item 7" in out["error"]["message"]


def test_http_routes_stats_and_metrics(server):
    srv, base = server
    assert _get(base, "/v1/result/nope")[0] == 404
    assert _get(base, "/v1/events/nope")[0] == 404
    assert _get(base, "/v1/trace/nope")[0] == 404
    assert _get(base, "/nope")[0] == 404
    assert _post(base, "/nope", {})[0] == 404
    code, health = _get(base, "/v1/healthz")
    assert code == 200 and health["ok"]
    code, stats = _get(base, "/v1/stats")
    assert code == 200 and "build_seconds_total" in stats["engine_cache"]
    assert {"retries", "quarantined", "dedup_hits"} <= set(stats["faults"])
    with urllib.request.urlopen(base + "/v1/metrics", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    types = dict(line.split()[2:4] for line in text.splitlines()
                 if line.startswith("# TYPE "))
    assert types["serve_requests_submitted_total"] == "counter"
    assert types["serve_request_seconds"] == "histogram"
    assert types["engine_cache_hit_rate"] == "gauge"
    assert types["engine_build_total"] == "counter"
