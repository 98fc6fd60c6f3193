"""The port's RPC data plane (``veles/simd_tpu_torch/serve/rpc.py``)
against the JAX package's.

A frame is a wire contract, so on the CPU (``set_config(device="cpu")``,
``JAX_PLATFORMS=cpu``):

* a port frame and a JAX frame are byte-equal on the same arrays and
  header (requests, responses with ``(out, state)`` pipeline trees,
  error responses), and each package decodes the other's frames;
* ``ERROR_KINDS`` is pinned in both directions: each typed serving
  error encodes to the JAX package's wire dict, and each wire kind
  decodes to the port's type (``scope="cluster"`` to
  ``NoReplicaAvailable``), across packages too;
* every malformation raises ``ValueError``; a truncated or garbage body
  answers a ``bad_request`` frame with HTTP 400, on ``serve_submit``
  and on the live endpoint's ``POST /submit``;
* the client over a live endpoint: answers equal the float64 oracle
  within 2e-5 of max|y|, connections pooled, the child's trace absorbed;
  a refused connection and a garbage reply answer ``closed``; a JAX
  ``RpcClient`` against the port's endpoint, and the port's against
  the JAX endpoint, answer the same request alike.
"""

import dataclasses
import io
import json
import socket
import struct
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from veles.simd_tpu import obs as jobs
from veles.simd_tpu import serve as jserve
from veles.simd_tpu.obs import http as jhttp
from veles.simd_tpu.ops import iir as jiir
from veles.simd_tpu.serve import cluster as jcluster
from veles.simd_tpu.serve import rpc as jrpc
from veles.simd_tpu_torch import obs, serve
from veles.simd_tpu_torch.obs import http as obs_http
from veles.simd_tpu_torch.ops import iir
from veles.simd_tpu_torch.runtime import breaker, faults
from veles.simd_tpu_torch.serve import cluster, rpc
from veles.simd_tpu_torch.utils import config

RNG = np.random.RandomState(11)
SOS = jiir.butterworth(4, 0.25, "lowpass")
IIR_TOL = 2e-5          # of max|y| (tests/test_iir.py)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    for name in (rpc.RPC_CONNS_ENV, rpc.RPC_TIMEOUT_ENV,
                 obs_http.OBS_PORT_ENV, "VELES_SIMD_SERVE_DEADLINE_MS"):
        monkeypatch.delenv(name, raising=False)
    obs.enable(compile_listeners=False)
    obs.reset()
    breaker.reset()
    yield
    obs.disable()
    obs.reset()
    breaker.reset()
    faults.reset_fault_history()
    config.set_config(**dataclasses.asdict(prev))


def _signal(n=512):
    return RNG.randn(n).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / (float(np.max(np.abs(want))) or 1.0))


# ---------------------------------------------------------------------------
# the wire codec: byte-equal frames, decoded across packages
# ---------------------------------------------------------------------------

def _requests():
    x = RNG.randn(300).astype(np.float32)
    return {
        "sosfilt": (("sosfilt", x, {"sos": SOS}),
                    {"tenant": "acme", "deadline_ms": 1234.5,
                     "block": True, "timeout": 2.0}),
        "stft": (("stft", RNG.randn(16384).astype(np.float32),
                  {"frame_length": 512, "hop": 128}), {}),
        "mixed_params": (("lfilter", x, {
            "b": [0.2, 0.3, 0.1], "a": np.array([1.0, -0.4, 0.1]),
            "gain": np.float64(0.5), "taps": np.arange(7, dtype=np.int32),
            "n": np.int64(3), "label": "hp", "flag": True,
            "nothing": None,
            "nested": {"win": np.hanning(16).astype(np.float32)},
            "__reserved": (1, 2.0, "three")}), {}),
        "pipeline_state": (("pipeline:mstft", x, {"state": (
            {"carry": RNG.randn(2046).astype(np.float32)},
            (np.zeros(384, np.float32), None))}),
            {"deadline_ms": 60000.0}),
    }


def _responses():
    out = RNG.randn(8, 129).astype(np.complex64)
    state = ({("carry", 0): _signal(8)}, (np.int64(3), None))
    return {
        "ok_array": {"status": "ok", "value": _signal(64),
                     "wait_s": 0.0125, "replica": "r1",
                     "events": [{"event": "admitted", "t_s": 0.0}]},
        "pipeline_tree": {"status": "ok", "value": (out, state),
                          "wait_s": 0.5, "replica": "r2"},
        "shed": {"status": "shed", "replica": "r0",
                 "error": {"kind": "overloaded", "message": "full",
                           "tenant": "bob", "scope": "tenant"}},
        "no_value": {"status": "closed",
                     "error": {"kind": "closed", "message": "gone"}},
    }


@pytest.mark.parametrize("case", sorted(_requests()))
def test_request_frames_are_byte_equal(case):
    args, kw = _requests()[case]
    mine = rpc.pack_request(*args, **kw)
    theirs = jrpc.pack_request(*args, **kw)
    assert mine == theirs
    assert mine.startswith(jrpc.MAGIC)


@pytest.mark.parametrize("case", sorted(_responses()))
def test_response_frames_are_byte_equal(case):
    kw = _responses()[case]
    assert rpc.pack_response(**kw) == jrpc.pack_response(**kw)


def _same_tree(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)
    elif isinstance(a, dict):
        assert sorted(map(repr, a)) == sorted(map(repr, b))
        for k in a:
            _same_tree(a[k], b[k])
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("case", sorted(_requests()))
def test_each_package_decodes_the_others_requests(case):
    args, kw = _requests()[case]
    for pack, unpack in ((rpc.pack_request, jrpc.unpack_request),
                         (jrpc.pack_request, rpc.unpack_request)):
        req = unpack(pack(*args, **kw))
        assert req["op"] == args[0]
        _same_tree(req["x"], np.asarray(args[1]))
        assert req["tenant"] == kw.get("tenant", "default")
        assert req["deadline_ms"] == kw.get("deadline_ms")
        assert req["block"] is kw.get("block", False)
        mine = rpc.unpack_request(rpc.pack_request(*args, **kw))
        _same_tree(req["params"], mine["params"])


@pytest.mark.parametrize("case", sorted(_responses()))
def test_each_package_decodes_the_others_responses(case):
    kw = _responses()[case]
    a = jrpc.unpack_response(rpc.pack_response(**kw))
    b = rpc.unpack_response(jrpc.pack_response(**kw))
    for resp in (a, b):
        assert resp["status"] == kw["status"]
        assert resp["error"] == kw.get("error")
        assert resp["replica"] == kw.get("replica")
        assert resp["events"] == kw.get("events", [])
    _same_tree(a["value"], b["value"])


def test_wire_constants_are_the_jax_ones():
    for name in ("MAGIC", "WIRE_SCHEMA", "CONTENT_TYPE", "ERROR_KINDS",
                 "RPC_CONNS_ENV", "RPC_TIMEOUT_ENV", "DEFAULT_RPC_CONNS",
                 "DEFAULT_RPC_TIMEOUT_MS"):
        assert getattr(rpc, name) == getattr(jrpc, name), name


@pytest.mark.parametrize("raw", ["", "x", "0", "-2", "3", "64"])
def test_env_knobs_parse_as_the_jax_ones(monkeypatch, raw):
    monkeypatch.setenv(rpc.RPC_CONNS_ENV, raw)
    monkeypatch.setenv(rpc.RPC_TIMEOUT_ENV, raw)
    assert rpc.env_conns() == jrpc.env_conns()
    assert rpc.env_timeout_s() == jrpc.env_timeout_s()


def _malformed():
    good = rpc.pack_request("sosfilt", _signal(16), {"sos": SOS})
    bad_json = rpc.MAGIC + struct.pack(">I", 4) + b"!!!!"
    hdr = json.dumps({"schema": "veles-simd-rpc-v0",
                      "blobs": []}).encode()
    drift = rpc.MAGIC + struct.pack(">I", len(hdr)) + hdr
    hdr = json.dumps({"schema": rpc.WIRE_SCHEMA, "blobs": [4]}).encode()
    rot = rpc.MAGIC + struct.pack(">I", len(hdr)) + hdr + b"rot!"
    buf = io.BytesIO()
    np.save(buf, np.array([{"a": 1}], dtype=object), allow_pickle=True)
    hdr = json.dumps({"schema": rpc.WIRE_SCHEMA,
                      "blobs": [len(buf.getvalue())]}).encode()
    pickled = rpc.MAGIC + struct.pack(">I", len(hdr)) + hdr \
        + buf.getvalue()
    return {"empty": b"", "short": b"VS",
            "wrong_magic": b"NOTRPC" + good[6:],
            "truncated_header": good[:12], "truncated_blobs": good[:-10],
            "trailing": good + b"xx", "bad_json": bad_json,
            "schema_drift": drift, "blob_rot": rot, "pickle": pickled}


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformations_raise_valueerror_in_both(case):
    data = _malformed()[case]
    for mod in (rpc, jrpc):
        with pytest.raises(ValueError):
            mod.unpack_frame(data)


def test_unsupported_value_raises_valueerror():
    with pytest.raises(ValueError, match="cannot encode"):
        rpc.pack_request("sosfilt", _signal(), {"fn": object()})


# ---------------------------------------------------------------------------
# ERROR_KINDS, pinned both directions
# ---------------------------------------------------------------------------

def _errors(mod_serve, mod_cluster):
    return [
        mod_serve.Overloaded("full", tenant="bob", scope="tenant"),
        mod_cluster.NoReplicaAvailable("none", tenant="carol"),
        mod_serve.DeadlineExceeded("late"),
        mod_serve.ServerClosed("gone"),
        ValueError("bad op"),
        RuntimeError("boom"),
        KeyError("odd"),
    ]


def test_error_kinds_encode_as_the_jax_package():
    mine = [rpc.encode_error(e) for e in _errors(serve, cluster)]
    theirs = [jrpc.encode_error(e) for e in _errors(jserve, jcluster)]
    assert mine == theirs
    assert [m["kind"] for m in mine] == [
        "overloaded", "overloaded", "deadline", "closed", "bad_request",
        "error", "error"]
    assert set(m["kind"] for m in mine) == set(rpc.ERROR_KINDS)


def test_error_kinds_decode_to_the_port_types():
    want = {"overloaded": serve.Overloaded,
            "deadline": serve.DeadlineExceeded,
            "closed": serve.ServerClosed,
            "bad_request": ValueError, "error": RuntimeError}
    assert set(want) == set(rpc.ERROR_KINDS)
    for kind, typ in want.items():
        got = rpc.decode_error({"kind": kind, "message": "m",
                                "tenant": "t", "scope": "tenant"})
        assert type(got) is typ, kind
    # cluster scope round-trips as its own type; across packages too
    for info in (rpc.encode_error(cluster.NoReplicaAvailable(
            "none", tenant="carol")), jrpc.encode_error(
            jcluster.NoReplicaAvailable("none", tenant="carol"))):
        got = rpc.decode_error(info)
        assert isinstance(got, cluster.NoReplicaAvailable)
        assert got.tenant == "carol" and got.scope == "cluster"
    for info in ({"kind": "martian"}, "garbage", None):
        assert type(rpc.decode_error(info)) is RuntimeError
        assert type(jrpc.decode_error(info)) is RuntimeError


# ---------------------------------------------------------------------------
# the server side: serve_submit and the endpoint's POST /submit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["truncated_blobs", "short", "bad_json"])
def test_truncated_body_answers_bad_request(case):
    data = _malformed()[case]
    with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                      name="rb") as srv:
        code, body = rpc.serve_submit(srv, data)
    resp = rpc.unpack_response(body)
    assert code == 400 and resp["status"] == "error"
    assert resp["error"]["kind"] == "bad_request"
    assert resp["replica"] == "rb"
    assert isinstance(rpc.decode_error(resp["error"]), ValueError)


def test_endpoint_answers_a_truncated_body_bad_request():
    good = rpc.pack_request("sosfilt", _signal(64), {"sos": SOS})
    with serve.Server(max_batch=2, max_wait_ms=1.0, workers=1,
                      obs_port=0) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.obs_port}/submit", data=good[:-20],
            headers={"Content-Type": rpc.CONTENT_TYPE})
        try:
            urllib.request.urlopen(req, timeout=10.0)
            code, body = 200, b""
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read()
        # the endpoint keeps serving afterwards
        ok = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.obs_port}/healthz", timeout=10.0)
    assert code == 400 and ok.status == 200
    assert rpc.unpack_response(body)["error"]["kind"] == "bad_request"


def test_serve_submit_answers_ok_unknown_op_and_closed():
    x = _signal(400)
    with serve.Server(max_batch=4, max_wait_ms=1.0, workers=1) as srv:
        code, body = rpc.serve_submit(srv, rpc.pack_request(
            "sosfilt", x, {"sos": SOS}, deadline_ms=60000.0))
        resp = rpc.unpack_response(body)
        code2, body2 = rpc.serve_submit(srv, rpc.pack_request(
            "nope", x, {}))
    assert code == 200 and resp["status"] == "ok"
    assert _rel(resp["value"], iir.sosfilt_na(SOS, x)) <= IIR_TOL
    assert any(e.get("event") == "dispatched" for e in resp["events"])
    resp2 = rpc.unpack_response(body2)
    assert code2 == 200 and resp2["error"]["kind"] == "bad_request"
    code3, body3 = rpc.serve_submit(srv, rpc.pack_request(
        "sosfilt", x, {"sos": SOS}))
    assert code3 == 200
    assert rpc.unpack_response(body3)["status"] == "closed"


# ---------------------------------------------------------------------------
# the client over live endpoints
# ---------------------------------------------------------------------------

def test_client_roundtrip_matches_oracle_and_pools_connections():
    with serve.Server(max_batch=8, max_wait_ms=2.0, workers=1,
                      obs_port=0, name="rw") as srv:
        client = rpc.RpcClient("127.0.0.1", srv.obs_port, replica="rw",
                               conns=2)
        try:
            xs = [_signal(int(n)) for n in (256, 300, 512, 777) * 2]
            tickets = [client.submit(op="sosfilt", x=x,
                                     params={"sos": SOS},
                                     deadline_ms=60000.0) for x in xs]
            for x, t in zip(xs, tickets):
                assert _rel(t.result(timeout=60.0),
                            iir.sosfilt_na(SOS, x)) <= IIR_TOL
                assert t.status == "ok" and t.remote == "rw"
                names = [e.get("event") for e in t.trace.events()]
                assert "rpc_submit" in names and "rpc_sent" in names
                assert any(e.get("event") == "dispatched"
                           and e.get("replica") == "rw"
                           for e in t.trace.events())
            stats = client.stats()
        finally:
            client.close()
    assert stats["sends"] == 8 and stats["in_flight"] == 0
    assert stats["reused"] >= 6 and stats["transport_errors"] == 0


def test_refused_connection_answers_closed():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    client = rpc.RpcClient("127.0.0.1", dead, replica="rdead", conns=1,
                           timeout_s=5.0)
    try:
        t = client.submit(op="sosfilt", x=_signal(), params={"sos": SOS})
        with pytest.raises(serve.ServerClosed):
            t.result(timeout=30.0)
        assert t.status == "closed"
        assert client.stats()["transport_errors"] >= 1
        client.close()
        with pytest.raises(serve.ServerClosed):
            client.submit(op="sosfilt", x=_signal(), params={"sos": SOS})
    finally:
        client.close()


def test_garbage_reply_answers_closed():
    class Garbage(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = b"these are not the frames"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), Garbage)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = rpc.RpcClient("127.0.0.1", httpd.server_port,
                           replica="rgarb", conns=1)
    try:
        t = client.submit(op="sosfilt", x=_signal(), params={"sos": SOS})
        with pytest.raises(serve.ServerClosed):
            t.result(timeout=30.0)
        assert client.stats()["bad_replies"] >= 1
    finally:
        client.close()
        httpd.shutdown()
        httpd.server_close()


def test_malformed_request_raises_before_any_bytes():
    client = rpc.RpcClient("127.0.0.1", 9, replica="rx", conns=1)
    try:
        with pytest.raises(ValueError):
            client.submit(op="nope", x=_signal(), params={})
        assert client.stats()["submitted"] == 0
    finally:
        client.close()


def test_clients_and_endpoints_interoperate_across_packages():
    # the JAX client against the port's endpoint, and the port's
    # client against the JAX endpoint: the same request, alike answers
    x = _signal(640)
    want = iir.sosfilt_na(SOS, x)
    with serve.Server(max_batch=4, max_wait_ms=1.0, workers=1,
                      obs_port=0, name="port") as srv:
        jclient = jrpc.RpcClient("127.0.0.1", srv.obs_port,
                                 replica="port", conns=1)
        try:
            t = jclient.submit(op="sosfilt", x=x, params={"sos": SOS},
                               deadline_ms=60000.0)
            from_port = t.result(timeout=60.0)
        finally:
            jclient.close()
    jobs.enable(compile_listeners=False)
    try:
        with jserve.Server(max_batch=4, max_wait_ms=1.0, workers=1,
                           name="jax") as jsrv:
            ep = jhttp.start(0, submit=lambda body: jrpc.serve_submit(
                jsrv, body))
            client = rpc.RpcClient("127.0.0.1", ep.port, replica="jax",
                                   conns=1)
            try:
                t2 = client.submit(op="sosfilt", x=x,
                                   params={"sos": SOS},
                                   deadline_ms=60000.0)
                from_jax = t2.result(timeout=60.0)
            finally:
                client.close()
                ep.stop()
    finally:
        jobs.disable()
        jobs.reset()
    assert t.status == t2.status == "ok"
    assert _rel(from_port, want) <= IIR_TOL
    assert _rel(from_jax, want) <= IIR_TOL
    assert _rel(from_port, from_jax) <= IIR_TOL
