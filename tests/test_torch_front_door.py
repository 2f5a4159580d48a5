"""The front door and its client (``thrill_tpu_torch/service/
front_door.py``, ``client.py``) against the reference package's on the
CPU, over real loopback sockets.

* The port's client against the port's front door: blob and items
  pipelines round-trip (items consumable while the job still runs), a
  job's tensors leave as numpy arrays, the typed rejects
  (``unknown_pipeline``, ``rate_limited`` with its retry and
  ``draining``), HMAC on and off (a wrong secret raises ``AuthError``),
  the version negotiation, and the resize fence's verdict gate.
* Across packages, the port's client against the reference's front door
  and the reference's client against the port's: the same welcome
  (negotiated version and range), typed rejects with their kind and
  hint, and streamed results, with HMAC on and off.
* Deadlines, a slow client and a stream fault are driven through the
  fault sites and deadlines that are already past, never by sleeps:
  ``service.front_door.stream`` (the job's connection survives, checked
  while it is still open), ``service.front_door.slow_client``,
  ``service.front_door.accept`` (the client redials),
  ``net.tcp.client_disconnect``, a ``deadline_s`` that expired before
  the job started, a slow-loris frame torn mid-read.
* ``drain`` finishes the accepted job, rejects a new one with
  ``draining`` and says bye; ``close`` is idempotent and detaches.

Tolerance: exact.
"""

import socket
import threading
import time

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
from thrill_tpu.service import client as jclient
from thrill_tpu.service import front_door as jfd

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.net import wire
from thrill_tpu_torch.net.tcp import TcpConnection, _exchange_auth_flag
from thrill_tpu_torch.service import client as tclient
from thrill_tpu_torch.service import front_door as tfd

_SERVE_ENV = ("THRILL_TPU_SERVE_PORT", "THRILL_TPU_SERVE_RATE",
              "THRILL_TPU_SERVE_QUEUE", "THRILL_TPU_SERVE_TENANT_QUEUE",
              "THRILL_TPU_SERVE_READ_TIMEOUT_S",
              "THRILL_TPU_SERVE_WRITE_TIMEOUT_S",
              "THRILL_TPU_SERVE_DRAIN_TIMEOUT_S",
              "THRILL_TPU_SERVE_CHUNK", "THRILL_TPU_SERVE_EGRESS_BYTES",
              "THRILL_TPU_SECRET", "THRILL_TPU_AUTOSCALE_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in _SERVE_ENV + (faults.ENV_VAR,):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _ctx(side, W=2):
    if side == "j":
        return JContext(JMeshExec(num_workers=W))
    return tt.Context(num_workers=W, device="cpu")


@pytest.fixture
def ctx():
    c = _ctx("t")
    yield c
    c.close()


# module-level pipelines: stable identities share the exchange sites' caches
def _echo(ctx2, args):
    return args


def _mesh_sum(ctx2, args):
    return int(ctx2.Distribute(
        np.arange(int(args["n"]), dtype=np.int64)).Sum())


def _sorted_rows(ctx2, args):
    """A Sort's rows: device arrays on the port (numpy on the wire)."""
    rng = np.random.default_rng(int(args["seed"]))
    out = ctx2.Distribute(rng.integers(0, 1 << 40, int(args["n"]))).Sort()
    if type(ctx2).__module__.startswith("thrill_tpu_torch"):
        return out.AllGatherArrays()
    return np.asarray(out.AllGather())


def _gen(ctx2, args):
    for i in range(int(args["k"])):
        yield i * i


_GATES = {}


def _gated_gen(ctx2, args):
    """Yields one item, then waits for the test's gate, then the rest."""
    yield 0
    assert _GATES[args["gate"]].wait(60)
    for i in range(1, int(args["k"])):
        yield i


def _hold(ctx2, args):
    _GATES[args["started"]].set()
    assert _GATES[args["gate"]].wait(60)
    return args["value"]


def _front(mod, ctx):
    fd = mod.FrontDoor(ctx, port=0)
    for name, fn in (("echo", _echo), ("mesh_sum", _mesh_sum),
                     ("sorted", _sorted_rows), ("gen", _gen),
                     ("gated_gen", _gated_gen), ("hold", _hold)):
        fd.register(name, fn)
    return fd


def _wait(pred, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _gate(name):
    _GATES[name] = threading.Event()
    return _GATES[name]


def _raw_hello(fd, proto, tenant="raw"):
    sock = socket.create_connection(("127.0.0.1", fd.port), timeout=10)
    conn = TcpConnection(sock)
    _exchange_auth_flag(conn, False)
    conn.send(("hello", {"tenant": tenant, "proto": proto}))
    return conn, conn.recv_deadline(10.0)


# -- the port's client against the port's front door ------------------------

def test_blob_and_items_round_trip_mixed_tenants(ctx):
    fd = _front(tfd, ctx)
    with tclient.FrontDoorClient("127.0.0.1", fd.port, tenant="alice") as a, \
            tclient.FrontDoorClient("127.0.0.1", fd.port, tenant="bob") as b:
        j1 = a.submit("mesh_sum", {"n": 64})
        j2 = b.submit("gen", {"k": 5})
        j3 = a.submit("echo", {"x": [1, 2, 3], "s": "hi"})
        j4 = b.submit("sorted", {"seed": 4, "n": 500})
        assert j1.result(120) == int(np.arange(64).sum())
        assert list(j2.chunks(timeout=60)) == [0, 1, 4, 9, 16]
        assert j2.mode == "items"
        assert j3.result(60) == {"x": [1, 2, 3], "s": "hi"}
        rows = j4.result(60)
        want = np.sort(np.random.default_rng(4).integers(0, 1 << 40, 500))
        assert isinstance(rows, np.ndarray) and np.array_equal(rows, want)
    assert fd.jobs_submitted == 4 and fd.jobs_rejected == 0
    assert fd.chunks_sent >= 8
    assert ctx.overall_stats()["fd_jobs_submitted"] == 4
    fd.close()


def test_items_stream_consumable_mid_job(ctx):
    fd = _front(tfd, ctx)
    gate = _gate("mid")
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        job = c.submit("gated_gen", {"k": 6, "gate": "mid"})
        it = job.chunks(timeout=30)
        assert next(it) == 0               # the job still runs
        with job._cv:
            assert not job._done
        gate.set()
        assert list(it) == [1, 2, 3, 4, 5]
    fd.close()


def test_authenticated_handshake_and_wrong_secret(ctx, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_SECRET", "s3cr3t")
    fd = _front(tfd, ctx)
    assert fd.secret is not None
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        assert c.conn.authenticated
        assert c.submit("echo", 7).result(30) == 7
    with pytest.raises(wire.AuthError):
        tclient.FrontDoorClient("127.0.0.1", fd.port, secret=b"wrong")
    fd.close()


def test_unknown_pipeline_is_typed_reject(ctx):
    fd = _front(tfd, ctx)
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        with pytest.raises(tclient.Rejected) as ei:
            c.submit("no_such_pipeline", None).result(30)
        assert ei.value.kind == "unknown_pipeline"
    assert fd.jobs_rejected == 1
    fd.close()


def test_rate_limit_reject_then_retry_after_success(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_SERVE_RATE", "alice=4:1")
    ctx = _ctx("t")
    fd = _front(tfd, ctx)
    try:
        with tclient.FrontDoorClient("127.0.0.1", fd.port,
                                     tenant="alice") as c:
            assert c.submit("echo", 1).result(60) == 1
            with pytest.raises(tclient.Rejected) as ei:
                c.submit("echo", 2).result(30)
            assert ei.value.kind == "rate_limited"
            assert ei.value.retry_after_s > 0
            job = c.submit_retry("echo", 3, attempts=8, seed=7)
            assert job.result(60) == 3
        assert ctx.overall_stats()["jobs_rate_limited"] >= 1
    finally:
        fd.close()
        ctx.close()


def test_version_negotiation(ctx, monkeypatch):
    fd = _front(tfd, ctx)
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        assert c.proto == tfd.PROTO_MAX == 2
        assert c.server_range == (tfd.PROTO_MIN, tfd.PROTO_MAX)
        job = c.submit("echo", {"x": 1})
        assert job.result(60) == {"x": 1}
        assert job.generation == ctx.generation
    conn, frame = _raw_hello(fd, proto=1)
    assert frame[0] == "welcome"
    assert frame[1] == {"proto": 1, "range": [1, 2]}
    conn.send(("submit", {"id": 1, "pipeline": "echo", "args": 7}))
    accept = conn.recv_deadline(30.0)
    assert accept[:2] == ("accept", 1) and "gen" not in accept[2]
    conn.send(("bye",))
    conn.close()
    for offer in ([3, 5], "banana"):
        conn, frame = _raw_hello(fd, proto=offer)
        assert frame[0] == "reject" and frame[2] == "version_mismatch"
        assert "[1,2]" in frame[4]
        assert conn.recv_deadline(10.0)[0] == "bye"
        conn.close()
    monkeypatch.setattr(tclient, "PROTO_MIN", tfd.PROTO_MAX + 1)
    monkeypatch.setattr(tclient, "PROTO_MAX", tfd.PROTO_MAX + 2)
    with pytest.raises(tclient.VersionMismatch):
        tclient.FrontDoorClient("127.0.0.1", fd.port)
    monkeypatch.undo()
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        assert c.submit("echo", "ok").result(60) == "ok"
    fd.close()


def test_resize_fence_holds_verdict_until_post_resize_generation(ctx):
    fd = _front(tfd, ctx)
    gen_before = ctx.generation
    started, release = threading.Event(), threading.Event()

    def hold(c2):
        started.set()
        release.wait(30)

    try:
        ctx.submit(hold, name="hold")
        assert started.wait(30)
        resized = threading.Event()
        t = threading.Thread(target=lambda: (ctx.resize(1), resized.set()),
                             daemon=True)
        t.start()
        _wait(lambda: fd._fencing, what="the fence's gate")
        with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
            job = c.submit("echo", {"ok": True})
            with pytest.raises(TimeoutError):
                job.wait_accepted(0.5)
            release.set()
            assert resized.wait(60)
            job.wait_accepted(60)
            assert ctx.num_workers == 1
            assert job.generation == ctx.generation > gen_before
            assert job.result(60) == {"ok": True}
    finally:
        release.set()
        fd.close()


# -- across packages ----------------------------------------------------------

def _handshake_and_jobs(client_mod, fd_mod, server_ctx, secret):
    fd = _front(fd_mod, server_ctx)
    out = {}
    try:
        kw = {"secret": secret} if secret else {}
        with client_mod.FrontDoorClient("127.0.0.1", fd.port,
                                        tenant="x", **kw) as c:
            out["proto"] = (c.proto, tuple(c.server_range),
                            c.conn.authenticated)
            out["sum"] = c.submit("mesh_sum", {"n": 100}).result(120)
            out["echo"] = c.submit("echo", {"a": [1, 2], "b": "z"}).result(60)
            job = c.submit("gen", {"k": 4})
            out["items"] = list(job.chunks(timeout=60))
            out["mode"] = job.mode
            try:
                c.submit("nope", 1).result(30)
            except client_mod.Rejected as e:
                out["reject"] = (e.kind, e.retry_after_s,
                                 str(e).split(": ", 1)[0])
            out["gen"] = job.generation is not None
        conn, frame = _raw_hello(fd, proto=[1, 9]) if not secret else (
            None, None)
        if conn is not None:
            out["welcome"] = frame
            conn.close()
        out["stats"] = fd.stats()["fd_jobs_rejected"]
    finally:
        fd.close()
    return out


@pytest.mark.parametrize("secret", [None, b"cross-secret"])
def test_clients_and_front_doors_across_packages(secret, monkeypatch):
    if secret:
        monkeypatch.setenv("THRILL_TPU_SECRET", secret.decode())
    runs = {}
    for server in ("j", "t"):
        ctx = _ctx(server)
        try:
            fd_mod = jfd if server == "j" else tfd
            for client in ("j", "t"):
                mod = jclient if client == "j" else tclient
                runs[(client, server)] = _handshake_and_jobs(
                    mod, fd_mod, ctx, secret)
        finally:
            ctx.close()
    want = runs[("j", "j")]
    assert want["reject"][0] == "unknown_pipeline"
    assert want["proto"] == (2, (1, 2), bool(secret))
    for key, got in runs.items():
        assert got == want, key
    assert (tfd.PROTO_MIN, tfd.PROTO_MAX, tfd.PROTO_VERSION) == \
        (jfd.PROTO_MIN, jfd.PROTO_MAX, jfd.PROTO_VERSION)


def test_typed_shed_rejects_across_packages(monkeypatch):
    """The reference's client reading the port's typed rejects, and the
    other way round: the same kind, hint and text."""
    monkeypatch.setenv("THRILL_TPU_SERVE_RATE", "default=0.5:1")
    seen = {}
    for server in ("j", "t"):
        ctx = _ctx(server, 1)
        fd = _front(jfd if server == "j" else tfd, ctx)
        try:
            for client in ("j", "t"):
                mod = jclient if client == "j" else tclient
                with mod.FrontDoorClient("127.0.0.1", fd.port,
                                         tenant=f"r{client}") as c:
                    first = c.submit("echo", 1).result(60)
                    try:
                        c.submit("echo", 2).result(30)
                        second = None
                    except mod.Rejected as e:
                        second = (e.kind, e.retry_after_s > 0,
                                  str(e).split("s): ", 1)[1].split(
                                      "retry after")[0].replace(
                                          f"r{client}", "T"))
                    seen[(client, server)] = (first, second)
        finally:
            fd.close()
            ctx.close()
    assert len(set(seen.values())) == 1, seen
    assert seen[("t", "t")][1][:2] == ("rate_limited", True)


def test_streamed_sort_result_across_packages():
    """A device result streamed in small chunks: the reference's client
    reassembles the port's stream, and the port's client the
    reference's, to the same array."""
    want = np.sort(np.random.default_rng(9).integers(0, 1 << 40, 3000))
    import os
    os.environ["THRILL_TPU_SERVE_CHUNK"] = "4096"
    try:
        for server in ("j", "t"):
            ctx = _ctx(server)
            fd = _front(jfd if server == "j" else tfd, ctx)
            try:
                assert fd.chunk_bytes == 4096
                for mod in (jclient, tclient):
                    with mod.FrontDoorClient("127.0.0.1", fd.port) as c:
                        job = c.submit("sorted", {"seed": 9, "n": 3000})
                        got = job.result(120)
                        assert np.array_equal(np.asarray(got), want)
                assert fd.chunks_sent >= 4       # several chunks a job
            finally:
                fd.close()
                ctx.close()
    finally:
        del os.environ["THRILL_TPU_SERVE_CHUNK"]


# -- fault sites, deadlines and misbehaving clients ---------------------------

def test_stream_fault_typed_error_conn_survives(ctx):
    fd = _front(tfd, ctx)
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        with faults.inject("service.front_door.stream", n=1):
            with pytest.raises(tclient.RemoteJobError) as ei:
                c.submit("gen", {"k": 3}).result(60)
            assert ei.value.kind == "stream"
        assert c.submit("echo", "after").result(60) == "after"
        # read while the connection is open: the client's own bye at the
        # block's end is a close, not the stream fault's doing
        assert fd.conns_dropped == 0 and fd.stats()["fd_conns_accepted"] == 1
    fd.close()


def test_injected_slow_client_site_drops(ctx):
    fd = _front(tfd, ctx)
    with faults.inject("service.front_door.slow_client", n=1):
        sock = socket.create_connection(("127.0.0.1", fd.port), timeout=10)
        conn = TcpConnection(sock)
        _exchange_auth_flag(conn, False)
        conn.send(("hello", {"tenant": "slow", "proto": [1, 2]}))
        # the writer's first frame (the welcome) fires the site
        _wait(lambda: fd.slow_clients >= 1, what="slow-client fire")
        _wait(lambda: fd.conns_dropped >= 1, what="slow-client drop")
        conn.close()
    with tclient.FrontDoorClient("127.0.0.1", fd.port, tenant="bob") as b:
        assert b.submit("echo", "ok").result(60) == "ok"
    fd.close()


def test_accept_fault_redialed_by_client(ctx):
    fd = _front(tfd, ctx)
    with faults.inject("service.front_door.accept", n=1):
        with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
            assert c.submit("echo", 5).result(60) == 5
    assert faults.REGISTRY.injected >= 1
    fd.close()


def test_injected_client_disconnect_drops_conn(ctx):
    fd = _front(tfd, ctx)
    with faults.inject("net.tcp.client_disconnect", n=1):
        c = tclient.FrontDoorClient("127.0.0.1", fd.port)
        _wait(lambda: fd.conns_dropped >= 1, what="injected disconnect")
        c.close()
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c2:
        assert c2.submit("echo", 1).result(60) == 1
    fd.close()


def test_deadline_expired_is_typed_error(ctx):
    fd = _front(tfd, ctx)
    started, gate = _gate("dl-started"), _gate("dl-gate")
    with tclient.FrontDoorClient("127.0.0.1", fd.port) as c:
        first = c.submit("hold", {"started": "dl-started",
                                  "gate": "dl-gate", "value": 4})
        assert started.wait(60)
        # a deadline already past when the dispatcher reaches the job
        doomed = c.submit("echo", 1, deadline_s=1e-9)
        doomed.wait_accepted(60)
        gate.set()
        with pytest.raises(tclient.RemoteJobError) as ei:
            doomed.result(60)
        assert ei.value.kind == "deadline"
        assert first.result(60) == 4
    assert fd.deadline_expired == 1
    fd.close()


def test_slow_loris_read_deadline_drops(ctx):
    fd = _front(tfd, ctx)
    sock = socket.create_connection(("127.0.0.1", fd.port), timeout=10)
    conn = TcpConnection(sock)
    _exchange_auth_flag(conn, False)
    conn.send(("hello", {"tenant": "loris", "proto": 1}))
    assert conn.recv_deadline(10.0)[0] == "welcome"
    conn.sock.sendall(b"\x20\x00")    # 2 of a header's bytes, then stall
    _wait(lambda: fd.slow_clients >= 1, what="slow-loris detection")
    _wait(lambda: fd.conns_dropped >= 1, what="slow-loris drop")
    conn.close()
    fd.close()


def test_client_vanish_mid_stream_other_tenant_unaffected(ctx):
    fd = _front(tfd, ctx)
    gate = _gate("vanish")
    a = tclient.FrontDoorClient("127.0.0.1", fd.port, tenant="alice")
    job = a.submit("gated_gen", {"k": 12, "gate": "vanish"})
    assert next(job.chunks(timeout=30)) == 0
    a.conn.sock.close()                # gone without a bye
    gate.set()
    with tclient.FrontDoorClient("127.0.0.1", fd.port, tenant="bob") as b:
        assert b.submit("echo", "ok").result(60) == "ok"
    _wait(lambda: fd.conns_dropped >= 1, what="vanished conn dropped")
    with tclient.FrontDoorClient("127.0.0.1", fd.port, tenant="carol") as c:
        assert c.submit("echo", 1).result(60) == 1
    fd.close()


# -- drain and close -----------------------------------------------------------

def test_graceful_drain_completes_inflight_rejects_new(ctx):
    fd = _front(tfd, ctx)
    started, gate = _gate("dr-started"), _gate("dr-gate")
    c = tclient.FrontDoorClient("127.0.0.1", fd.port)
    inflight = c.submit("hold", {"started": "dr-started", "gate": "dr-gate",
                                 "value": 0.4})
    inflight.wait_accepted(30)
    assert started.wait(30)
    got = {}
    t = threading.Thread(target=lambda: got.update(clean=fd.drain(60)))
    t.start()
    _wait(lambda: fd._draining, what="drain start")
    with pytest.raises(tclient.Rejected) as ei:
        c.submit("echo", 1).result(30)
    assert ei.value.kind == "draining" and ei.value.retry_after_s > 0
    gate.set()
    assert inflight.result(60) == 0.4
    t.join(60)
    assert got["clean"] is True and fd.drained.is_set()
    c.close()
    fd.close()
    fd.close()                          # idempotent
    assert ctx.front_door is None


def test_sigterm_triggers_drain_and_close_detaches(ctx):
    import os
    import signal
    fd = _front(tfd, ctx)
    assert ctx.front_door is fd
    prev = signal.getsignal(signal.SIGTERM)
    try:
        fd.install_sigterm()
        os.kill(os.getpid(), signal.SIGTERM)
        assert fd.drained.wait(20)
    finally:
        signal.signal(signal.SIGTERM, prev)
    fd.close()
    assert ctx.front_door is None


def test_maybe_start_from_the_environment(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("THRILL_TPU_SERVE_PORT", str(port))
    ctx = _ctx("t")
    try:
        assert ctx.front_door is not None and ctx.front_door.port == port
        ctx.front_door.register("echo", _echo)
        with tclient.FrontDoorClient("127.0.0.1", port) as c:
            assert c.submit("echo", "env").result(60) == "env"
    finally:
        ctx.close()
    assert ctx.front_door is None
    monkeypatch.setenv("THRILL_TPU_SERVE_PORT", "nope")
    ctx = _ctx("t")
    try:
        assert ctx.front_door is None
    finally:
        ctx.close()
