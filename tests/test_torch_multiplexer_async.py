"""The host plane's background sender and arrival-order delivery
(``thrill_tpu_torch/data/multiplexer.py`` ``_exchange_frames_async``,
``THRILL_TPU_HOST_MIX``) across two real processes, against the serial
plane, and the frames against the reference package's.

Two processes (``tt.RunDistributed``, 2 workers each, the authenticated
TCP group for the host plane) run the three host sites that declare
``rank_order=False`` (ReducePair, GroupByKey, InnerJoin) and a host
Sort, which keeps rank order, three ways: the serial sender
(``THRILL_TPU_ASYNC_SEND=0``), the background sender, and the
background sender with ``THRILL_TPU_HOST_MIX=1``. This file is also the
child. In one process, two mock ranks exchange the same items through
the port's multiplexer and the reference's, and the frames each sends
are equal, and byte-equal through both packages' wire codecs.

Tolerance: exact. The background sender's results equal the serial
plane's item for item, in order, with the same frame bytes; under
``THRILL_TPU_HOST_MIX=1`` the three declared sites equal it as
multisets (their order may follow arrival) and the Sort in order. Each
exchange of the background sender shows its ``async_send`` spans. The
children run under a load-scaled deadline with one retry.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TEXT = "\n".join(f"line {i} word{i % 7} again word{i % 3} w{i % 29}"
                  for i in range(301)) + "\n"
MODES = (("serial", {"THRILL_TPU_ASYNC_SEND": "0"}), ("async", {}),
         ("mix", {"THRILL_TPU_HOST_MIX": "1"}))


class _Env:
    def __init__(self, kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *a):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_job(text_path):
    def job(ctx):
        from thrill_tpu_torch.api.dia import InnerJoin
        mex = ctx.mesh_exec
        out = {}
        for mode, env in MODES:
            with _Env(env):
                b0 = getattr(mex, "stats_bytes_wire_host", 0)
                n0 = sum(1 for r in ctx.tracer.ring or ()
                         if r.get("name") == "async_send")
                words = ctx.ReadLines(text_path).FlatMap(
                    lambda line: line.split()).Keep(3)
                reduced = words.Map(lambda w: (w, 1)).ReducePair(
                    lambda a, b: a + b).AllGather()
                grouped = words.Map(lambda w: (len(w), w)).GroupByKey(
                    lambda t: t[0],
                    lambda k, it: (k, sorted(t[1] for t in it))).AllGather()
                left = words.Map(lambda w: (w, 1))
                right = ctx.Distribute([(f"word{i}", i) for i in range(5)],
                                       storage="host")
                joined = InnerJoin(left, right, lambda t: t[0],
                                   lambda t: t[0],
                                   lambda a, b: (a[0], b[1])).AllGather()
                ordered = words.Sort(compare_fn=lambda a, b: a < b) \
                    .AllGather()
                out[mode] = {
                    "reduce": [list(x) for x in reduced],
                    "group": [[k, v] for k, v in grouped],
                    "join": [list(x) for x in joined],
                    "sort": ordered,
                    "bytes": getattr(mex, "stats_bytes_wire_host", 0) - b0,
                    "async_spans": sum(
                        1 for r in ctx.tracer.ring or ()
                        if r.get("name") == "async_send") - n0}
        return out
    return job


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _launch(nproc, text_path):
    ports = _free_ports(1 + nproc)
    hostlist = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, THRILL_TPU_HOSTLIST=hostlist,
                   THRILL_TPU_RANK=str(rank),
                   THRILL_TPU_SECRET="test-cluster-secret",
                   THRILL_TPU_TRACE_RING="4096",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for var in ("THRILL_TPU_ASYNC_SEND", "THRILL_TPU_HOST_MIX",
                    "THRILL_TPU_OVERLAP", "THRILL_TPU_TRACE"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             f"127.0.0.1:{ports[0]}", str(rank), str(nproc), text_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


def _drain(procs, timeout_s):
    import concurrent.futures as cf

    from thrill_tpu_torch.common.timeouts import scaled
    timeout_s = scaled(timeout_s)
    with cf.ThreadPoolExecutor(len(procs)) as ex:
        futs = [ex.submit(p.communicate, None, timeout_s) for p in procs]
        try:
            drained = [f.result(timeout=timeout_s + 20) for f in futs]
        except (cf.TimeoutError, subprocess.TimeoutExpired):
            for q in procs:
                q.kill()
            raise AssertionError(f"children timed out ({timeout_s:.0f}s)")
    results = []
    for p, (out, err) in zip(procs, drained):
        assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out}\n{err[-2000:]}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


def _run_children(nproc, text_path, timeout_s=120):
    try:
        return _drain(_launch(nproc, text_path), timeout_s)
    except AssertionError as e:
        print(f"first attempt failed; retrying once:\n{e}", flush=True)
        return _drain(_launch(nproc, text_path), timeout_s)


def _sorted(v):
    return sorted(json.dumps(x) for x in v)


def test_the_async_sender_and_host_mix_equal_the_serial_plane(tmp_path):
    import thrill_tpu_torch as tt

    text = tmp_path / "words.txt"
    text.write_text(_TEXT)
    kids = _run_children(2, str(text))
    one = json.loads(json.dumps(tt.Run(port_job(str(text)), 4,
                                       device="cpu")))
    for k in kids:
        serial, asy, mix = k["serial"], k["async"], k["mix"]
        for key in ("reduce", "group", "join", "sort"):
            # the background sender: the serial plane's items, in order
            assert asy[key] == serial[key], key
            assert serial[key] == one["serial"][key], key
            # arrival order: the same items at the declared sites
            assert _sorted(mix[key]) == _sorted(serial[key]), key
        assert mix["sort"] == serial["sort"]
        # the same frames, so the same bytes, from either sender
        assert asy["bytes"] == serial["bytes"] > 0
        assert serial["async_spans"] == 0
        assert asy["async_spans"] > 0 and mix["async_spans"] > 0
    # every process's results (the bytes each sent are its own)
    for mode in ("serial", "async"):
        for key in ("reduce", "group", "join", "sort"):
            assert kids[0][mode][key] == kids[1][mode][key]


def _mock_mex(pkg, group, W, P):
    """The attributes of a mesh the multiplexers read, over a mock
    group: process ``group.my_rank`` of ``P``, ``W / P`` workers each."""
    Wl = W // P
    me = group.my_rank
    net = pkg.FlowControlChannel(group)
    return types.SimpleNamespace(
        num_workers=W, num_processes=P, process_index=me, num_local=Wl,
        worker_base=me * Wl, local_workers=list(range(me * Wl,
                                                      (me + 1) * Wl)),
        worker_process=np.repeat(np.arange(P), Wl), host_net=net,
        stats_exchanges=0, stats_items_moved=0, tracer=None, logger=None)


def _frames(mux, shards_cls, mock, pkg, items):
    """Run one host exchange on two mock ranks; each rank's sent frames
    (peer, message) and received lists."""
    groups = mock.MockNetwork.construct(2)
    sent = [[], []]
    got = [None, None]
    errors = []

    def rank(r):
        try:
            g = groups[r]
            orig = g.send_to

            def send_to(peer, obj, orig=orig):
                sent[r].append((peer, obj))
                return orig(peer, obj)
            g.send_to = send_to
            mex = _mock_mex(pkg, g, 4, 2)
            lists = [list(items[w]) if w in mex.local_workers else []
                     for w in range(4)]
            out = mux.host_exchange(mex, shards_cls(4, lists),
                                    lambda it: hash(it[0]) % 7,
                                    reason="frames")
            got[r] = out.lists
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=rank, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return sent, got


def test_frames_are_the_reference_s(monkeypatch):
    """The same items through the port's multiplexer (its background
    sender) and the reference's: the same frames to the same peers,
    their wire bytes equal, and the same received lists."""
    import thrill_tpu.net as jnet
    from thrill_tpu.data import multiplexer as jmux
    from thrill_tpu.data.shards import HostShards as JHostShards
    from thrill_tpu.net import mock as jmock
    from thrill_tpu.net import wire as jwire

    import thrill_tpu_torch.net as tnet
    from thrill_tpu_torch.data import multiplexer as tmux
    from thrill_tpu_torch.data.shards import HostShards
    from thrill_tpu_torch.net import mock as tmock
    from thrill_tpu_torch.net import wire

    monkeypatch.delenv("THRILL_TPU_HOST_MIX", raising=False)
    items = [[("k%d" % (w * 31 + i), i, float(i) / 3) for i in range(40)]
             for w in range(4)]
    sent_t, got_t = _frames(tmux, HostShards, tmock, tnet, items)
    sent_j, got_j = _frames(jmux, JHostShards, jmock, jnet, items)
    assert got_t == got_j
    for r in range(2):
        assert [p for p, _ in sent_t[r]] == [p for p, _ in sent_j[r]]
        for (_, mt), (_, mj) in zip(sent_t[r], sent_j[r]):
            assert mt == mj
            assert wire.dumps(mt, allow_pickle=True) == \
                jwire.dumps(mj, allow_pickle=True)


def test_the_async_send_site_is_declared():
    from thrill_tpu_torch.common import faults
    from thrill_tpu_torch.data import multiplexer  # noqa: F401
    assert "net.multiplexer.async_send" in faults.REGISTRY.sites


def _child(coordinator, rank, nproc, text_path):
    import thrill_tpu_torch as tt
    res = tt.RunDistributed(port_job(text_path),
                            coordinator_address=coordinator,
                            num_processes=nproc, process_id=rank,
                            workers_per_process=2, device="cpu")
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
