"""The tracer (``thrill_tpu_torch/common/trace.py``), its flight recorder
and the JSON log's event schema against the reference package on the
CPU.

The same jobs (a ReduceByKey, a Sort, PageRank for three iterations with
the loop plain and replayed, and Q3-lite with the location filter
forced), made from numpy seeds, run through both packages at W = 1, 2,
4 with tracing on. Tolerance: exact everywhere. Per job the port's span
counts per lane, its multiset of ``(cat, name)`` and, for every dispatch
span, the chain of its parents' labels equal the reference's; results
are identical with tracing on and off, and ``THRILL_TPU_TRACE=0`` keeps
``SPANS_CREATED`` flat.

The plan lane's ``sort_engine`` and ``sort_engine_audit`` instants are
left out of the comparison: they mirror decision records the port makes
and the reference does not (its stitched ReduceToIndex is a program per
host-known input total, which records its engine; see
``test_torch_decisions.py``). Every other plan instant is compared.
"""

import collections
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import InnerJoin as JInnerJoin
from thrill_tpu.common import trace as jtrace
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults, trace
from thrill_tpu_torch.common.logger import JsonLogger
from thrill_tpu_torch.examples import page_rank as tpr
from thrill_tpu_torch.examples import tpch as ttp

WIDTHS = [1, 2, 4]
JOBS = ["reduce", "sort", "pagerank_plain", "pagerank_replay", "q3"]
_REF_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _ref_pagerank():
    if _REF_EXAMPLES not in sys.path:
        sys.path.insert(0, _REF_EXAMPLES)
    import page_rank
    return page_rank


def _kv(x):
    return (x % 9, x)


def _add(a, b):
    return a + b


def _q3_date(t):
    return t["date"] < 1250


def _q3_okey(t):
    return t["key"]


def _q3_lkey(t):
    return t["orderkey"]


def _q3_join(ot, lt):
    return {"prio": ot["prio"],
            "rev": lt["price"] * (100 - lt["discount_pct"])}


def _q3_prio(t):
    return t["prio"]


def _q3_add(a, b):
    return {"prio": a["prio"], "rev": a["rev"] + b["rev"]}


_EDGES = tpr.zipf_graph(128, 512, seed=3)
_SORT_IN = np.random.default_rng(5).integers(0, 1 << 40, size=600,
                                             dtype=np.int64)
_TABLES = ttp.generate_tables(1 << 10, 4, seed=3)


def _job(name, ctx, pkg):
    if name == "reduce":
        return sorted((int(k), int(v)) for k, v in ctx.Distribute(
            np.arange(72, dtype=np.int64)).Map(_kv).ReducePair(
                _add).AllGather())
    if name == "sort":
        return [int(x) for x in ctx.Distribute(_SORT_IN).Sort().AllGather()]
    if name.startswith("pagerank"):
        mod = tpr if pkg == "port" else _ref_pagerank()
        return np.asarray(mod.page_rank(ctx, _EDGES, 128, iterations=3)
                          ).tolist()
    join = tt.InnerJoin if pkg == "port" else JInnerJoin
    orders, lineitem = _TABLES
    o = ctx.Distribute(orders).Filter(_q3_date)
    j = join(o, ctx.Distribute(lineitem), _q3_okey, _q3_lkey, _q3_join,
             location_detection=True)
    return [int(t["rev"]) for t in j.ReduceToIndex(
        _q3_prio, _q3_add, 5, neutral={"prio": 0, "rev": 0}).AllGather()]


def _env(name):
    return {"THRILL_TPU_HOST_RADIX": "0", "THRILL_TPU_TRACE_RING": "1000000",
            "THRILL_TPU_LOOP_REPLAY": "0" if name == "pagerank_plain"
            else "1"}


class _Env:
    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        for k, v in self.env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _make(pkg, W):
    if pkg == "port":
        return tt.Context(num_workers=W, device="cpu")
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _chains(ring):
    """For every dispatch span, its name and the ``cat:name`` labels of
    its ancestors, innermost first."""
    by_id = {r["span"]: r for r in ring}
    out = []
    for r in ring:
        if r["cat"] != "dispatch":
            continue
        chain, p = [], r.get("parent")
        while p is not None and p in by_id:
            chain.append(f"{by_id[p]['cat']}:{by_id[p]['name']}")
            p = by_id[p].get("parent")
        out.append((r["name"], tuple(chain)))
    return collections.Counter(out)


_PORT_ONLY = {("plan", "sort_engine"), ("plan", "sort_engine_audit")}


def _run(name, pkg, W):
    with _Env(_env(name)):
        ctx = _make(pkg, W)
        try:
            res = _job(name, ctx, pkg)
            ring = list(ctx.tracer.ring)
            # the ring holds every record: the lane totals are its
            assert dict(collections.Counter(r["cat"] for r in ring)) == \
                ctx.tracer.lane_counts
            kept = [r for r in ring if (r["cat"], r["name"]) not in _PORT_ONLY]
            return {"res": res,
                    "lanes": dict(collections.Counter(r["cat"] for r in kept)),
                    "names": collections.Counter(
                        (r["cat"], r["name"]) for r in kept),
                    "chains": _chains(ring),
                    "dispatch_lane": ctx.tracer.lane_counts.get("dispatch", 0),
                    "dispatches":
                        ctx.overall_stats()["device_dispatches"]}
        finally:
            ctx.close()


@pytest.fixture(scope="module")
def runs():
    return {(name, W, pkg): _run(name, pkg, W)
            for name in JOBS for W in WIDTHS for pkg in ("port", "ref")}


CASES = [(n, W) for n in JOBS for W in WIDTHS]


@pytest.mark.parametrize("name,W", CASES)
def test_results_are_the_reference_s(runs, name, W):
    port, ref = runs[(name, W, "port")], runs[(name, W, "ref")]
    if name.startswith("pagerank"):
        # the reference folds the contributions unordered: 1e-12 relative
        np.testing.assert_allclose(port["res"], ref["res"], rtol=1e-12)
    else:
        assert port["res"] == ref["res"]


@pytest.mark.parametrize("name,W", CASES)
def test_lane_counts_are_the_reference_s(runs, name, W):
    port, ref = runs[(name, W, "port")], runs[(name, W, "ref")]
    assert port["lanes"] == ref["lanes"]
    # the dispatch lane counts the choke point's calls
    assert port["dispatch_lane"] == port["dispatches"] == ref["dispatches"]


@pytest.mark.parametrize("name,W", CASES)
def test_span_names_are_the_reference_s(runs, name, W):
    assert runs[(name, W, "port")]["names"] == runs[(name, W, "ref")]["names"]


@pytest.mark.parametrize("name,W", CASES)
def test_dispatch_parent_chains_are_the_reference_s(runs, name, W):
    assert runs[(name, W, "port")]["chains"] == \
        runs[(name, W, "ref")]["chains"]


def test_replayed_pagerank_has_one_replay_window(runs):
    """The whole-loop window: one ``replay`` span holding one
    ``loop_fori`` dispatch span, as in the reference."""
    for W in WIDTHS:
        port = runs[("pagerank_replay", W, "port")]
        assert port["names"][("loop", "replay")] == 1
        assert port["names"][("loop", "capture")] == 1
        assert port["chains"][("loop_fori", ("loop:replay",))] == 1


@pytest.mark.parametrize("name", JOBS)
def test_trace_off_is_a_pinned_no_op(runs, name, monkeypatch):
    """``THRILL_TPU_TRACE=0``: no span is made, and the results equal the
    traced run's."""
    monkeypatch.setenv("THRILL_TPU_TRACE", "0")
    before = trace.SPANS_CREATED
    with _Env(_env(name)):
        ctx = _make("port", 2)
        try:
            res = _job(name, ctx, "port")
            assert not ctx.tracer.enabled
            assert ctx.tracer.lane_counts == {}
            assert ctx.tracer.dump_flight("x") is None
        finally:
            ctx.close()
    assert trace.SPANS_CREATED == before
    assert res == runs[(name, 2, "port")]["res"]


def test_flight_recorder_names_the_failing_dispatch(tmp_path, monkeypatch):
    """A fault at every dispatch after the second fails a W = 2 Sort at
    its fused ship-and-merge (the exchange's dispatch, retries and all);
    the dump and its decision-ledger sibling appear, the dump's last
    record is the exchange span with ``error``, and the last dispatch
    span with an error names the failing program. A fresh Context then
    runs clean."""
    monkeypatch.setenv("THRILL_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    monkeypatch.setenv(faults.ENV_VAR, "api.mesh.dispatch:n=0:after=2")
    faults.REGISTRY.reset()
    try:
        with pytest.raises(faults.InjectedFault):
            tt.Run(lambda c: _job("sort", c, "port"), 2, device="cpu")
    finally:
        monkeypatch.delenv(faults.ENV_VAR)
        faults.REGISTRY.reset()
    dumps = sorted(p for p in os.listdir(tmp_path) if p.startswith("flight-"))
    assert len(dumps) == 1
    assert os.path.exists(tmp_path / ("decisions-" + dumps[0][7:]))
    lines = [json.loads(l) for l in open(tmp_path / dumps[0])]
    head, recs = lines[0], lines[1:]
    assert head["event"] == "flight_header"
    assert "api.mesh.dispatch" in head["reason"]
    assert head["faults"] == "api.mesh.dispatch:n=0:after=2"
    assert (recs[-1]["cat"], recs[-1]["name"]) == ("exchange", "sort_fused")
    assert "api.mesh.dispatch" in recs[-1]["error"]
    failed = [r for r in recs if r["cat"] == "dispatch" and "error" in r]
    assert [r["name"] for r in failed] == ["sort_fused"]
    assert recs[-1]["span"] == failed[-1]["parent"]
    # the next job on a fresh Context runs clean
    assert tt.Run(lambda c: _job("sort", c, "port"), 2, device="cpu") == \
        sorted(int(x) for x in _SORT_IN)


@pytest.mark.parametrize("off", ["0", "off", "none"])
def test_flight_dir_off_switch(off, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_FLIGHT_DIR", off)
    assert trace.flight_dir() is None and jtrace.flight_dir() is None
    tr = trace.Tracer(ring=8, enabled=True)
    tr.instant("mem", "x")
    assert tr.dump_flight("r") is None


def test_prune_keeps_the_newest_and_drops_their_siblings(tmp_path):
    """Both packages' ``_prune`` leave the same files."""
    out = []
    for mod in (trace, jtrace):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        for i in range(5):
            for pre in ("flight-", "decisions-"):
                p = d / f"{pre}{i}.json"
                p.write_text("{}\n")
                os.utime(p, (1000 + i, 1000 + i))
        (d / "other.json").write_text("{}\n")
        mod._prune(str(d), 2)
        out.append(sorted(os.listdir(d)))
    assert out[0] == out[1] == ["decisions-3.json", "decisions-4.json",
                                "flight-3.json", "flight-4.json",
                                "other.json"]


def test_flight_keep_prunes_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("THRILL_TPU_FLIGHT_KEEP", "3")
    tr = trace.Tracer(ring=8, enabled=True)
    tr.instant("mem", "x")
    paths = [tr.dump_flight(f"r{i}") for i in range(5)]
    assert all(paths)
    assert len(os.listdir(tmp_path)) == 3


def _stack_trace(mod):
    tr = mod.Tracer(ring=64, enabled=True)
    a = tr.begin("loop", "a")
    tr.begin("exchange", "leaked")          # never ended
    tr.end(a)
    with tr.span("dispatch", "after"):
        tr.instant("mem", "mark")
    return [(r["cat"], r["name"], r.get("parent")) for r in tr.ring], \
        tr.current_id(), dict(tr.lane_counts)


def test_the_stack_recovers_from_leaked_spans():
    port, ref = _stack_trace(trace), _stack_trace(jtrace)
    assert port == ref
    recs, cur, _ = port
    assert cur is None
    # "a" ended and took the leaked span off the stack: the span after it
    # has no parent, and the instant inside names that span
    assert [r[:2] for r in recs] == [("loop", "a"), ("mem", "mark"),
                                     ("dispatch", "after")]
    assert recs[2][2] is None and recs[1][2] is not None


def test_emit_span_and_instant_of_match_the_reference():
    out = []
    for mod in (trace, jtrace):
        tr = mod.Tracer(ring=64, enabled=True)
        with mod.span_of(tr, "exchange", "outer", rows=3):
            tr.emit_span("host", "waited", 0.0, 0.5, what="q")
            mod.instant_of(tr, "mem", "rung", freed=None, k=2)
        mod.instant_of(None, "mem", "nothing")
        assert mod.span_of(None, "x", "y") is mod._NULL
        out.append([{k: v for k, v in r.items()
                     if k not in ("ts", "trace", "dur_us")}
                    for r in tr.ring])
    assert out[0] == out[1]


def _log_events(path):
    return [json.loads(l) for l in open(path)]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """The PageRank (replayed), Q3-lite and Sort jobs at W = 2 with a
    log, in both packages."""
    d = tmp_path_factory.mktemp("logs")
    out = {}
    for pkg in ("port", "ref"):
        path = str(d / f"{pkg}.json")
        with _Env({"THRILL_TPU_LOG": path, "THRILL_TPU_HOST_RADIX": "0"}):
            ctx = _make(pkg, 2)
            try:
                for name in ("pagerank_replay", "q3", "sort"):
                    _job(name, ctx, pkg)
            finally:
                ctx.close()
        out[pkg] = _log_events(path.replace(".json", "-host0.json"))
    return out


def test_the_log_carries_the_reference_s_event_kinds(logs):
    """Every event kind the reference logs for the same jobs appears,
    but the job plane's and the net's."""
    ref = {e["event"] for e in logs["ref"]}
    port = {e["event"] for e in logs["port"]}
    want = {k for k in ref if not k.startswith(("job_", "net"))}
    assert want - port == set()
    for kind in ("node_execute_start", "node_execute_done", "mem_negotiate",
                 "span", "exchange", "decision"):
        assert kind in port


def test_every_line_has_event_ts_and_host(logs):
    for e in logs["port"]:
        assert isinstance(e["event"], str)
        assert isinstance(e["ts"], int)
        assert isinstance(e["host"], int)


def test_timestamps_are_monotonic(logs):
    """A line is written when its event ends: a span at its end (``ts``
    is its start), any other line at its ``ts``."""
    ends = [e["ts"] + e.get("dur_us", 0) for e in logs["port"]]
    assert all(b >= a - 1 for a, b in zip(ends, ends[1:]))


def test_a_stall_as_a_span_opens_keeps_its_end_after_its_lines(
        tmp_path, monkeypatch):
    """The thread stalls 5 ms just after the span's first clock read (a
    preemption, another thread holding the interpreter): the span's end
    (``ts + dur_us``) must still not fall before a line logged inside
    it. Exact, in whole microseconds."""
    from thrill_tpu_torch.common import logger as logger_mod
    log = JsonLogger(str(tmp_path / "l.json"), host=0)
    tr = trace.Tracer(logger=log, ring=8, enabled=True)
    base = log._perf0 + 1.0
    reads = iter([base, base + 0.005] + [base + 0.006 + i * 1e-3
                                         for i in range(8)])

    class Clock:
        perf_counter = staticmethod(lambda: next(reads))
        time = staticmethod(lambda: log._wall0)

    monkeypatch.setattr(trace, "time", Clock)
    monkeypatch.setattr(logger_mod, "time", Clock)
    with tr.span("exchange", "phase_a"):
        log.line(event="inside")
    monkeypatch.undo()
    log.close()
    inside, span = _log_events(str(tmp_path / "l.json"))
    assert (inside["event"], span["event"]) == ("inside", "span")
    assert span["ts"] + span["dur_us"] >= inside["ts"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_tensor_log_field_raises(tmp_path, device):
    """Serialising a tensor would copy it to the host (a sync on the
    card): the logger refuses every tensor, wherever it lies."""
    log = JsonLogger(str(tmp_path / "l.json"))
    with pytest.raises(TypeError, match="not a log field"):
        log.line(event="x", bad=torch.zeros(2, device=device))
    log.line(event="ok", n=np.int64(3), a=np.arange(2))
    log.close()


def test_a_child_logger_shares_the_file_and_the_clock(tmp_path):
    parent = JsonLogger(str(tmp_path / "l.json"), host=0)
    child = JsonLogger(parent=parent, stage="s")
    assert child.enabled
    assert (child._wall0, child._perf0) == (parent._wall0, parent._perf0)
    child.line(event="c")
    child.close()
    assert parent.enabled and not child.enabled
    parent.line(event="p")
    parent.close()
    lines = [json.loads(l) for l in open(tmp_path / "l.json")]
    assert [(l["event"], l.get("stage"), l["host"]) for l in lines] == \
        [("c", "s", 0), ("p", None, 0)]


def test_the_port_imports_neither_jax_nor_the_reference():
    import subprocess
    code = ("import sys; import thrill_tpu_torch.common.trace, "
            "thrill_tpu_torch.common.doctor, thrill_tpu_torch.common.metrics, "
            "thrill_tpu_torch.common.profile, thrill_tpu_torch.common.stats; "
            "import thrill_tpu_torch.tools.json2profile, "
            "thrill_tpu_torch.tools.trace2perfetto, "
            "thrill_tpu_torch.tools.doctor_report, "
            "thrill_tpu_torch.tools.plan_report, "
            "thrill_tpu_torch.tools.json2graphviz, "
            "thrill_tpu_torch.tools.fusion_report, "
            "thrill_tpu_torch.tools.loop_report; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'thrill_tpu' or "
            "m.startswith('thrill_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
