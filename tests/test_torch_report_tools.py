"""The port's report tools (``thrill_tpu_torch/tools/``) against the
reference package's on the CPU.

Tolerance: exact. Each offline reader (``trace2perfetto``,
``json2profile``, ``json2graphviz``, ``doctor_report``, ``plan_report``)
prints byte for byte what the reference's prints on the same log,
whether the reference wrote that log or the port did; their usage exits
are the reference's. ``fusion_report`` and ``loop_report`` run the
port's jobs with ``--device cpu`` and report the reference's counts at
the reference's sizes and worker count.
"""

import contextlib
import io
import json
import os
import re
import sys

import jax
import pytest

from thrill_tpu.tools import doctor_report as jdoctor_report
from thrill_tpu.tools import fusion_report as jfusion_report
from thrill_tpu.tools import json2graphviz as jjson2graphviz
from thrill_tpu.tools import json2profile as jjson2profile
from thrill_tpu.tools import loop_report as jloop_report
from thrill_tpu.tools import plan_report as jplan_report
from thrill_tpu.tools import trace2perfetto as jtrace2perfetto

from thrill_tpu_torch.tools import (doctor_report, fusion_report,
                                    json2graphviz, json2profile, loop_report,
                                    plan_report, trace2perfetto)

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_trace as T  # noqa: E402  (the jobs and their env)

READERS = {"trace2perfetto": (trace2perfetto, jtrace2perfetto),
           "json2profile": (json2profile, jjson2profile),
           "json2graphviz": (json2graphviz, jjson2graphviz),
           "doctor_report": (doctor_report, jdoctor_report),
           "plan_report": (plan_report, jplan_report)}


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """One W = 2 log per package: PageRank (replayed), Q3-lite, a Sort
    and a hot-keyed reduce, so every lane and table has rows."""
    d = tmp_path_factory.mktemp("tool_logs")
    out = {}
    for pkg in ("port", "ref"):
        path = str(d / f"{pkg}.json")
        with T._Env({"THRILL_TPU_LOG": path, "THRILL_TPU_HOST_RADIX": "0"}):
            ctx = T._make(pkg, 2)
            try:
                for name in ("pagerank_replay", "q3", "sort", "reduce"):
                    T._job(name, ctx, pkg)
                ctx.explain()
            finally:
                ctx.close()
        out[pkg] = path.replace(".json", "-host0.json")
    return out


def _main(mod, argv):
    """Run ``mod.main()`` under ``argv``: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    sys.argv = [mod.__name__.rsplit(".", 1)[-1]] + list(argv)
    code = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                mod.main()
            except SystemExit as e:
                code = e.code
    finally:
        sys.argv = saved
    return code, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("tool", sorted(READERS))
def test_a_reader_prints_the_reference_s_bytes(logs, tool, writer):
    mine, ref = READERS[tool]
    got = _main(mine, [logs[writer]])
    want = _main(ref, [logs[writer]])
    assert got == want
    assert got[0] == 0 and got[1]


@pytest.mark.parametrize("tool", sorted(set(READERS) - {"json2graphviz"}))
def test_two_logs_merge_as_in_the_reference(logs, tool):
    """Several logs merge on one time axis (json2graphviz reads one log
    by its contract)."""
    mine, ref = READERS[tool]
    argv = [logs["port"], logs["ref"]]
    assert _main(mine, argv) == _main(ref, argv)


def test_trace2perfetto_merge_flag(logs):
    argv = ["--merge", logs["port"]]
    assert _main(trace2perfetto, argv) == _main(jtrace2perfetto, argv)


@pytest.mark.parametrize("tool", sorted(READERS))
def test_the_usage_exit_is_the_reference_s(tool):
    """The exit code and the message; plan_report prints its module
    docstring, whose ``python -m`` line names its own package."""
    mine, ref = READERS[tool]
    got, want = _main(mine, []), _main(ref, [])
    assert got[0] == want[0] != 0
    assert (got[1], got[2].replace("thrill_tpu_torch.tools",
                                   "thrill_tpu.tools")) == want[1:]


def test_the_port_s_log_renders_a_stage_table(logs):
    """The event schema at work: the port's node events fill the
    profile's stage table, and its spans the Perfetto lanes."""
    _, html, _ = _main(json2profile, [logs["port"]])
    assert "stage timeline" in html and "Sort" in html
    assert "partition skew" in html
    _, doc, _ = _main(trace2perfetto, [logs["port"]])
    evs = json.loads(doc)["traceEvents"]
    lanes = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"dispatch", "exchange", "fusion", "loop", "plan"} <= lanes
    _, rep, _ = _main(doctor_report, [logs["port"]])
    assert "-- critical path" in rep and "-- partition skew --" in rep


def _ref_workers():
    return len(jax.devices())


def _ref_main(mod, argv):
    """The reference tool's main on its default mesh (every CPU device),
    ``argv`` after the program name."""
    saved = sys.argv
    sys.argv = ["tool"] + list(argv)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def _port_main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(list(argv) + ["--device", "cpu",
                               "--workers", str(_ref_workers())])
    return out.getvalue()


def test_fusion_report_counts_are_the_reference_s(monkeypatch):
    """Dispatches unfused and fused of WordCount and PageRank, their
    difference and ratio, and the fused stage compositions."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    monkeypatch.delenv("THRILL_TPU_FUSE", raising=False)
    got, want = _port_main(fusion_report, []), _ref_main(jfusion_report, [])
    assert got == want
    assert re.search(r"WordCount\s+\d+\s+\d+", got)


def _loop_rows(text):
    """Per loop (iters, hit, plans, fori, donatedB), and the totals line
    without its byte count."""
    rows = {}
    for line in text.splitlines():
        f = line.split()
        if f and f[0] in ("page_rank", "k_means") and len(f) == 10:
            rows[f[0]] = tuple(f[1:6])
    totals = [l for l in text.splitlines() if l.startswith("process")]
    return rows, totals


def test_loop_report_counts_are_the_reference_s(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    monkeypatch.delenv("THRILL_TPU_LOOP_REPLAY", raising=False)
    monkeypatch.setenv("THRILL_TPU_LOOP_DONATE", "0")
    got = _loop_rows(_port_main(loop_report, []))
    want = _loop_rows(_ref_main(jloop_report, []))
    assert got == want
    assert set(got[0]) == {"page_rank", "k_means"}
