"""Deterministic perf-contract sentinel (counterpart of the reference
package's ``tools/perf_sentinel.py``).

Wall-clock ratios swing 2-7x on shared machines, so a regression hides
in their noise; the counters the framework keeps are deterministic for a
fixed program: device dispatches (a broken stitching shows as a dispatch
jump), uploads and counted fetches, data-driven plan builds, exchanges
and their overlap, the spill tier's runs, blocks and readahead, the
service plane's jobs and the front door's connections, and the bytes
between processes. This tool runs eleven small fixed-seed workloads at
W = 2, each on a fresh Context, snapshots those counters into a contract
and checks a fresh run against it:

* the counters in :data:`COUNTERS` compare exactly;
* the byte totals in :data:`BYTE_FIELDS` compare within a band
  (``THRILL_TPU_SENTINEL_BAND``, default 0.25): padded capacities may
  move with the power-of-two ratchet, a silent 2x may not.

The port's entry points run on the card unless asked otherwise, so the
workloads run on ``--device cuda`` by default (``cpu`` without a card).
A contract records its device; ``--check`` refuses a contract of the
other device. The two contracts live beside this module,
``perf_contract_cpu.json`` and ``perf_contract_cuda.json``.

Usage::

    python -m thrill_tpu_torch.tools.perf_sentinel --snapshot [PATH]
        [--device cuda|cpu]
    python -m thrill_tpu_torch.tools.perf_sentinel --check [PATH]
        [--device cuda|cpu]

``--check`` exits 0 when clean, 1 with a per-field diff on any
violation, 2 when the contract cannot be read or is of the other device.
The knobs that are never legitimate during a measurement (a warm plan
store, armed faults, a serving port, ...: :data:`_SCRUB`) are taken out
of the environment around the runs by :func:`snapshot` itself; the
knobs that change counters deterministically (``THRILL_TPU_FUSE`` and
the like: :data:`ENV_NOTE`) are honoured, so a run under them fails on
its counters, and the contract notes them for the reader.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

#: counters that must match exactly between contract and fresh run: the
#: dispatch choke point's, the plan layer's, the spill tier's (spilled
#: runs, columnar record blocks, readahead submissions, write-behind
#: bytes), the service plane's (jobs; a resize-free run's resizes and
#: their milliseconds are exactly zero), the object store's requests
#: and the runs a resumed Sort reused, the front door's, and the
#: process moves, autoscaler decisions and adopted runs (zero on a run
#: that never resizes)
COUNTERS = (
    "device_dispatches", "device_uploads", "device_fetches",
    "fused_dispatches", "fused_ops",
    "exchanges", "exchanges_overlapped",
    "cap_cache_hits", "cap_cache_misses",
    "plan_builds", "items_moved",
    "spill_runs", "records_blocks", "prefetch_submits",
    "writeback_bytes",
    "jobs_submitted", "jobs_failed", "jobs_rejected",
    "resizes", "resize_time_ms",
    "remote_gets", "remote_puts", "runs_reused",
    "fd_conns_accepted", "fd_conns_dropped", "fd_jobs_submitted",
    "fd_jobs_rejected", "fd_chunks_sent", "fd_slow_clients",
    "fd_deadline_expired",
    "resizes_proc", "autoscale_decisions", "runs_adopted",
)

#: byte totals compared within the band (the power-of-two capacity
#: ratchet may move padded volume without a regression)
BYTE_FIELDS = ("bytes_on_wire", "bytes_on_wire_raw", "bytes_moved")

#: knobs that change the counters, recorded in the contract for the
#: reader of a failure; never a comparison guard (a knob-skewed check
#: must fail on its counters)
ENV_NOTE = (
    "THRILL_TPU_FUSE", "THRILL_TPU_OVERLAP", "THRILL_TPU_XCHG_CHUNKS",
    "THRILL_TPU_XCHG_CAP_CACHE", "THRILL_TPU_XCHG_NARROW",
    "THRILL_TPU_WIRE_COMPRESS", "THRILL_TPU_PLANNER",
    "THRILL_TPU_EXCHANGE",
    "THRILL_TPU_LOCATION_DETECT", "THRILL_TPU_DUP_DETECT",
    "THRILL_TPU_LOOP_REPLAY", "THRILL_TPU_FORI",
    "THRILL_TPU_NATIVE_RECORDS", "THRILL_TPU_PREFETCH",
    "THRILL_TPU_WRITEBACK", "THRILL_TPU_HOST_RADIX",
    "THRILL_TPU_PALLAS", "THRILL_TPU_SORT_IMPL",
    "THRILL_TPU_XCHG_BYTES_EQ", "THRILL_TPU_XCHG_BYTES_EQ_CAL",
)

#: state never legitimate during a measurement, taken out of the
#: environment around the runs and put back after: a warm plan store
#: (no plan builds by design), armed faults (retry paths), a checkpoint
#: directory or resume, and the service knobs whose effect depends on
#: wall-clock timing (a finite submit queue, rate limits, tenant caps,
#: a serving port that would bind a front door into every workload, an
#: autoscale tick)
_SCRUB = ("THRILL_TPU_PLAN_STORE", "THRILL_TPU_FAULTS",
          "THRILL_TPU_CKPT_DIR", "THRILL_TPU_RESUME",
          "THRILL_TPU_SERVE_QUEUE",
          "THRILL_TPU_SERVE_RATE", "THRILL_TPU_SERVE_TENANT_QUEUE",
          "THRILL_TPU_SERVE_PORT",
          "THRILL_TPU_AUTOSCALE_S")

VERSION = 1
DEVICES = ("cuda", "cpu")


def _band() -> float:
    try:
        v = float(os.environ.get("THRILL_TPU_SENTINEL_BAND", "0.25"))
    except ValueError:
        return 0.25
    return v if v > 0 else 0.25


# -- workloads: small, fixed-seed, W = 2, each on a fresh Context ---------

def _wc_scale(x):
    return x * 3 + 1


def _wc_odd(x):
    return x % 2 == 1


def _wc_kv(x):
    return (x % 13, x)


def _wc_add(a, b):
    return a + b


def _wordcount(ctx):
    """ReduceByKey under a Map/Filter stack: stitching (the stack joins
    the pre phase), the hash exchange, the pre-shuffle cost model."""
    return sorted(
        (int(k), int(v)) for k, v in ctx.Distribute(
            np.arange(384, dtype=np.int64)).Map(_wc_scale).Filter(
                _wc_odd).Map(_wc_kv).ReducePair(_wc_add).AllGather())


def _sort(ctx):
    """The sample sort: splitter agreement and the range exchange."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 1 << 30, size=512).astype(np.int64)
    return ctx.Distribute(data).Sort().AllGather()


def _kv_mod(x):
    return (x % 24, x)


def _kv_ident(x):
    return (x, x * 3)


def _key0(kv):
    return kv[0]


def _join_vals(left, right):
    return (left[1], right[1])


def _joinish(ctx):
    """A hash join: two shuffles and the location filter's cost model."""
    from ..api.dia import InnerJoin
    left = ctx.Distribute(np.arange(240, dtype=np.int64)).Map(_kv_mod)
    right = ctx.Distribute(np.arange(24, dtype=np.int64)).Map(_kv_ident)
    j = InnerJoin(left, right, _key0, _key0, _join_vals)
    return sorted((int(a), int(b)) for a, b in j.AllGather())


def _chain_inc(x):
    return x + 1


def _chain(ctx):
    """A chain of row-local ops: one stitched dispatch when stitching
    is healthy, one an op when it breaks."""
    return ctx.Distribute(np.arange(256, dtype=np.int64)).PrefixSum() \
        .Map(_chain_inc).ZipWithIndex().AllGather()


def _radix_sort(ctx):
    """The sample sort forced through the LSD radix engine (B2's
    kernels on the card): a silent fall back to another engine, or a
    dead-pass skip that regressed, moves its dispatches."""
    rng = np.random.default_rng(17)
    data = rng.integers(0, 1 << 30, size=512).astype(np.int64)
    got = [int(x) for x in ctx.Distribute(data).Sort().AllGather()]
    assert got == sorted(int(x) for x in data), "radix_sort diverged"


def _ss_key(t):
    return t["k"]


def _segsum(ctx):
    """An f32 FieldReduce "sum": ReduceByKey's shuffle and fold."""
    from ..api.functors import FieldReduce
    rng = np.random.default_rng(19)
    n = 768
    ks = rng.integers(0, 48, size=n).astype(np.int64)
    vs = (rng.random(n) * 4).astype(np.float32)
    out = ctx.Distribute({"k": ks, "v": vs}).ReduceByKey(
        _ss_key, FieldReduce({"k": "first", "v": "sum"})).AllGather()
    assert len(out) == len(set(int(k) for k in ks)), "segsum diverged"


def _em_sort(ctx):
    """The host external-memory sort: string items spilled as sorted
    runs through the columnar record format in a pinned disk-resident
    regime, then merged with readahead (about 170 KiB spilled, past the
    64 KiB residency floor, so the merge reads blocks from disk)."""
    rng = np.random.default_rng(23)
    items = [f"k-{int(v):09d}" for v in
             rng.integers(0, 1 << 30, size=4096)]
    hs = ctx.Distribute(items, storage="host").Sort().node.materialize()
    assert sum(len(lst) for lst in hs.lists) == len(items)


def _em_remote(ctx):
    """ReadLines -> Sort -> WriteLinesOne against the object server at
    zero latency and failure rate: the transport's request economy
    (ranged GETs, PUTs) is this workload's contract."""
    from .object_server import ObjectServer
    rng = np.random.default_rng(29)
    lines = sorted(f"r-{int(v):09d}" for v in
                   rng.integers(0, 1 << 30, size=512))
    with ObjectServer() as srv:
        srv.put("b/in-00.txt", "\n".join(lines[0::2]).encode() + b"\n")
        srv.put("b/in-01.txt", "\n".join(lines[1::2]).encode() + b"\n")
        d = ctx.ReadLines(f"{srv.url}/b/in-*").Sort()
        d.WriteLinesOne(f"{srv.url}/b/out.txt")
        got = ctx.ReadLines(f"{srv.url}/b/out.txt").AllGather()
    assert got == lines, "em_remote: remote roundtrip diverged"


def _er_key(t):
    return t[0]


def _em_resume(ctx):
    """An external-memory Sort with checkpoints forms and commits its
    spilled runs, then the same program runs again resumed: it reuses
    every committed run and forms none. Both legs run as nested runs
    inside the workload's Context, on its device; the I/O ledger is
    process-wide, so the outer Context reports the pair."""
    import tempfile
    from ..api.context import Run
    from ..common.config import Config
    n = 1600
    data = [(f"k{(i * 7919) % n:05d}", float(i)) for i in range(n)]
    dev = ctx.mesh_exec.device

    def job(c):
        return c.Distribute(data, storage="host").Sort(
            key_fn=_er_key).AllGather()

    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck")
        first = Run(job, 2, device=dev, config=Config(ckpt_dir=ck))
        again = Run(job, 2, device=dev,
                    config=Config(ckpt_dir=ck, resume=True))
    assert first == again == sorted(data, key=_er_key), \
        "em_resume: resumed sort diverged"


def _serve_wc(ctx):
    return sorted(
        (int(k), int(v)) for k, v in ctx.Distribute(
            np.arange(128, dtype=np.int64)).Map(_wc_kv).ReducePair(
                _wc_add).AllGather())


def _serve_chain(ctx):
    return [int(v) for v in ctx.Distribute(
        np.arange(96, dtype=np.int64)).Map(_chain_inc).PrefixSum()
        .AllGather()]


def _fd_stream(ctx, args):
    for i in range(int(args["k"])):
        yield i * i


def _fd_wc(ctx, args):
    return _serve_wc(ctx)


def _front_door(ctx):
    """One loopback client through a FrontDoor on the Context: the
    admission protocol and both result modes. Sequential submits pin the
    edge's economy (1 connection, 3 submits, the chunks) and a zero row
    of sheds, slow-client drops and deadline expiries."""
    from ..service.client import FrontDoorClient
    from ..service.front_door import FrontDoor
    fd = FrontDoor(ctx, port=0)
    fd.register("wc", _fd_wc)
    fd.register("stream", _fd_stream)
    with FrontDoorClient("127.0.0.1", fd.port, tenant="a") as cli:
        r1 = cli.submit("wc", None).result(120)
        r2 = cli.submit("wc", None).result(120)
        assert r1 == r2, "front_door: repeated job diverged"
        items = list(cli.submit("stream", {"k": 4}).chunks(timeout=120))
        assert items == [0, 1, 4, 9], "front_door: stream diverged"
    # the client's bye lands asynchronously: wait (bounded) for the drop
    # so fd_conns_dropped is deterministic
    deadline = time.monotonic() + 30.0
    while fd.conns_dropped < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fd.conns_dropped == 1, "front_door: bye never landed"


def _serve(ctx):
    """Tenant-tagged jobs through ``ctx.submit`` on a W = 2 mesh that
    never changes width: jobs_submitted pins the lane, resizes and
    rejections are zero. Jobs serialize on the dispatcher, so the
    dispatch and exchange counters are the program's."""
    futs = [ctx.submit(_serve_wc, tenant="a", name="wc0"),
            ctx.submit(_serve_chain, tenant="b", name="chain0"),
            ctx.submit(_serve_wc, tenant="a", name="wc1")]
    got = [f.result(timeout=120) for f in futs]
    assert got[0] == got[2], "serve lane: repeated job diverged"


WORKLOADS: Dict[str, Callable] = {
    "wordcount": _wordcount,
    "sort": _sort,
    "radix_sort": _radix_sort,
    "segsum": _segsum,
    "join": _joinish,
    "chain": _chain,
    "em_sort": _em_sort,
    "em_remote": _em_remote,
    "em_resume": _em_resume,
    "serve": _serve,
    "front_door": _front_door,
}

#: per-workload environment pins, set around the run and restored: the
#: radix lane forces its engine; it and the segsum lane pin the exchange
#: cost model's calibration off, so the dense or one-factor choice never
#: depends on this machine's launch overhead; the external-memory lanes
#: force a run size and the floor resident budget, the same on both
#: resume legs so run identities match; a short retry base keeps the
#: (fault-free) remote lane from sleeping on a loopback hiccup
ENV_PINS: Dict[str, Dict[str, str]] = {
    "radix_sort": {"THRILL_TPU_SORT_IMPL": "radix",
                   "THRILL_TPU_XCHG_BYTES_EQ_CAL": "0"},
    "segsum": {"THRILL_TPU_XCHG_BYTES_EQ_CAL": "0"},
    "em_sort": {"THRILL_TPU_HOST_SORT_RUN": "256",
                "THRILL_TPU_SPILL_RESIDENT": "64K"},
    "em_resume": {"THRILL_TPU_HOST_SORT_RUN": "200",
                  "THRILL_TPU_SPILL_RESIDENT": "64K"},
    "em_remote": {"THRILL_TPU_RETRY_BASE_S": "0.01"},
}


def _run_workload(fn, workers: int = 2, pins=None,
                  device: str = "cuda") -> dict:
    from ..api.context import Run
    stats_box = {}

    def job(ctx):
        fn(ctx)
        stats_box.update(ctx.overall_stats())

    saved = {k: os.environ.get(k) for k in (pins or {})}
    os.environ.update(pins or {})
    try:
        Run(job, workers, device=device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {k: int(stats_box.get(k, 0)) for k in COUNTERS}
    # whole milliseconds, rounded: int() of the seconds would read a
    # 0.9 s resize as 0 and hide the very event this field is for
    out["resize_time_ms"] = int(round(
        float(stats_box.get("resize_time_s", 0.0)) * 1000))
    out.update({k: int(stats_box.get(k, 0)) for k in BYTE_FIELDS})
    return out


def snapshot(workloads=None, workers: int = 2,
             device: str = "cuda") -> dict:
    """Run each workload on a fresh W = ``workers`` mesh on ``device``,
    with :data:`_SCRUB` out of the environment, and collect its
    counters."""
    # a name this checkout does not know does not run: diff() reports it
    names = [n for n in (workloads or WORKLOADS) if n in WORKLOADS]
    saved = {k: os.environ.pop(k) for k in _SCRUB if k in os.environ}
    try:
        runs = {name: _run_workload(WORKLOADS[name], workers,
                                    pins=ENV_PINS.get(name), device=device)
                for name in names}
    finally:
        os.environ.update(saved)
    return {
        "version": VERSION,
        "device": device,
        "workers": workers,
        "env": {k: os.environ.get(k) for k in ENV_NOTE
                if os.environ.get(k) is not None},
        "workloads": runs,
    }


def diff(contract: dict, fresh: dict) -> List[str]:
    """Violations of ``fresh`` against ``contract`` (empty: clean). The
    env note is not compared: a knob-skewed run fails on its counters."""
    problems: List[str] = []
    if contract.get("version") != fresh.get("version"):
        problems.append(
            f"contract version {contract.get('version')} != "
            f"{fresh.get('version')} (re-snapshot)")
        return problems
    if contract.get("device") != fresh.get("device"):
        problems.append(
            f"contract device {contract.get('device')} != "
            f"{fresh.get('device')} (a contract holds one device)")
        return problems
    band = _band()
    for name, want in contract.get("workloads", {}).items():
        got = fresh.get("workloads", {}).get(name)
        if got is None:
            problems.append(f"{name}: workload missing from fresh run")
            continue
        for k in COUNTERS:
            if int(got.get(k, 0)) != int(want.get(k, 0)):
                problems.append(
                    f"{name}.{k}: {want.get(k, 0)} -> {got.get(k, 0)} "
                    f"(exact counter contract)")
        for k in BYTE_FIELDS:
            w, g = int(want.get(k, 0)), int(got.get(k, 0))
            if w == 0 and g == 0:
                continue
            lo, hi = w * (1 - band), w * (1 + band)
            if not (lo <= g <= hi):
                problems.append(
                    f"{name}.{k}: {w} -> {g} "
                    f"(outside the +/-{band:.0%} byte band)")
    for name in fresh.get("workloads", {}):
        if name not in contract.get("workloads", {}):
            problems.append(
                f"{name}: not in the contract (re-snapshot to adopt)")
    return problems


def default_path(device: str) -> str:
    """The package's contract of ``device``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"perf_contract_{device}.json")


def _parse(argv: List[str]):
    mode = path = None
    device = "cuda"
    it = iter(argv)
    for a in it:
        if a in ("--snapshot", "--check") and mode is None:
            mode = a
        elif a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif not a.startswith("--") and path is None:
            path = a
        else:
            return None
    if mode is None or device not in DEVICES:
        return None
    return mode, path or default_path(device), device


def main(argv: Optional[List[str]] = None) -> int:
    parsed = _parse(list(sys.argv[1:] if argv is None else argv))
    if parsed is None:
        print("usage: perf_sentinel --snapshot|--check [CONTRACT.json] "
              "[--device cuda|cpu]", file=sys.stderr)
        return 2
    mode, path, device = parsed
    if mode == "--snapshot":
        snap = snapshot(device=device)
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"perf_sentinel: contract written to {path} "
              f"({len(snap['workloads'])} workloads on {device})")
        return 0
    try:
        with open(path) as f:
            contract = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"perf_sentinel: cannot read contract {path}: {e}",
              file=sys.stderr)
        return 2
    if contract.get("device") != device:
        print(f"perf_sentinel: {path} is a contract of device "
              f"{contract.get('device')!r}, not {device!r}",
              file=sys.stderr)
        return 2
    fresh = snapshot(workloads=contract.get("workloads"), device=device)
    problems = diff(contract, fresh)
    if problems:
        print(f"perf_sentinel: {len(problems)} contract violation(s) "
              f"vs {path}:", file=sys.stderr)
        for p in problems:
            print(f"  REGRESSION {p}", file=sys.stderr)
        return 1
    print(f"perf_sentinel: clean: "
          f"{len(contract.get('workloads', {}))} workloads match {path} "
          f"on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
