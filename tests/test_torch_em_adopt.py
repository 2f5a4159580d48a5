"""Orphan-run adoption (``thrill_tpu_torch/core/em_runs.py``
``adopt_orphan_runs``) against the reference package's on the CPU.

The reference's three cases (``tests/api/test_em_resume.py:238-313``)
run on both packages: an external Sort at W = 2 with runs of 100 items
fills a run store, whose owner is then made a dead process; the
replacement adopts every committed run and the next run loads them
without resume mode; a live owner and another rank's store are not
adopted; a damaged run is skipped. The adopted counts, ``runs_adopted``
and the I/O ledger's counters must equal the reference's, and the
``OWNER.json`` and ``ADOPTED.json`` files must be the reference's, byte
for byte (both packages run in this process, so their pids agree).
Last, a process joining a group through the port's ``join_tcp_group``
adopts the runs a departed rank 1 left.

Tolerance: exact.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import threading

import pytest

from thrill_tpu.api.context import Config as JConfig
from thrill_tpu.api.context import RunLocalMock as JRunLocalMock
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.iostats import IO as JIO
from thrill_tpu.core import em_runs as jem

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults as tfaults
from thrill_tpu_torch.common.config import Config as TConfig
from thrill_tpu_torch.common.iostats import IO as TIO
from thrill_tpu_torch.core import em_runs as tem

LIMIT_S = 240
N = 2000
SIDES = {"j": (jem, jfaults, JIO), "t": (tem, tfaults, TIO)}


@pytest.fixture(autouse=True, scope="module")
def _file_time_limit():
    """This file's own time limit: a test still running past it fails."""
    def expired(*_):
        raise TimeoutError(f"{__name__}: past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_SORT_RUN", "100")
    for var in ("THRILL_TPU_EM_RESUME", "THRILL_TPU_CKPT_DIR",
                "THRILL_TPU_RESUME", tfaults.ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    for mod, faults, _ in SIDES.values():
        monkeypatch.setattr(mod, "_adopted", 0)
        faults.REGISTRY.reset()
    yield
    for _, faults, _ in SIDES.values():
        faults.REGISTRY.reset()


def _data():
    return [(f"k{(i * 7919) % N:05d}", float(i)) for i in range(N)]


def _expect():
    return sorted(_data(), key=lambda t: t[0])


def _run(side, ck, stats=None):
    """The Sort at W = 2 in one package; ``stats`` gains its Context's."""
    def job(ctx):
        out = ctx.Distribute(_data(), storage="host").Sort(
            key_fn=lambda t: t[0]).AllGather()
        if stats is not None:
            stats.update(ctx.overall_stats())
        return [tuple(t) for t in out]

    if side == "j":
        return JRunLocalMock(job, 2, config=JConfig(ckpt_dir=ck))
    return tt.RunLocalMock(job, 2, config=TConfig(ckpt_dir=ck))


def _manifests(ck):
    return sorted(glob.glob(os.path.join(ck, "em_runs", "*", "run_*.json")))


_DEAD = []


def _dead_pid():
    """A pid that is dead (a child that exited and was reaped); one for
    both packages, so their files agree."""
    if not _DEAD:
        p = subprocess.Popen([sys.executable, "-c", "pass"])
        p.wait()
        _DEAD.append(p.pid)
    return _DEAD[0]


def _orphan_store(ck):
    """Every store of ``ck`` owned by a dead process, as a departed
    rank's store looks to its replacement."""
    sigs = sorted(glob.glob(os.path.join(ck, "em_runs", "*")))
    assert sigs
    for sdir in sigs:
        with open(os.path.join(sdir, "OWNER.json"), "w") as f:
            json.dump({"pid": _dead_pid()}, f)
    return sigs


def _files(ck, name):
    out = {}
    for path in sorted(glob.glob(os.path.join(ck, "em_runs", "*", name))):
        with open(path, "rb") as f:
            out[os.path.relpath(path, ck)] = f.read()
    return out


def test_the_owner_record_is_the_reference_s(tmp_path):
    for side in SIDES:
        assert _run(side, str(tmp_path / side)) == _expect()
    owners = {side: _files(str(tmp_path / side), "OWNER.json")
              for side in SIDES}
    assert owners["t"] == owners["j"] and len(owners["t"]) == 1
    assert json.loads(next(iter(owners["t"].values()))) == \
        {"pid": os.getpid()}


def test_orphan_adoption_by_replacement_joiner(tmp_path):
    got = {}
    for side, (mod, _, io) in SIDES.items():
        ck = str(tmp_path / side)
        _run(side, ck)
        formed = len(_manifests(ck))
        sigs = _orphan_store(ck)
        adopted = mod.adopt_orphan_runs(ck, my_rank=0)
        assert adopted == formed == mod.adopted_total()
        for sdir in sigs:
            with open(os.path.join(sdir, "ADOPTED.json")) as f:
                assert json.load(f)["by_pid"] == os.getpid()
            with open(os.path.join(sdir, "OWNER.json")) as f:
                assert json.load(f)["pid"] == os.getpid()
        marks = (_files(ck, "ADOPTED.json"), _files(ck, "OWNER.json"))
        # the adopted store loads its runs without resume mode
        s0, stats = io.snapshot(), {}
        assert _run(side, ck, stats) == _expect()
        s1 = io.snapshot()
        got[side] = {"formed": formed, "adopted": adopted,
                     "spill_runs": s1["spill_runs"] - s0["spill_runs"],
                     "runs_reused": s1["runs_reused"] - s0["runs_reused"],
                     "runs_adopted": stats["runs_adopted"],
                     "again": mod.adopt_orphan_runs(ck, my_rank=0),
                     "marks": marks}
    assert got["t"] == got["j"]
    g = got["t"]
    assert g["spill_runs"] == 0 and g["runs_reused"] == g["formed"]
    assert g["runs_adopted"] == g["formed"] and g["again"] == 0


def test_adoption_skips_live_owner_and_other_ranks(tmp_path):
    for side, (mod, _, _) in SIDES.items():
        ck = str(tmp_path / side)
        _run(side, ck)
        # this live process's own stores are no orphans
        assert mod.adopt_orphan_runs(ck, my_rank=0) == 0
        # nor a live foreign owner's
        for sdir in glob.glob(os.path.join(ck, "em_runs", "*")):
            with open(os.path.join(sdir, "OWNER.json"), "w") as f:
                json.dump({"pid": os.getppid()}, f)
        assert mod.adopt_orphan_runs(ck, my_rank=0) == 0
        # a dead owner, but another rank's store
        _orphan_store(ck)
        assert mod.adopt_orphan_runs(ck, my_rank=1) == 0
        assert mod.adopted_total() == 0
        assert not glob.glob(os.path.join(ck, "em_runs", "*",
                                          "ADOPTED.json"))


def test_adoption_verifies_each_run_and_skips_damage(tmp_path):
    got = {}
    for side, (mod, faults, _) in SIDES.items():
        ck = str(tmp_path / side)
        _run(side, ck)
        formed = len(_manifests(ck))
        assert formed >= 2
        _orphan_store(ck)
        with open(_manifests(ck)[0].replace(".json", ".bin"), "r+b") as f:
            f.truncate(3)                  # shorter than its manifest says
        adopted = mod.adopt_orphan_runs(ck, my_rank=0)
        assert adopted == formed - 1
        assert any(e.get("what") == "em_runs.adopt_skipped_run"
                   for e in faults.REGISTRY.events)
        got[side] = (formed, adopted, _files(ck, "ADOPTED.json"))
    assert got["t"] == got["j"]


def test_a_joiner_adopts_a_departed_rank_s_runs(tmp_path, monkeypatch):
    """Rank 1 left a store (``_h1``) and died; a process joining the
    group as rank 1 through ``join_tcp_group`` adopts its runs."""
    from thrill_tpu_torch.net.tcp import construct_tcp_group, join_tcp_group
    from thrill_tpu_torch.net.tcp import parse_hostlist
    ck = str(tmp_path / "ck")
    _run("t", ck)
    formed = len(_manifests(ck))
    for sdir in glob.glob(os.path.join(ck, "em_runs", "*_h0")):
        shutil.move(sdir, sdir[:-len("_h0")] + "_h1")
    _orphan_store(ck)
    monkeypatch.setenv("THRILL_TPU_CKPT_DIR", ck)
    import socket
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    hosts = parse_hostlist(" ".join(f"127.0.0.1:{s.getsockname()[1]}"
                                    for s in socks))
    for s in socks:
        s.close()
    secret = b"adopt-test-secret"
    member = construct_tcp_group(0, hosts[:1], timeout=60, secret=secret)
    # a group of one has no links: give it the endpoints a grow admits on
    member._hosts, member._secret = list(hosts[:1]), secret
    grown = {}

    def grow():
        try:
            member.resize(2, 2)
            grown["w"] = member.num_hosts
        except Exception as e:
            grown["error"] = repr(e)

    t = threading.Thread(target=grow)
    t.start()
    joiner = join_tcp_group(1, hosts, generation=2, timeout=60,
                            secret=secret)
    joiner.begin_generation(2)
    t.join(60)
    try:
        assert grown == {"w": 2}
        assert tem.adopted_total() == formed
        sdir = glob.glob(os.path.join(ck, "em_runs", "*_h1"))[0]
        with open(os.path.join(sdir, "ADOPTED.json")) as f:
            mark = json.load(f)
        assert mark == {"runs": formed, "by_pid": os.getpid(),
                        "from_pid": _dead_pid()}
        with open(os.path.join(sdir, "OWNER.json")) as f:
            assert json.load(f) == {"pid": os.getpid(), "rank": 1}
        # its store loads runs without resume mode
        assert tem.RunStore(sdir).resume
    finally:
        joiner.close()
        member.close()
