"""The perf sentinel (``thrill_tpu_torch/tools/perf_sentinel.py``)
against the reference's (``thrill_tpu/tools/perf_sentinel.py``).

The reference's live snapshot is taken once for the module. Each of the
eleven workloads runs through the port on a CPU mesh at W = 2, and its
counters equal the reference's exactly, its byte totals within the
sentinel's band, save the entries of :data:`EXPECTED`: a difference
named by a recorded fault (``ROADMAP.md`` queue C), asserted at the
port's exact value. The port's committed CPU contract holds a fresh run
(``--check`` exits 0); ``diff`` finds each kind of altered contract; and
``--check`` exits 1 on a violation and 2 on a contract of the other
device or one it cannot read.
"""

import copy
import json
import os

import pytest

from thrill_tpu.tools import perf_sentinel as jps

from thrill_tpu_torch.tools import perf_sentinel as ps

#: {(workload, counter): (the recorded fault, the port's exact value)}.
#: None: every counter of every workload is the reference's.
EXPECTED = {}


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for var in ps.ENV_NOTE:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def reference():
    saved = {k: os.environ.pop(k) for k in jps.ENV_NOTE if k in os.environ}
    try:
        return jps.snapshot()
    finally:
        os.environ.update(saved)


def test_the_port_runs_the_reference_s_workloads():
    assert list(ps.WORKLOADS) == list(jps.WORKLOADS)
    assert ps.COUNTERS == jps.COUNTERS
    assert ps.BYTE_FIELDS == jps.BYTE_FIELDS
    assert ps.ENV_PINS == jps.ENV_PINS
    assert ps._SCRUB == jps._SCRUB


@pytest.mark.parametrize("name", list(jps.WORKLOADS))
def test_a_workload_s_counters_are_the_reference_s(name, reference):
    got = ps.snapshot([name], device="cpu")["workloads"][name]
    want = reference["workloads"][name]
    for k in ps.COUNTERS:
        fault = EXPECTED.get((name, k))
        if fault is not None:
            assert got[k] == fault[1], (name, k, fault[0])
        else:
            assert got[k] == want[k], (name, k, got[k], want[k])
    band = ps._band()
    for k in ps.BYTE_FIELDS:
        w, g = want[k], got[k]
        assert w * (1 - band) <= g <= w * (1 + band), (name, k, g, w)


def test_the_cpu_contract_holds(capsys):
    assert ps.main(["--check", "--device", "cpu"]) == 0
    assert "clean: 11 workloads match" in capsys.readouterr().out
    with open(ps.default_path("cpu")) as f:
        contract = json.load(f)
    assert contract["device"] == "cpu" and contract["workers"] == 2
    assert set(contract["workloads"]) == set(ps.WORKLOADS)


def test_diff_finds_each_altered_contract(monkeypatch):
    with open(ps.default_path("cpu")) as f:
        contract = json.load(f)
    assert ps.diff(contract, contract) == []

    c = copy.deepcopy(contract)
    c["workloads"]["sort"]["device_dispatches"] += 1
    (p,) = ps.diff(c, contract)
    assert p.startswith("sort.device_dispatches") and "exact" in p

    w = contract["workloads"]["join"]["bytes_on_wire"]
    assert w > 0
    c = copy.deepcopy(contract)
    c["workloads"]["join"]["bytes_on_wire"] = int(w * 1.2)
    assert ps.diff(c, contract) == []           # inside the 25 % band
    c["workloads"]["join"]["bytes_on_wire"] = w * 2
    (p,) = ps.diff(c, contract)
    assert p.startswith("join.bytes_on_wire") and "band" in p
    monkeypatch.setenv("THRILL_TPU_SENTINEL_BAND", "1.5")
    assert ps.diff(c, contract) == []
    monkeypatch.delenv("THRILL_TPU_SENTINEL_BAND")

    c = copy.deepcopy(contract)
    del c["workloads"]["chain"]
    (p,) = ps.diff(c, contract)
    assert p.startswith("chain: not in the contract")
    (p,) = ps.diff(contract, c)
    assert p.startswith("chain: workload missing")

    c = dict(contract, version=2)
    (p,) = ps.diff(c, contract)
    assert "version" in p
    c = dict(contract, device="cuda")
    (p,) = ps.diff(c, contract)
    assert "device" in p


def test_check_exit_codes(tmp_path, capsys):
    with open(ps.default_path("cpu")) as f:
        contract = json.load(f)
    one = dict(contract, workloads={"chain": contract["workloads"]["chain"]})
    path = tmp_path / "contract.json"
    path.write_text(json.dumps(one))
    assert ps.main(["--check", str(path), "--device", "cpu"]) == 0

    bad = copy.deepcopy(one)
    bad["workloads"]["chain"]["fused_dispatches"] += 1
    path.write_text(json.dumps(bad))
    assert ps.main(["--check", str(path), "--device", "cpu"]) == 1
    assert "REGRESSION chain.fused_dispatches" in capsys.readouterr().err

    path.write_text(json.dumps(dict(one, device="cuda")))
    assert ps.main(["--check", str(path), "--device", "cpu"]) == 2
    assert "not 'cpu'" in capsys.readouterr().err

    assert ps.main(["--check", str(tmp_path / "none.json"),
                    "--device", "cpu"]) == 2
    assert ps.main(["--check", "--device", "tpu"]) == 2
    assert ps.main([]) == 2


def test_snapshot_writes_a_contract_of_its_device(tmp_path, monkeypatch):
    monkeypatch.setattr(ps, "WORKLOADS", {"chain": ps.WORKLOADS["chain"]})
    monkeypatch.setenv("THRILL_TPU_FAULTS", "api.mesh.dispatch:p=1.0")
    path = tmp_path / "c.json"
    assert ps.main(["--snapshot", str(path), "--device=cpu"]) == 0
    snap = json.loads(path.read_text())
    assert snap["device"] == "cpu" and list(snap["workloads"]) == ["chain"]
    # the armed fault was scrubbed for the run and is back after it
    assert snap["workloads"]["chain"] == json.loads(open(
        ps.default_path("cpu")).read())["workloads"]["chain"]
    assert os.environ["THRILL_TPU_FAULTS"] == "api.mesh.dispatch:p=1.0"
