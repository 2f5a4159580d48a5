"""Concurrent builds of the port's native code
(``thrill_tpu_torch/common/native_build.py``).

Two processes that start together build the host libraries
(``native/*.cpp``) into one build directory, as the ranks of a
multi-process mesh on one machine do: each library is compiled once, by
one of them, the other waits on the library's file lock and loads it,
and no temporary file is left behind.
"""

import json
import os
import subprocess
import sys
import time


from thrill_tpu_torch.common import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("blockstore", "mwmerge", "records")


def _child(build_dir: str, go_file: str) -> None:
    native_build.BUILD_DIR = build_dir
    # start together: both wait for the parent's go file
    deadline = time.time() + 60
    while not os.path.exists(go_file) and time.time() < deadline:
        time.sleep(0.01)
    loaded = {n: native_build.load_host(n) is not None for n in NAMES}
    print("RESULT " + json.dumps({"loaded": loaded,
                                  "built": native_build.host_builds}),
          flush=True)


def test_two_processes_build_each_host_library_once(tmp_path):
    build = tmp_path / "build"
    go = tmp_path / "go"
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(build),
                               str(go)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    time.sleep(0.5)
    go.write_text("go")
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    for r in results:
        assert r["loaded"] == {n: True for n in NAMES}
    built = sorted(n for r in results for n in r["built"])
    assert built == sorted(NAMES)
    left = sorted(os.listdir(build))
    assert [f for f in left if ".tmp." in f] == []
    assert len([f for f in left if f.endswith(".so")]) == len(NAMES)


def test_a_built_library_is_loaded_not_built_again(monkeypatch, tmp_path):
    """A second loader finds the library on disk (another process's
    build) and compiles nothing."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_host_libs", {})
    monkeypatch.setattr(native_build, "host_builds", [])
    assert native_build.load_host("records") is not None
    assert native_build.host_builds == ["records"]
    native_build._host_libs.clear()
    assert native_build.load_host("records") is not None
    assert native_build.host_builds == ["records"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f for f in os.listdir(tmp_path) if f.endswith((".so", ".lock"))])


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
