"""ThreadSanitizer run of the port's multithreaded native code
(counterpart of the reference's ``tests/native/test_tsan.py``).

``thrill_tpu_torch/native/tsan_stress.cpp`` ``#include``s the port's
``dispatcher.cpp`` and ``blockstore.cpp``; this test compiles it with
``-fsanitize=thread`` and runs its battery: concurrent async writes and
reads and descriptor churn against the dispatcher's epoll thread, and
put/pin/get/drop churn against the block store's async spill writer.
``halt_on_error`` turns any race TSan finds into a non-zero exit.
Skipped where the toolchain has no libtsan.
"""

import os
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(__file__), "..", "thrill_tpu_torch",
                      "native")


def _tsan_available(tmpdir) -> bool:
    probe = os.path.join(tmpdir, "probe.cpp")
    with open(probe, "w") as f:
        f.write("int main(){return 0;}\n")
    try:
        r = subprocess.run(
            ["g++", "-fsanitize=thread", "-pthread", probe, "-o",
             os.path.join(tmpdir, "probe")],
            capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return r.returncode == 0


def test_the_port_s_dispatcher_and_block_store_run_clean_under_tsan(
        tmp_path):
    if not _tsan_available(str(tmp_path)):
        pytest.skip("ThreadSanitizer toolchain unavailable")
    binary = str(tmp_path / "tsan_stress")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", "-pthread",
         "-std=c++17", os.path.join(NATIVE, "tsan_stress.cpp"),
         "-o", binary],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    spill = tmp_path / "spill"
    spill.mkdir()
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    run = subprocess.run([binary, str(spill)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert run.returncode == 0, (
        f"TSan reported a race or the stress failed:\n{run.stderr[-4000:]}")
    assert "TSAN_STRESS_OK" in run.stdout
    assert "ThreadSanitizer" not in run.stderr
