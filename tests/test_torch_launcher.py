"""The port's launcher (``deepspeed_tpu_torch/launcher/``) against the JAX
package's (``deepspeed_tpu/launcher/``).

Each case of ``tests/test_run.py`` (hostfile parsing, the include/exclude
DSL, its errors, the world-info codec, the global rank mapping) runs
through both packages' ``run.py`` on the same inputs and must give the
same result or raise the same exception type.  The restart loop's three
cases of ``tests/test_resilience.py`` (restarts until success, the budget
exhausted, a real crash not restarted) and the jittered delay run on the
port's ``launch.py`` with tiny scripts that import no torch; the child
sees ``LOCAL_RANK``, ``--local_rank`` and the ``DSTPU_*`` contract, one
process per local slot, and every relaunch inherits the re-exported
``--compile_cache_dir``, ``--trace_dir`` and ``--health_port``.
"""

import os
import subprocess
import sys

import pytest

from deepspeed_tpu.launcher import launch as jlaunch
from deepspeed_tpu.launcher import run as jrun
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.launcher import run as trun
from deepspeed_tpu_torch.resilience import (RESTARTABLE_EXIT_CODES,
                                            RESUME_EXIT_CODE,
                                            WATCHDOG_EXIT_CODE)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOSTFILES = {
    "good": "\n# comment\nworker-0 slots=2\nworker-1 slots=2\n\n"
            "worker-2 slots=4\n",
    "malformed": "worker-0 slots=two\n",
    "duplicate": "worker-0 slots=2\nworker-0 slots=2\n",
}

POOL = {"worker-0": 2, "worker-1": 2, "worker-2": 4}

FILTERS = [
    ("", ""), ("worker-1", ""), ("worker-2:0,2", ""),
    ("worker-0@worker-2:1,3", ""), ("", "worker-1"), ("", "worker-2:1,3"),
    ("", "worker-0@worker-1@worker-2"), ("worker-0", "worker-1"),
    ("worker-9", ""), ("worker-0:7", ""), ("worker-0@worker-0", ""),
]


def _outcome(fn, *args):
    """``("ok", result)`` or ``("raise", exception type)``."""
    try:
        return "ok", fn(*args)
    except Exception as e:      # the type is what must agree
        return "raise", type(e)


@pytest.mark.parametrize("name", [*HOSTFILES, "missing"])
def test_fetch_hostfile_matches_jax(tmp_path, name):
    path = tmp_path / "hostfile"
    if name != "missing":
        path.write_text(HOSTFILES[name])
    got = _outcome(trun.fetch_hostfile, str(path))
    want = _outcome(jrun.fetch_hostfile, str(path))
    assert got == want
    if name == "good":
        assert got[1] == POOL


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_resource_filters_match_jax(include, exclude):
    got = _outcome(trun.parse_inclusion_exclusion, POOL, include, exclude)
    want = _outcome(jrun.parse_inclusion_exclusion, POOL, include, exclude)
    assert got == want


@pytest.mark.parametrize("info", [
    {"worker-0": [0, 1], "worker-1": [0]},
    {"worker-0": [0, 1], "worker-1": [0], "worker-2": [0, 1, 2]},
    {"localhost": [0]},
])
def test_world_info_and_rank_mapping_match_jax(info):
    enc = trun.encode_world_info(info)
    assert enc == jrun.encode_world_info(info)
    assert trun.decode_world_info(enc) == jrun.decode_world_info(enc) == info
    assert launch.global_rank_mapping(info) == \
        jlaunch.global_rank_mapping(info)


CHILD = """
import json, os, sys
rank = os.environ["DSTPU_PROCESS_ID"]
out = {k: os.environ.get(k) for k in (
    "LOCAL_RANK", "RANK", "WORLD_SIZE", "DSTPU_COORDINATOR",
    "DSTPU_NUM_PROCESSES", "DSTPU_PROCESS_ID", "DSTPU_COMPILE_CACHE_DIR",
    "DSTPU_TRACE_DIR", "DSTPU_HEALTH_PORT", "DSTPU_REPLICA_GENERATION")}
out["argv"] = sys.argv[1:]
with open(os.path.join(os.environ["OUT_DIR"], f"child_{rank}.json"), "w") as f:
    json.dump(out, f)
print("CHILD_OK")
"""


def test_local_launch_contract_one_process_per_slot(tmp_path, monkeypatch):
    """Two slots of one node: two processes, each with its LOCAL_RANK,
    --local_rank, global rank and the DSTPU_* rendezvous contract."""
    import json
    script = tmp_path / "train.py"
    script.write_text(CHILD)
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    rc = launch.main([
        f"--world_info={trun.encode_world_info({'localhost': [0, 1]})}",
        "--master_port=29611", "--compile_cache_dir=/cc", "--trace_dir=/tr",
        "--health_port=9100", str(script), "--flag"])
    assert rc == 0
    for r in range(2):
        got = json.loads((tmp_path / f"child_{r}.json").read_text())
        assert got["LOCAL_RANK"] == got["RANK"] == got[
            "DSTPU_PROCESS_ID"] == str(r)
        assert got["WORLD_SIZE"] == got["DSTPU_NUM_PROCESSES"] == "2"
        assert got["DSTPU_COORDINATOR"] == "127.0.0.1:29611"
        assert got["argv"] == ["--flag", f"--local_rank={r}"]
        assert (got["DSTPU_COMPILE_CACHE_DIR"], got["DSTPU_TRACE_DIR"],
                got["DSTPU_HEALTH_PORT"], got["DSTPU_REPLICA_GENERATION"]
                ) == ("/cc", "/tr", "9100", "0")


def test_end_to_end_local_launch(tmp_path):
    """run.py -> launch.py -> the user script on the local fallback path
    (no hostfile), as ``python -m deepspeed_tpu_torch.launcher.run``."""
    script = tmp_path / "train.py"
    script.write_text(
        "import os, sys\n"
        "assert os.environ['DSTPU_NUM_PROCESSES'] == '1'\n"
        "assert os.environ['DSTPU_PROCESS_ID'] == '0'\n"
        "assert os.environ['LOCAL_RANK'] == '0'\n"
        "assert '--local_rank=0' in sys.argv\n"
        "print('CHILD_OK')\n")
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.run",
         "--hostfile", str(tmp_path / "missing"), str(script)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "CHILD_OK" in out.stdout


RESTART_SCRIPT = """\
import os, sys
marker = os.environ["RESTART_MARKER"]
n = int(open(marker).read()) if os.path.exists(marker) else 0
open(marker, "w").write(str(n + 1))
with open(marker + ".env", "a") as f:
    f.write(os.environ.get("DSTPU_COMPILE_CACHE_DIR", "MISSING") + " "
            + os.environ.get("DSTPU_REPLICA_GENERATION", "MISSING") + "\\n")
sys.exit(0 if n + 1 >= int(os.environ["RESTART_SUCCEED_AT"]) else {code})
"""


@pytest.mark.parametrize("code,succeed_at,budget,want_rc,want_runs", [
    (RESUME_EXIT_CODE, 3, 5, 0, 3),                   # restarts to success
    (WATCHDOG_EXIT_CODE, 100, 2, WATCHDOG_EXIT_CODE, 3),  # budget exhausted
    (1, 100, 5, 1, 1),                                # a crash: no relaunch
], ids=["until_success", "budget_exhausted", "real_crash"])
def test_restart_loop(tmp_path, monkeypatch, code, succeed_at, budget,
                      want_rc, want_runs):
    """``--max_restarts`` relaunches on the resilience exit codes only (the
    JAX ``tests/test_resilience.py`` launcher cases), and every attempt
    inherits the compile-cache directory with its generation."""
    assert (RESUME_EXIT_CODE in RESTARTABLE_EXIT_CODES
            and WATCHDOG_EXIT_CODE in RESTARTABLE_EXIT_CODES)
    script = tmp_path / "worker.py"
    script.write_text(RESTART_SCRIPT.format(code=code))
    marker = str(tmp_path / "count")
    monkeypatch.setenv("RESTART_MARKER", marker)
    monkeypatch.setenv("RESTART_SUCCEED_AT", str(succeed_at))
    rc = launch.main([
        f"--world_info={trun.encode_world_info({'localhost': [0]})}",
        f"--max_restarts={budget}", "--restart_backoff=0.01",
        f"--compile_cache_dir={tmp_path / 'cc'}", str(script)])
    assert rc == want_rc
    assert open(marker).read() == str(want_runs)
    assert open(marker + ".env").read().splitlines() == [
        f"{tmp_path / 'cc'} {g}" for g in range(want_runs)]


def test_restart_delay_jittered_exponential():
    lo = launch.restart_delay_s(1, base=1.0, rand=lambda: 0.0)
    hi = launch.restart_delay_s(1, base=1.0, rand=lambda: 1.0)
    assert lo == pytest.approx(0.5) and hi == pytest.approx(1.5)
    assert launch.restart_delay_s(3, base=1.0, rand=lambda: 0.5) \
        == pytest.approx(4.0)
    assert launch.restart_delay_s(30, base=1.0, cap=60.0, rand=lambda: 0.0) \
        == pytest.approx(30.0)             # capped before jitter
    for args in [(1, 1.0), (4, 0.5), (30, 2.0)]:
        assert launch.restart_delay_s(*args, rand=lambda: 0.25) == \
            jlaunch.restart_delay_s(*args, rand=lambda: 0.25)


def test_parse_args_match_jax():
    """The same command lines parse to the same fields in both CLIs."""
    argv = ["-H", "hf", "-i", "w0", "--num_nodes", "2", "--num_gpus", "4",
            "--master_port", "1234", "--launcher", "ssh",
            "--max_restarts", "3", "--restart_backoff", "0.5",
            "--compile_cache_dir", "/cc", "--trace_dir", "/tr",
            "--health_port", "9000", "train.py", "--lr", "1"]
    assert vars(trun.parse_args(argv)) == vars(jrun.parse_args(argv))
    largv = ["--world_info=e30=", "--node_rank", "1", "--max_restarts", "2",
             "--compile_cache_dir", "/cc", "train.py", "--x"]
    assert vars(launch.parse_args(largv)) == vars(jlaunch.parse_args(largv))
