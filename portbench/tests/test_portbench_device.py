"""The command reports nothing without the cards its cell needs, nor in a
directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

REPO = os.path.dirname(harness.ROOT)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "cartpole.opt",
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, **(env or {})))


def _printed_a_result(stdout):
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_refuses_without_a_card():
    proc = _run(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and not _printed_a_result(proc.stdout)
    assert "CUDA card" in proc.stderr


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0 and not _printed_a_result(proc.stdout)
