"""On the card: one short run of a cell comes out correct, and its
control comes out not correct.  Skips where no CUDA device is present.

    python -m pytest -q bench/tests -m card
"""

import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.card
def test_a_short_spot_run_is_correct():
    _card()
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "n337.spot",
                          "--seed", "2147484001", "--seconds", "3", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = _last_json(res.stdout)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"request_p95_s", "peak_device_gb", "setup_s"} <= set(line["metrics"])


@pytest.mark.card
def test_the_tf32_control_of_the_spot_cell_is_not_correct():
    _card()
    res = subprocess.run([sys.executable, str(BENCH / "control.py"), "--workload",
                          "n337.spot", "--seeds", "2147484002"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert not _last_json(res.stdout)["correct"]
