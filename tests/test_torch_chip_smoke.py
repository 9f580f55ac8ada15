"""chip_smoke.py's contract where it can be checked without a card.

The script drives the port on an H100 and its last line states the device
the run used: one card. Here, with no CUDA device, it must fail and print
no result.
"""

import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_result_line_says_one_card():
    line = _load().result_line("NVIDIA H100 80GB HBM3")
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_fails_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _load().main() != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no CUDA device" in out.err


def test_fails_alone_in_a_directory(tmp_path):
    """Copied alone, without the package, it exits non-zero with no result
    (here it stops at the missing card first, as it does on the H100 host
    at the missing package)."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(SCRIPT).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
