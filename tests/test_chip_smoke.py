"""chip_smoke.py is the GPU bring-up check: without a GPU it must fail
fast, before any phase, and never print its passing line."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=30)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs 1 NVIDIA GPU" in proc.stderr + proc.stdout
