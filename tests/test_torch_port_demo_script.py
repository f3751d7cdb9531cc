"""The port's convergence demo script, run for 3 steps on the CPU.

examples/convergence_demo_torch.py in a process of its own with `--device
cpu --steps 3` into a temporary directory: it exits 0 and writes
result.json with the JAX demo's keys (examples/convergence_demo.py), the
routes (every part on the kernels' route at the demo's cross_dim_head
32), its metrics and its final checkpoint. tests/test_torch_port_demo.py holds its configuration to the
JAX package; chip_smoke.py runs it for 240 steps on the card.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

DEMO = Path(__file__).resolve().parents[1] / "examples" / "convergence_demo_torch.py"
JAX_KEYS = {"nats", "auc", "changed_mean", "unchanged_mean", "loss_first8", "loss_last8"}


def test_demo_script_runs_three_steps_on_the_cpu(tmp_path):
    out = tmp_path / "demo"
    proc = subprocess.run([sys.executable, str(DEMO), "--device", "cpu", "--steps", "3",
                           "--out", str(out)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads((out / "result.json").read_text())
    assert JAX_KEYS <= set(result)
    assert all(np.isfinite(result[k]) for k in JAX_KEYS)
    assert 0.0 <= result["auc"] <= 1.0 and result["steps"] == 3
    assert result["routes"] == {"stack": "kernels", "augmenter": "kernels", "encoder": "kernels"}
    assert result["device"] == "cpu" and (out / "demo_final.pt").exists()
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 3
