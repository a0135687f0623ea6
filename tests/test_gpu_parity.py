"""Device-vs-CPU parity of the batched step_many on an NVIDIA card: the same
inputs through the card (child process) and through this process's CPU
chain, held to chip_smoke.py's limits.  Skips where there is no card; run it
on the card with `python -m pytest -m gpu tests/`."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CHILD = """
import sys
import numpy as np
import chip_smoke as cs
cs.CHANNELS = 16
for kind in ("am", "wfm"):
    runner, params = cs.build(kind)
    np.savez(f"{sys.argv[1]}/{kind}.npz",
             **cs.run_dispatch(kind, runner, params, cs.parity_input(kind)))
"""


@pytest.mark.gpu
def test_card_matches_cpu(gpu_card, tmp_path):
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cs.CHANNELS = 16
    try:
        for kind in ("am", "wfm"):
            runner, params = cs.build(kind)
            ref = cs.run_dispatch(kind, runner, params, cs.parity_input(kind))
            got = np.load(tmp_path / f"{kind}.npz")
            d_audio = (np.abs(got["audio"] - ref["audio"]).max()
                       / np.abs(ref["audio"]).max())
            d_sm = np.abs(got["signal_db"] - ref["signal_db"]).max()
            assert d_audio < cs.AUDIO_REL_MAX, (kind, d_audio)
            assert d_sm < cs.SMETER_DB_MAX, (kind, d_sm)
    finally:
        cs.CHANNELS = 64
