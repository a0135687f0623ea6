"""What a measurement ran on: the JAX device and the card's power limit.

Every timed result carries this stamp.  A card may be set below its
maximum power limit and then runs slower under load, so the limit is part
of the result, as nvidia-smi reports it.
"""

from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    (first card), or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def stamp() -> dict:
    """{platform, device_kind, count, card} of the process's devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power_limit()}
