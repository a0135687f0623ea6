"""Chain-state checkpoint/resume: save/restore the carry-state pytree.

Capability parity with the reference's session persistence (SURVEY.md §5:
settings .ini + IQ recording = full session state).  Here the entire receiver
carry state (oscillator phases, filter tails, PLL/AGC averages, resampler
offsets) is one pytree, so mid-stream suspend/resume is exact: save after
block k, restore, continue with block k+1 — outputs are bit-identical
(tested in tests/test_chain.py::TestStateResume).

Storage: a single .npz (complex leaves split into re/im planes so files stay
portable).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np


def save_state(path: str, state, extra: dict | None = None) -> None:
    leaves, treedef = jax.tree.flatten(state)
    arrays = {}
    for i, leaf in enumerate(leaves):
        a = np.asarray(leaf)
        if np.iscomplexobj(a):
            arrays[f"leaf{i}_re"] = a.real
            arrays[f"leaf{i}_im"] = a.imag
        else:
            arrays[f"leaf{i}"] = a
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n_leaves": len(leaves), "extra": extra or {}}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, template):
    """Restore into the structure of `template` (e.g. rx.init_state())."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    leaves_t, treedef = jax.tree.flatten(template)
    if meta["n_leaves"] != len(leaves_t):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, template has "
            f"{len(leaves_t)} — chain config mismatch")
    leaves = []
    for i, tmpl in enumerate(leaves_t):
        if f"leaf{i}_re" in data:
            a = (data[f"leaf{i}_re"] + 1j * data[f"leaf{i}_im"]).astype(np.complex64)
        else:
            a = data[f"leaf{i}"]
        if tuple(a.shape) != tuple(np.shape(tmpl)):
            raise ValueError(f"leaf {i}: shape {a.shape} != {np.shape(tmpl)}")
        leaves.append(jnp.asarray(a))
    return jax.tree.unflatten(treedef, leaves), meta.get("extra", {})
