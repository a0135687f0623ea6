"""DTMF digit-sequence decoder: dual-bin Goertzel with twist/duration checks.

Capability parity with the GoertzelOOK DTMF machinery the reference ships
tables for (pebblelib/goertzel.h:194-230): each key is a low-group (697-941
Hz) plus a high-group (1209-1633 Hz) tone.  The decoder validates the ITU
Q.24-style constraints: minimum tone duration, inter-digit pause, twist
(low/high level difference) limit, and second-best rejection in each group.

Design: all 8 group frequencies for all frames evaluate as ONE matmul
over the framed audio (goertzel.dft_vectors) — there is no per-sample
recurrence anywhere.  The tiny per-frame digit state machine runs host-side
on the [F, 8] power matrix, like the other host decoders (morse, rtty).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.ops import goertzel
from pebblesdr_tpu.ops.goertzel import DTMF_FREQS

LOW_GROUP = (697.0, 770.0, 852.0, 941.0)
HIGH_GROUP = (1209.0, 1336.0, 1477.0, 1633.0)

# (low index, high index) -> key
_KEY_BY_IJ = {(LOW_GROUP.index(lo), HIGH_GROUP.index(hi)): key
              for key, (lo, hi) in DTMF_FREQS.items()}

FRAME_MS = 20.0  # 50 Hz bins: resolves the 73 Hz minimum group spacing


class DtmfModem:
    """[C, N] real or complex audio -> [C, F, 8] group-tone power/20 ms."""

    def __init__(self, sample_rate: float):
        self.sample_rate = sample_rate
        self.frame = int(round(sample_rate * FRAME_MS / 1000.0))
        self.basis = jnp.asarray(goertzel.dft_vectors(
            LOW_GROUP + HIGH_GROUP, sample_rate, self.frame))
        self._detect = jax.jit(self._detect_impl)

    def detect(self, x: jax.Array) -> jax.Array:
        return self._detect(x)

    def _detect_impl(self, x):
        if not jnp.iscomplexobj(x):
            x = x.astype(jnp.complex64)
        frames = goertzel.frame_stream(x, self.frame)
        return goertzel.goertzel_power(frames, self.basis)


@dataclasses.dataclass
class DtmfDecoder:
    """[F, 8] powers -> validated digit string in `digits`.

    min_frames:   tone must persist this many frames (2 x 20 ms = the ITU
                  40 ms minimum) on the SAME key to register;
    gap_frames:   invalid/silent frames required before the next digit (the
                  inter-digit pause — also what separates "11" from "1");
    max_twist_db: |low - high| level limit (forward twist spec is 8 dB);
    dominance:    best group bin must exceed runner-up by this power ratio;
    min_power:    absolute floor (full-scale dual tone ~= 0.25 per bin).
    """

    min_frames: int = 2
    gap_frames: int = 1
    max_twist_db: float = 8.0
    dominance: float = 4.0
    min_power: float = 1e-4
    digits: str = ""
    _cur: str | None = None
    _run: int = 0
    _gap: int = 0
    _armed: bool = True

    def feed(self, powers: np.ndarray) -> None:
        """powers: [F, 8] (low group cols 0-3, high group cols 4-7)."""
        p = np.asarray(powers, np.float64)
        for row in p:
            self._frame(row)

    def _classify(self, row) -> str | None:
        lo, hi = row[:4], row[4:]
        i, j = int(np.argmax(lo)), int(np.argmax(hi))
        pl, ph = lo[i], hi[j]
        if pl < self.min_power or ph < self.min_power:
            return None
        # second-best rejection within each group
        lo2 = np.partition(lo, -2)[-2]
        hi2 = np.partition(hi, -2)[-2]
        if pl < self.dominance * max(lo2, 1e-18):
            return None
        if ph < self.dominance * max(hi2, 1e-18):
            return None
        # twist: level difference between the groups (power dB)
        twist_db = abs(10.0 * np.log10(max(pl, 1e-18) / max(ph, 1e-18)))
        if twist_db > self.max_twist_db:
            return None
        return _KEY_BY_IJ[(i, j)]

    def _frame(self, row) -> None:
        key = self._classify(row)
        if key is None:
            self._gap += 1
            if self._gap >= self.gap_frames:
                self._armed = True
                self._cur, self._run = None, 0
            return
        self._gap = 0
        if key == self._cur:
            self._run += 1
        else:
            self._cur, self._run = key, 1
        if self._armed and self._run >= self.min_frames:
            self.digits += key
            self._armed = False


def encode_dtmf(digits: str, sample_rate: float, tone_ms: float = 60.0,
                gap_ms: float = 60.0, amplitude: float = 0.5,
                twist_db: float = 0.0) -> np.ndarray:
    """Fixture: the dial string as dual tones with silence gaps.

    twist_db > 0 boosts the low group over the high group (to exercise the
    decoder's twist limit)."""
    n_tone = int(tone_ms * 1e-3 * sample_rate)
    n_gap = int(gap_ms * 1e-3 * sample_rate)
    t = np.arange(n_tone) / sample_rate
    g_lo = 10.0 ** (twist_db / 20.0)
    segs = []
    for d in digits:
        lo, hi = DTMF_FREQS[d.upper()]
        tone = (amplitude * g_lo * np.sin(2 * np.pi * lo * t)
                + amplitude * np.sin(2 * np.pi * hi * t))
        segs.append(tone.astype(np.float32))
        segs.append(np.zeros(n_gap, np.float32))
    return np.concatenate(segs) if segs else np.zeros(0, np.float32)
