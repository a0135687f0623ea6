"""RTTY demodulator: dual-tone FSK -> Baudot -> text.

Capability parity with RttyDigitalModem (plugins/RttyDigitalModem): 45.45 baud
170 Hz-shift FSK (amateur standard), mark/space tone discrimination, async
start/stop framing, LTRS/FIGS shifted Baudot decode (modem.baudot).

Device/host split mirrors the Morse modem: mark/space tone powers per frame are
one matmul Goertzel (jit); the UART-style bit framing + Baudot table is a
host state machine.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.modem import baudot
from pebblesdr_tpu.ops import goertzel


class RttyModem:
    """Device side: [C, N] complex demod-rate input -> mark/space decision per
    frame (frames are 1/8 of a bit period for timing resolution)."""

    def __init__(self, sample_rate: float, mark_hz: float = 2125.0,
                 shift_hz: float = 170.0, baud: float = 45.45):
        self.sample_rate = sample_rate
        self.baud = baud
        self.frames_per_bit = 8
        self.frame = max(4, int(round(sample_rate / baud / self.frames_per_bit)))
        self.frame_rate = sample_rate / self.frame
        self.mark_hz = mark_hz
        self.space_hz = mark_hz - shift_hz
        self.basis = jnp.asarray(goertzel.dft_vectors(
            [self.mark_hz, self.space_hz], sample_rate, self.frame))
        self._detect = jax.jit(self._detect_impl)

    def detect(self, x: jax.Array) -> jax.Array:
        """x: [C, N] (N divisible by frame) -> mark bools [C, F]."""
        return self._detect(x)

    def _detect_impl(self, x):
        frames = goertzel.frame_stream(x, self.frame)
        p = goertzel.goertzel_power(frames, self.basis)
        return p[:, :, 0] > p[:, :, 1]  # mark > space


@dataclasses.dataclass
class RttyDecoder:
    """Host side: mark/space frames -> async-framed Baudot -> text.

    Async framing: idle = mark; start bit = space; 5 data bits LSB-first;
    >=1.5 stop bits (mark)."""

    frames_per_bit: int = 8
    _figs: bool = False
    _text: str = ""
    _frames: list = dataclasses.field(default_factory=list)

    def feed(self, marks: np.ndarray) -> str:
        self._frames.extend(bool(m) for m in np.asarray(marks).ravel())
        out = []
        fpb = self.frames_per_bit
        need = fpb * 7  # start + 5 data + stop
        while True:
            # hunt for a mark->space transition (start bit edge)
            i = 0
            frames = self._frames
            n = len(frames)
            while i + 1 < n and not (frames[i] and not frames[i + 1]):
                i += 1
            if i + 1 + need > n:
                # keep the tail from the edge onward (or last sample)
                del self._frames[:max(i, 0)]
                break
            start = i + 1
            # sample each bit at its center
            bits = []
            ok = True
            for b in range(7):
                center = start + b * fpb + fpb // 2
                votes = frames[center - 1:center + 2]
                bits.append(sum(votes) >= 2)
            # validate: start bit space, stop bit mark
            if bits[0] or not bits[6]:
                del self._frames[:start]
                continue
            code = 0
            for b in range(5):
                code |= (1 if bits[1 + b] else 0) << b
            ch, self._figs = baudot.decode_symbol(code, self._figs)
            out.append(ch)
            del self._frames[:start + 6 * fpb + fpb // 2]
        new = "".join(out)
        self._text += new
        return new

    @property
    def text(self) -> str:
        return self._text


def encode_rtty(text: str, sample_rate: float, mark_hz: float = 2125.0,
                shift_hz: float = 170.0, baud: float = 45.45,
                amplitude: float = 1.0, idle_bits: int = 8) -> np.ndarray:
    """Test helper: text -> complex FSK baseband (continuous phase)."""
    bit_len = sample_rate / baud
    space_hz = mark_hz - shift_hz
    figs_state = False
    bit_seq = [True] * idle_bits
    for ch in text.upper():
        entry = baudot.CHAR_TO_CODE.get(ch)
        if entry is None:
            continue
        code, needs_figs = entry
        if needs_figs != figs_state:
            shift = baudot.FIGS_SHIFT if needs_figs else baudot.LTRS_SHIFT
            bit_seq += [False] + [bool((shift >> b) & 1) for b in range(5)] + [True, True]
            figs_state = needs_figs
        bit_seq += [False] + [bool((code >> b) & 1) for b in range(5)] + [True, True]
    bit_seq += [True] * idle_bits
    # continuous-phase FSK
    n_total = int(round(len(bit_seq) * bit_len))
    t_idx = np.arange(n_total)
    bit_of_sample = np.minimum((t_idx / bit_len).astype(np.int64), len(bit_seq) - 1)
    freqs = np.where(np.asarray(bit_seq)[bit_of_sample], mark_hz, space_hz)
    phase = 2 * np.pi * np.cumsum(freqs) / sample_rate
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)
