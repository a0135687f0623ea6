"""CW (Morse) decoder: Goertzel-OOK tone detection + adaptive-WPM timing decode.

Capability parity with MorseDigitalModem (plugins/MorseDigitalModem/morse.cpp):
  * tone detection on the demod-rate stream via Goertzel OOK with compare bins
    (:790-830) — here the matmul Goertzel over fixed frames (ops.goertzel);
  * mark/space timing -> dot/dash classification with adaptive WPM tracking
    via dot/dash moving averages (morse.h:86-178);
  * MorseCode table lookup -> text (modem.morse_code).

Split device/host: frame powers + OOK decisions are the jit'd device part
(MorseModem.detect); run-length timing and table lookup are a tiny host state
machine (MorseDecoder.feed) — the analog of the reference's consumer-thread
character assembly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.modem.morse_code import MORSE_TO_CHAR
from pebblesdr_tpu.ops import goertzel


class MorseModem:
    """Device side: complex demod-rate input [C, N] -> mark booleans [C, F].

    frame (the Goertzel integration length N) defaults to the reference's
    estimation rules (goertzel.h:103-104): no longer than 1/4 of the dot at
    the hinted WPM (timing), and — when bandwidth_hz is given — no shorter
    than the bin width that bandwidth asks for (selectivity).

    threshold_mode selects the OOK decision scheme (ops.goertzel.OOKConfig);
    'peak' (the reference's default, its best-tested mode) rides fades via
    adaptive peak/floor envelopes; 'compare' rejects nearby interference via
    the off-tone bins (the pileup scenario); 'noise' is squelch-style.
    """

    def __init__(self, sample_rate: float, tone_hz: float = 1000.0,
                 frame: int | None = None, wpm_hint: float = 20.0,
                 bandwidth_hz: float | None = None,
                 threshold_mode: str = "peak", detector: str = "goertzel",
                 **ook_kwargs):
        if frame is None:
            dot_ms = 1.2 / wpm_hint * 1e3
            frame = max(8, goertzel.choose_n(
                sample_rate, ms_shortest_bit=dot_ms / 4,
                bandwidth_hz=bandwidth_hz))
        self.frame = int(frame)
        self.frame_rate = sample_rate / self.frame
        self.sample_rate = sample_rate
        self.tone_hz = tone_hz
        if detector not in ("goertzel", "matched"):
            raise ValueError(detector)
        self.detector = detector
        lo, hi = goertzel.compare_bin_freqs(tone_hz, self.frame, sample_rate,
                                            delta_frac=1.0)
        self.basis = jnp.asarray(
            goertzel.dft_vectors([tone_hz, lo, hi], sample_rate, self.frame))
        if detector == "matched":
            # the reference's SECOND detector (morse.cpp:775-806 non-Goertzel
            # path): mix the tone to baseband, matched-bandwidth LP FIR, one
            # envelope result per bit window.  Cutoff = half the frame rate
            # (the detection bandwidth the integration window implies); tap
            # span ~2 frames like fldigi's cw_FIR_filter sinc
            from pebblesdr_tpu.ops import fir as fir_mod

            self.mf_taps = fir_mod.design_lowpass_kaiser(
                self.frame_rate / 2.0, sample_rate, atten_db=40.0,
                transition_hz=self.frame_rate / 2.0,
                max_taps=2 * self.frame + 1).astype(np.float32)
        self.ook_cfg = goertzel.OOKConfig.make(mode=threshold_mode,
                                               **ook_kwargs)
        self._detect = jax.jit(self._detect_impl)

    def init_state(self, channels: int):
        ook = goertzel.ook_init(channels)
        if self.detector == "matched":
            t = len(self.mf_taps)
            return (ook,
                    jnp.zeros((channels,), jnp.float32),          # NCO phase
                    jnp.zeros((2 * channels, t - 1), jnp.float32))  # FIR tail
        return ook

    def detect(self, state: goertzel.OOKState, x: jax.Array):
        """x: [C, N] complex64 (N divisible by frame) -> (state', marks [C, F])."""
        return self._detect(state, x)

    def _detect_impl(self, state, x):
        if self.detector == "matched":
            from pebblesdr_tpu.ops import fir as fir_mod

            ook, phase0, tail = state
            c, n = x.shape
            # NCO mix to baseband (carried phase keeps block continuity)
            f0 = np.float32(self.tone_hz / self.sample_rate)
            ramp = jnp.mod(phase0[:, None]
                           + jnp.arange(n, dtype=jnp.float32)[None, :] * f0,
                           1.0)
            osc = jnp.exp(-2j * np.pi * ramp.astype(jnp.complex64))
            y = x * osc
            phase1 = jnp.mod(phase0 + np.float32(n) * f0, 1.0)
            # matched-bandwidth LP, one complex result per frame (the
            # cw_FIR_filter decimating MAC), on stacked re/im rails
            rails = jnp.concatenate([y.real, y.imag], axis=0)
            taps_j = jnp.asarray(self.mf_taps)
            out, tail2 = fir_mod.fir_apply_real_signal(
                rails, taps_j, tail, decim=self.frame,
                taps_np=self.mf_taps)
            p = out[:c] ** 2 + out[c:] ** 2                  # [C, F]
            z = jnp.zeros_like(p)
            ook2, marks = goertzel.ook_detect(self.ook_cfg, ook, p, z, z)
            return (ook2, phase1, tail2), marks
        frames = goertzel.frame_stream(x, self.frame)
        p = goertzel.goertzel_power(frames, self.basis)
        return goertzel.ook_detect(self.ook_cfg, state,
                                   p[:, :, 0], p[:, :, 1], p[:, :, 2])


@dataclasses.dataclass
class MorseDecoder:
    """Host side: mark/space run-length -> characters, adaptive WPM.

    frames_per_unit tracks the dot length in frames (EWMA over classified
    dots/dashes — the reference's dot/dash threshold moving averages,
    morse.h:86-178)."""

    frame_rate: float
    wpm: float = 20.0
    _symbol: str = ""
    _text: str = ""
    _run_state: bool = False
    _run_len: int = 0

    def __post_init__(self):
        self.frames_per_unit = 1.2 / self.wpm * self.frame_rate

    @property
    def tracked_wpm(self) -> float:
        return 1.2 * self.frame_rate / self.frames_per_unit

    def feed(self, marks: np.ndarray) -> str:
        """marks: [F] bool frames.  Returns newly decoded text."""
        out = []
        for m in np.asarray(marks).astype(bool):
            if m == self._run_state:
                self._run_len += 1
                # very long space: flush pending word boundary
                if (not m) and self._run_len == int(7 * self.frames_per_unit):
                    out.append(self._finish_char(word_gap=True))
            else:
                out.append(self._end_run())
                self._run_state = bool(m)
                self._run_len = 1
        new = "".join(s for s in out if s)
        self._text += new
        return new

    def _end_run(self) -> str:
        u = self.frames_per_unit
        n = self._run_len
        if self._run_len == 0:
            return ""
        if self._run_state:  # mark ended: dot or dash
            if n < 2.0 * u:
                self._symbol += "."
                self.frames_per_unit += 0.1 * (n - self.frames_per_unit)
            else:
                self._symbol += "-"
                self.frames_per_unit += 0.1 * (n / 3.0 - self.frames_per_unit)
            return ""
        # space ended
        if n < 2.0 * u:
            return ""  # intra-character gap
        if n < 5.0 * u:
            return self._finish_char()
        return self._finish_char(word_gap=True)

    def _finish_char(self, word_gap: bool = False) -> str:
        ch = MORSE_TO_CHAR.get(self._symbol, "" if not self._symbol else "?")
        self._symbol = ""
        if word_gap and ch:
            return ch + " "
        if word_gap:
            return ""
        return ch

    def flush(self) -> str:
        s = self._end_run()
        s += self._finish_char()
        self._run_len = 0
        self._text += s
        return s

    @property
    def text(self) -> str:
        return self._text
