"""Audio output factory: demodulated audio -> file / pipe / null sinks.

Capability parity with Audio/AudioQT/AudioPA (pebblelib/audio.{h,cpp}
factory, audioqt.cpp, audiopa.cpp: StartOutput(dev, rate) +
SendToOutput(buf, n, gain, mute)): same surface, with sinks that make sense
on a headless accelerator host — WAV file, raw-PCM pipe to an external player
(aplay/ffplay when present), and null.  No sound-card stack is reimplemented
(SURVEY §2.5: vendored portaudio not reimplemented).
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np


class AudioOutput:
    """SendToOutput surface (audio.h:27 capability)."""

    def start(self, rate: int, channels: int = 1) -> None:
        raise NotImplementedError

    def send(self, audio: np.ndarray, gain: float = 1.0, mute: bool = False) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass


class NullOutput(AudioOutput):
    def __init__(self):
        self.samples_sent = 0

    def start(self, rate: int, channels: int = 1) -> None:
        self.rate = rate

    def send(self, audio, gain=1.0, mute=False) -> None:
        self.samples_sent += np.asarray(audio).shape[-1]


class WavOutput(AudioOutput):
    def __init__(self, path: str):
        self.path = path
        self._chunks: list[np.ndarray] = []

    def start(self, rate: int, channels: int = 1) -> None:
        self.rate = rate
        self.channels = channels

    def send(self, audio, gain=1.0, mute=False) -> None:
        a = np.asarray(audio, np.float32)
        if mute:
            a = np.zeros_like(a)
        self._chunks.append(a * gain)

    def stop(self) -> None:
        from pebblesdr_tpu.io import wav

        if self._chunks:
            wav.write_audio_wav(self.path, np.concatenate(self._chunks, axis=-1),
                                self.rate)


class PipeOutput(AudioOutput):
    """Pipe float32 PCM into an external player (aplay/ffplay/custom cmd)."""

    def __init__(self, command: list[str] | None = None):
        self.command = command
        self.proc: subprocess.Popen | None = None

    def start(self, rate: int, channels: int = 1) -> None:
        cmd = self.command
        if cmd is None:
            if shutil.which("aplay"):
                cmd = ["aplay", "-q", "-f", "FLOAT_LE", "-r", str(rate),
                       "-c", str(channels)]
            elif shutil.which("ffplay"):
                cmd = ["ffplay", "-nodisp", "-loglevel", "quiet", "-f", "f32le",
                       "-ar", str(rate), "-ch_layout",
                       "mono" if channels == 1 else "stereo", "-i", "pipe:0"]
            else:
                raise RuntimeError("no audio player found (aplay/ffplay)")
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def send(self, audio, gain=1.0, mute=False) -> None:
        a = np.asarray(audio, np.float32) * (0.0 if mute else gain)
        if a.ndim == 2:  # [channels, n] -> interleaved
            a = a.T.reshape(-1)
        self.proc.stdin.write(a.astype("<f4").tobytes())

    def stop(self) -> None:
        if self.proc:
            self.proc.stdin.close()
            self.proc.wait(timeout=5)


class PacedOutput(AudioOutput):
    """Real-time pacing wrapper: a consumer thread drains a bounded buffer
    into the inner sink at the audio clock rate — the reference's audio
    output consumer thread (audioqt.cpp:21-27) made explicit, with the
    accounting a soundcard driver would give you:

      latency_s  — audio currently buffered ahead of the clock;
      underruns  — consumer woke to an empty buffer (producer too slow);
      overruns   — producer exceeded max_latency_s; oldest audio dropped
                   (the ProducerConsumer drop-oldest semantics).

    Underruns emit silence to keep the output clock steady, exactly like a
    real device."""

    def __init__(self, inner: AudioOutput, max_latency_s: float = 0.5,
                 chunk_s: float = 0.05):
        import threading

        self.inner = inner
        self.max_latency_s = max_latency_s
        self.chunk_s = chunk_s
        self.underruns = 0
        self.overruns = 0
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    @property
    def latency_s(self) -> float:
        return self._buffered / self.rate

    def start(self, rate: int, channels: int = 1) -> None:
        import threading

        self.rate = rate
        self.channels = channels
        self.inner.start(rate, channels)
        self._stop.clear()
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def send(self, audio, gain=1.0, mute=False) -> None:
        a = np.asarray(audio, np.float32) * (0.0 if mute else gain)
        with self._lock:
            self._buf.append(a)
            self._buffered += a.shape[-1]
            max_samples = int(self.max_latency_s * self.rate)
            while self._buffered > max_samples and self._buf:
                old = self._buf.pop(0)
                self._buffered -= old.shape[-1]
                self.overruns += 1

    def _consume(self) -> None:
        import time

        chunk = max(1, int(self.chunk_s * self.rate))
        next_t = time.monotonic()
        while not self._stop.is_set():
            next_t += chunk / self.rate
            with self._lock:
                take = []
                need = chunk
                while need > 0 and self._buf:
                    a = self._buf[0]
                    if a.shape[-1] <= need:
                        take.append(self._buf.pop(0))
                        need -= a.shape[-1]
                    else:
                        take.append(a[..., :need])
                        self._buf[0] = a[..., need:]
                        need = 0
                self._buffered -= chunk - need
            if need > 0:
                self.underruns += 1
                shape = (need,) if self.channels == 1 else (self.channels,
                                                           need)
                take.append(np.zeros(shape, np.float32))
            if take:
                self.inner.send(np.concatenate(
                    [np.atleast_1d(t) for t in take], axis=-1))
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()  # fell behind: reset the clock

    def stop(self) -> None:
        # drain what's buffered, then stop the clock
        import time

        deadline = time.monotonic() + self.max_latency_s + 1.0
        while self._buffered > 0 and time.monotonic() < deadline:
            time.sleep(self.chunk_s / 2)
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.inner.stop()


class PortAudioOutput(AudioOutput):
    """Native soundcard sink via ctypes on the system PortAudio — the
    AudioPA backend (pebblelib/audiopa.cpp StartOutput/SendToOutput
    capability) without vendoring the library.

    Uses the blocking-write API: Pa_OpenDefaultStream(float32, `channels`)
    + Pa_WriteStream per send.  Pa_WriteStream returning
    paOutputUnderflowed increments `underruns` (the same accounting
    PacedOutput keeps for the pipe sinks).  Raises a clear RuntimeError at
    start() when no libportaudio is installed — headless hosts keep
    using wav/pipe/null."""

    _PA_FLOAT32 = 0x00000001
    _PA_OUTPUT_UNDERFLOWED = -9980  # paOutputUnderflowed

    def __init__(self, device: str = "default",
                 frames_per_buffer: int = 1024):
        self.device = device
        self.frames_per_buffer = frames_per_buffer
        self.underruns = 0
        self._pa = None
        self._stream = None

    @staticmethod
    def _load():
        import ctypes
        import ctypes.util

        name = ctypes.util.find_library("portaudio")
        if not name:
            raise RuntimeError(
                "no libportaudio on this host — use --audio-out FILE.wav or "
                "pipe: (aplay/ffplay) instead of device:")
        pa = ctypes.CDLL(name)
        # declare the ABI explicitly: PaSampleFormat and frame counts are
        # C unsigned long (64-bit on LP64) — ctypes' default 32-bit int
        # promotion happens to work for the current values but is brittle
        c = ctypes
        pa.Pa_Initialize.restype = c.c_int
        pa.Pa_Terminate.restype = c.c_int
        pa.Pa_OpenDefaultStream.restype = c.c_int
        pa.Pa_OpenDefaultStream.argtypes = [
            c.POINTER(c.c_void_p), c.c_int, c.c_int, c.c_ulong, c.c_double,
            c.c_ulong, c.c_void_p, c.c_void_p]
        for fn in (pa.Pa_StartStream, pa.Pa_StopStream, pa.Pa_CloseStream):
            fn.restype = c.c_int
            fn.argtypes = [c.c_void_p]
        pa.Pa_WriteStream.restype = c.c_int
        pa.Pa_WriteStream.argtypes = [c.c_void_p, c.c_void_p, c.c_ulong]
        return pa

    def start(self, rate: int, channels: int = 1) -> None:
        import ctypes

        pa = self._load()
        err = pa.Pa_Initialize()
        if err:
            raise RuntimeError(f"Pa_Initialize failed ({err})")
        self._pa = pa
        self.rate, self.channels = rate, channels
        stream = ctypes.c_void_p()
        err = pa.Pa_OpenDefaultStream(
            ctypes.byref(stream), 0, channels,
            ctypes.c_ulong(self._PA_FLOAT32), ctypes.c_double(rate),
            ctypes.c_ulong(self.frames_per_buffer), None, None)
        if err:
            pa.Pa_Terminate()
            self._pa = None
            raise RuntimeError(f"Pa_OpenDefaultStream failed ({err})")
        self._stream = stream
        pa.Pa_StartStream(stream)

    def send(self, audio, gain=1.0, mute=False) -> None:
        import ctypes

        a = np.asarray(audio, np.float32) * (0.0 if mute else gain)
        if a.ndim == 2:  # [channels, n] -> interleaved frames
            a = np.ascontiguousarray(a.T)
        frames = a.shape[0] if a.ndim == 2 else a.shape[-1]
        buf = np.ascontiguousarray(a, np.float32)
        err = self._pa.Pa_WriteStream(
            self._stream, buf.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_ulong(frames))
        if err == self._PA_OUTPUT_UNDERFLOWED:
            self.underruns += 1

    def stop(self) -> None:
        if self._stream is not None:
            self._pa.Pa_StopStream(self._stream)
            self._pa.Pa_CloseStream(self._stream)
            self._stream = None
        if self._pa is not None:
            self._pa.Pa_Terminate()
            self._pa = None


def factory(kind: str = "null", paced: bool = False, **kwargs) -> AudioOutput:
    """Audio::Factory analog: 'null' | 'wav' | 'pipe' | 'device' (+paced=True
    to wrap in the real-time pacing consumer).  'device' is the native
    PortAudio soundcard sink (audiopa.cpp capability)."""
    if kind == "null":
        out = NullOutput()
    elif kind == "wav":
        out = WavOutput(**kwargs)
    elif kind == "pipe":
        out = PipeOutput(**kwargs)
    elif kind == "device":
        out = PortAudioOutput(**kwargs)
    else:
        raise ValueError(kind)
    return PacedOutput(out) if paced else out
