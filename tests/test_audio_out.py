"""Paced audio output: real-time drain rate, bounded latency, underrun and
overrun accounting (the reference's audio consumer thread, audioqt.cpp:21-27,
with ProducerConsumer drop-oldest semantics)."""

import time

import numpy as np

from pebblesdr_tpu.io import audio_out


class TestPacedOutput:
    def test_drains_at_the_audio_clock(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, max_latency_s=1.0, chunk_s=0.02)
        out.start(48000)
        try:
            out.send(np.zeros(12000, np.float32))  # 0.25 s of audio
            t0 = time.monotonic()
            while out.latency_s > 0 and time.monotonic() - t0 < 2.0:
                time.sleep(0.01)
            drained = time.monotonic() - t0
            # 0.25 s of audio must take ~0.25 s to play, not drain instantly
            assert 0.1 < drained < 0.6, drained
            assert inner.samples_sent >= 12000
            assert out.overruns == 0
        finally:
            out.stop()

    def test_underruns_counted_and_clock_keeps_running(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, chunk_s=0.02)
        out.start(48000)
        try:
            time.sleep(0.15)  # starve the consumer
            assert out.underruns >= 3
            sent_before = inner.samples_sent
            assert sent_before > 0  # silence kept the output clock running
        finally:
            out.stop()

    def test_overrun_drops_oldest(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, max_latency_s=0.1, chunk_s=0.02)
        out.start(48000)
        try:
            for _ in range(10):  # 10 x 0.1 s >> the 0.1 s latency bound
                out.send(np.zeros(4800, np.float32))
            assert out.overruns > 0
            assert out.latency_s <= 0.15
        finally:
            out.stop()

    def test_factory_paced(self):
        out = audio_out.factory("null", paced=True)
        assert isinstance(out, audio_out.PacedOutput)
        out.start(48000)
        out.send(np.zeros(480, np.float32))
        out.stop()
        assert out.inner.samples_sent >= 480


class TestPortAudioOutput:
    def test_factory_builds_device_sink(self):
        out = audio_out.factory("device")
        assert isinstance(out, audio_out.PortAudioOutput)

    def test_device_sink(self):
        """With libportaudio installed: open/write/close the default stream.
        Without (headless hosts): a clear RuntimeError naming the
        alternatives — never a silent no-op."""
        import ctypes.util

        out = audio_out.PortAudioOutput()
        if ctypes.util.find_library("portaudio"):
            out.start(48000)
            out.send(np.zeros(4800, np.float32))
            out.stop()
        else:
            import pytest

            with pytest.raises(RuntimeError, match="libportaudio"):
                out.start(48000)


class TestCliLiveSink:
    def test_pipe_sink_streams_pcm(self, tmp_path, capsys):
        """--audio-out pipe:<cmd>: the CLI streams float32 PCM through the
        paced consumer into the command's stdin (player analog)."""
        import json

        from pebblesdr_tpu.serve.cli import main

        sink = tmp_path / "pcm.raw"
        rc = main(["--synthetic", "am", "--mode", "AM", "--tune", "250000",
                   "--seconds", "0.3", "--json",
                   "--audio-out", f"pipe:dd of={sink} status=none"])
        assert rc == 0 or rc is None
        metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "audio_sink" in metrics
        data = np.frombuffer(sink.read_bytes(), "<f4")
        # the paced sink emitted ~0.3 s of 48 kHz PCM (incl. pacing silence)
        assert len(data) > 4800
        assert np.abs(data).max() > 0.01
