"""OpenHPSDR / Metis network protocol (protocol 1): client source + server.

Capability parity with plugins/HPSDRDevice in its METIS (ethernet) personality
— the OZY USB path is out of scope on an accelerator host (SURVEY.md §2.3/§2.5):

  * UDP discovery: broadcast <0xEFFE><0x02><60 zero bytes> to port 1024; the
    radio answers <0xEFFE><0x02|0x03><MAC[6]><fwVersion><boardId><49 zeros>
    (hpsdrnetwork.h:8-13,53-61, hpsdrnetwork.cpp:75-90,207-224);
  * start/stop: <0xEFFE><0x04><command><60 zeros>, command bit0 = IQ stream,
    bit1 = wide bandscope (hpsdrnetwork.h:14-31, hpsdrnetwork.cpp:92-122);
  * data both ways: <0xEFFE><0x01><endpoint><u32 sequence, big-endian><2 x
    512-byte HPSDR USB frames>; endpoint 0x02 PC->radio, 0x06 radio->PC IQ,
    0x04 bandscope (hpsdrnetwork.h:41-51,70-86);
  * each 512-byte frame: 3 sync bytes 0x7F + 5 command-and-control bytes
    C0..C4 + 504 data bytes = 63 x (24-bit I, 24-bit Q, 16-bit mic), all
    big-endian signed, scaled by 1/8388607 (hpsdrdevice.cpp:57-61,466-559);
  * C&C commands (C0 bit0 is MOX; C0>>1 selects the command): type 0 =
    config with C1 speed bits 00/01/10/11 -> 48/96/192/384 ksps and C4
    duplex/receiver-count (hpsdrdevice.h:78-81,130-134, SendConfig
    hpsdrdevice.cpp), type C0=0x04 = RX1 NCO frequency as a big-endian u32 in
    C1..C4 (hpsdrdevice.h:67, hpsdrdevice.cpp:398-421).

The server half serves any Source as a Metis radio (the SdrGarage idea
applied to the HPSDR protocol) and doubles as the hardware-free test fixture.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from pebblesdr_tpu.io.sources import Source, SourceInfo

METIS_PORT = 1024
FRAME_BYTES = 512
SYNC = 0x7F
SAMPLES_PER_FRAME = 63          # (512 - 3 sync - 5 C&C) / 8 bytes per sample
SAMPLES_PER_DATAGRAM = 2 * SAMPLES_PER_FRAME
EP_PC_TO_RADIO = 0x02
EP_IQ = 0x06
EP_BANDSCOPE = 0x04

C0_CONFIG = 0x00
C0_RX1_FREQ = 0x04              # hpsdrdevice.h:67
SPEEDS = (48_000, 96_000, 192_000, 384_000)   # C1 bits 1:0 (hpsdrdevice.h:78-81)
C4_DUPLEX_ON = 0x04
C4_1RECEIVER = 0x00

_SCALE24 = 8388607.0


def encode_frame(iq: np.ndarray, ctrl: bytes = b"\x00" * 5,
                 mic: np.ndarray | None = None) -> bytes:
    """Pack 63 complex samples (+optional mic) into one 512-byte HPSDR frame
    (inverse of hpsdrdevice.cpp:466-553: sync, C&C, then per sample 24-bit
    big-endian I, 24-bit Q, 16-bit mic)."""
    if len(iq) != SAMPLES_PER_FRAME or len(ctrl) != 5:
        raise ValueError("frame takes exactly 63 samples and 5 C&C bytes")
    data = np.zeros((SAMPLES_PER_FRAME, 8), np.uint8)
    for col, vals in ((0, iq.real), (3, iq.imag)):
        v = np.clip(np.round(np.asarray(vals) * _SCALE24),
                    -8388608, 8388607).astype(np.int32)
        data[:, col] = (v >> 16) & 0xFF
        data[:, col + 1] = (v >> 8) & 0xFF
        data[:, col + 2] = v & 0xFF
    if mic is not None:
        m = np.clip(np.round(np.asarray(mic) * 32767.0),
                    -32768, 32767).astype(np.int16)
        data[:, 6] = (m.view(np.uint16) >> 8) & 0xFF
        data[:, 7] = m.view(np.uint16) & 0xFF
    return bytes([SYNC, SYNC, SYNC]) + ctrl + data.tobytes()


def decode_frame(frame: bytes) -> tuple[bytes, np.ndarray, np.ndarray]:
    """One 512-byte frame -> (C&C bytes, 63 complex64 IQ, 63 float32 mic).

    The sign handling mirrors the reference's (signed char)<<16 + unsigned
    low bytes (hpsdrdevice.cpp:514-533)."""
    if len(frame) != FRAME_BYTES:
        raise ValueError(f"HPSDR frame must be 512 bytes, got {len(frame)}")
    if frame[0] != SYNC or frame[1] != SYNC or frame[2] != SYNC:
        raise ValueError("invalid sync in data frame")
    ctrl = frame[3:8]
    data = np.frombuffer(frame, np.uint8, offset=8).reshape(
        SAMPLES_PER_FRAME, 8)
    def s24(hi, mid, lo):
        v = ((data[:, hi].astype(np.int8).astype(np.int32) << 16)
             | (data[:, mid].astype(np.int32) << 8)
             | data[:, lo].astype(np.int32))
        return v.astype(np.float32) / _SCALE24
    iq = (s24(0, 1, 2) + 1j * s24(3, 4, 5)).astype(np.complex64)
    mic = ((data[:, 6].astype(np.int8).astype(np.int32) << 8)
           | data[:, 7].astype(np.int32)).astype(np.float32) / 32767.0
    return ctrl, iq, mic


BANDSCOPE_SAMPLES_PER_FRAME = FRAME_BYTES // 2   # raw 16-bit ADC samples
BANDSCOPE_SAMPLES_PER_DATAGRAM = 2 * BANDSCOPE_SAMPLES_PER_FRAME


def encode_bandscope_frame(samples: np.ndarray) -> bytes:
    """256 raw wideband ADC samples (float in [-1, 1]) -> one 512-byte EP4
    frame of 16-bit big-endian values (protocol-1 bandscope payload: no
    sync/C&C, the whole frame is samples)."""
    if len(samples) != BANDSCOPE_SAMPLES_PER_FRAME:
        raise ValueError("bandscope frame takes exactly 256 samples")
    v = np.clip(np.round(np.asarray(samples) * 32767.0),
                -32768, 32767).astype(">i2")
    return v.tobytes()


def decode_bandscope_frame(frame: bytes) -> np.ndarray:
    """One 512-byte EP4 frame -> 256 float32 raw ADC samples."""
    if len(frame) != FRAME_BYTES:
        raise ValueError(f"bandscope frame must be 512 bytes, got {len(frame)}")
    return (np.frombuffer(frame, ">i2").astype(np.float32) / 32767.0)


def command_frame(c0: int, c1c4: bytes) -> bytes:
    """A PC->radio frame carrying only a C&C command (hpsdrnetwork.cpp:130-155
    zero-fills the data area)."""
    if len(c1c4) != 4:
        raise ValueError("C1..C4 must be 4 bytes")
    return (bytes([SYNC, SYNC, SYNC, c0]) + c1c4
            + b"\x00" * (FRAME_BYTES - 8))


def data_packet(endpoint: int, seq: int, frame1: bytes, frame2: bytes) -> bytes:
    """<0xEFFE><0x01><endpoint><u32 seq big-endian><frame1><frame2>
    (hpsdrnetwork.h:41-51; the spec mandates network byte order for seq)."""
    return (bytes([0xEF, 0xFE, 0x01, endpoint]) + struct.pack(">I", seq)
            + frame1 + frame2)


def freq_command(freq_hz: float) -> tuple[int, bytes]:
    """RX1 NCO frequency as C0=0x04 + big-endian u32 Hz
    (hpsdrdevice.cpp:398-405)."""
    return C0_RX1_FREQ, struct.pack(">I", int(round(freq_hz)))


def config_command(sample_rate: int) -> tuple[int, bytes]:
    """The SendConfig analog: C1 speed bits, C4 duplex-on single-receiver
    (hpsdrdevice.cpp SendConfig; hpsdrdevice.h:78-81,130-134)."""
    speed = min(range(len(SPEEDS)),
                key=lambda i: abs(SPEEDS[i] - sample_rate))
    return C0_CONFIG, bytes([speed, 0x00, 0x00, C4_DUPLEX_ON | C4_1RECEIVER])


class HpsdrServer:
    """Serve a Source as a Metis radio over UDP (discovery, start/stop, C&C,
    EP6 IQ streaming) — the hardware-free HPSDR fixture."""

    def __init__(self, source: Source, host: str = "127.0.0.1", port: int = 0,
                 mac: bytes = b"\x00\x1c\xc0\xa2\x13\x37", fw_version: int = 29,
                 board_id: int = 0x02, pace: bool = True):
        self.source = source
        self.mac, self.fw_version, self.board_id = mac, fw_version, board_id
        self.pace = pace            # real radios emit at the ADC rate
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._running = threading.Event()
        self._thread: threading.Thread | None = None
        self._data_thread: threading.Thread | None = None
        self._client_addr: tuple[str, int] | None = None
        self.commands: list[tuple[int, bytes]] = []

    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._running.clear()
        self._sock.close()
        for t in (self._thread, self._data_thread):
            if t:
                t.join(timeout=2)

    def _serve(self) -> None:
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                pkt, addr = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(pkt) < 4 or pkt[0] != 0xEF or pkt[1] != 0xFE:
                continue
            info = pkt[2]
            if info == 0x02:        # discovery request
                resp = (bytes([0xEF, 0xFE,
                               0x03 if self._running.is_set() else 0x02])
                        + self.mac + bytes([self.fw_version, self.board_id])
                        + b"\x00" * 49)
                self._sock.sendto(resp, addr)
            elif info == 0x04:      # start/stop (hpsdrnetwork.cpp:92-122)
                self._client_addr = addr
                # command bit0 = IQ stream, bit1 = wide bandscope
                # (0x01 IQ only, 0x02 bandscope only, 0x03 both)
                self._bandscope = bool(pkt[3] & 0x02)
                if pkt[3] & 0x03:
                    if not self._running.is_set():
                        self._running.set()
                        self._data_thread = threading.Thread(
                            target=self._stream_data, daemon=True)
                        self._data_thread.start()
                else:
                    self._running.clear()
            elif info == 0x01 and len(pkt) >= 8 + 2 * FRAME_BYTES:
                if pkt[3] != EP_PC_TO_RADIO:
                    continue
                for off in (8, 8 + FRAME_BYTES):
                    self._handle_command(pkt[off:off + FRAME_BYTES])

    def _handle_command(self, frame: bytes) -> None:
        if frame[0] != SYNC or frame[1] != SYNC or frame[2] != SYNC:
            return
        c0, c1c4 = frame[3], frame[4:8]
        self.commands.append((c0, c1c4))
        cmd = c0 >> 1               # C0 bit0 is MOX (hpsdrdevice.h:63-76)
        if cmd == C0_RX1_FREQ >> 1:
            self.source.set("center_freq_hz",
                            float(struct.unpack(">I", c1c4)[0]))
        elif cmd == C0_CONFIG >> 1:
            self.source.set("sample_rate", SPEEDS[c1c4[0] & 0x03])

    def _stream_data(self) -> None:
        import time
        seq = 0
        self._bs_seq = 0
        sent = 0
        t0 = time.monotonic()
        status = bytes([0x00, 0x00, 0x00, 0x00, self.fw_version])  # type-0 C&C
        while self._running.is_set() and not self._stop.is_set():
            if self.pace:
                # emit at the source sample rate, like the hardware ADC
                # (the FileSDRDevice producer pacing idea,
                # filesdrdevice.cpp:226-243, applied server-side)
                rate = float(self.source.get("sample_rate") or 48_000)
                ahead = sent / rate - (time.monotonic() - t0)
                if ahead > 0.002:
                    time.sleep(ahead)
            blk = self.source.read_block(SAMPLES_PER_DATAGRAM)
            if blk is None:
                return
            blk = np.asarray(blk)
            sent += SAMPLES_PER_DATAGRAM
            pkt = data_packet(EP_IQ, seq,
                              encode_frame(blk[:SAMPLES_PER_FRAME], status),
                              encode_frame(blk[SAMPLES_PER_FRAME:], status))
            try:
                self._sock.sendto(pkt, self._client_addr)
            except OSError:
                return
            seq += 1
            if getattr(self, "_bandscope", False):
                # EP4 wideband samples (real ADC view of the same stream;
                # the reference starts this with command bit1 and defines
                # IN_ENDPOINT4 but never consumes it — hpsdrnetwork.cpp:193
                # "not used yet"; we stream AND consume it)
                bs = np.zeros(BANDSCOPE_SAMPLES_PER_DATAGRAM, np.float32)
                take = min(len(blk), len(bs))
                bs[:take] = blk.real[:take]
                bpkt = data_packet(
                    EP_BANDSCOPE, self._bs_seq,
                    encode_bandscope_frame(bs[:BANDSCOPE_SAMPLES_PER_FRAME]),
                    encode_bandscope_frame(bs[BANDSCOPE_SAMPLES_PER_FRAME:]))
                try:
                    self._sock.sendto(bpkt, self._client_addr)
                except OSError:
                    return
                self._bs_seq += 1


class HpsdrSource(Source):
    """Client: drive a Metis radio (or HpsdrServer) and stream its EP6 IQ."""

    def __init__(self, host: str = "127.0.0.1", port: int = METIS_PORT,
                 sample_rate: int = 192_000, center_freq_hz: float = 7_040_000.0,
                 timeout: float = 5.0):
        self._radio = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a deep receive buffer rides out consumer stalls (jit compiles):
        # 8 MB = ~5 s of 192 ksps EP6 traffic
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  8 << 20)
        except OSError:
            pass
        self._sock.bind(("", 0))
        self._sock.settimeout(timeout)
        self._seq_out = 0
        self._last_seq: int | None = None
        self._pending = np.zeros(0, np.complex64)
        self._bs_buf: list[np.ndarray] = []
        self._bs_max_frames = 512   # ~128 k wideband samples retained
        self.dropped_datagrams = 0
        # unicast discovery to the known radio address (the broadcast form is
        # the module-level discover()); hpsdrnetwork.cpp:46-69 supports both
        self._sock.sendto(bytes([0xEF, 0xFE, 0x02]) + b"\x00" * 60,
                          self._radio)
        while True:
            pkt, addr = self._sock.recvfrom(2048)
            if (len(pkt) >= 11 and pkt[0] == 0xEF and pkt[1] == 0xFE
                    and pkt[2] in (0x02, 0x03)):
                break
        self.mac = pkt[3:9]
        self.fw_version, self.board_id = pkt[9], pkt[10]
        self._radio = addr           # radio replies from its live address
        self.info = SourceInfo(
            sample_rate=sample_rate, center_freq_hz=center_freq_hz,
            name=f"hpsdr://{host}:{port} (fw {self.fw_version} "
                 f"board {self.board_id})")
        self.set_sample_rate(sample_rate)
        self.set_center_freq(center_freq_hz)

    # ---------------------------------------------------------------- control

    def send_command(self, c0: int, c1c4: bytes,
                     cmd2: tuple[int, bytes] | None = None) -> None:
        """C&C ride EP2 data packets, one command per frame
        (hpsdrnetwork.cpp:125-164)."""
        f1 = command_frame(c0, c1c4)
        # a missing cmd2 leaves frame2 all-zero WITHOUT sync so the radio
        # skips it (hpsdrnetwork.cpp:131-132,146 set sync only when non-null)
        f2 = command_frame(*cmd2) if cmd2 else b"\x00" * FRAME_BYTES
        self._sock.sendto(data_packet(EP_PC_TO_RADIO, self._seq_out, f1, f2),
                          self._radio)
        self._seq_out += 1

    def set_center_freq(self, freq_hz: float) -> None:
        self.info.center_freq_hz = freq_hz
        self.send_command(*freq_command(freq_hz))

    def set_sample_rate(self, rate: int) -> None:
        c0, c1c4 = config_command(rate)
        self.info.sample_rate = SPEEDS[c1c4[0]]
        self.send_command(c0, c1c4)

    def start(self, bandscope: bool = False) -> None:
        """<0xEFFE><0x04><cmd>: cmd 0x01 = IQ stream, 0x03 = IQ + wide
        bandscope (hpsdrnetwork.cpp:92-106)."""
        cmd = 0x03 if bandscope else 0x01
        self._sock.sendto(bytes([0xEF, 0xFE, 0x04, cmd]) + b"\x00" * 60,
                          self._radio)

    def stop(self) -> None:
        self._sock.sendto(bytes([0xEF, 0xFE, 0x04, 0x00]) + b"\x00" * 60,
                          self._radio)

    # ------------------------------------------------------------------- data

    def read_block(self, n: int) -> np.ndarray:
        """Assemble n complex64 samples from EP6 datagrams; missed sequence
        numbers are zero-filled and counted.  EP4 bandscope datagrams seen on
        the way are collected into the bandscope buffer (read_bandscope)."""
        out = [self._pending]
        have = len(self._pending)
        while have < n:
            pkt = self._sock.recv(2048)
            if (len(pkt) < 8 + 2 * FRAME_BYTES or pkt[0] != 0xEF
                    or pkt[1] != 0xFE or pkt[2] != 0x01):
                continue
            if pkt[3] == EP_BANDSCOPE:
                for off in (8, 8 + FRAME_BYTES):
                    self._bs_buf.append(
                        decode_bandscope_frame(pkt[off:off + FRAME_BYTES]))
                if len(self._bs_buf) > self._bs_max_frames:
                    del self._bs_buf[:len(self._bs_buf) - self._bs_max_frames]
                continue
            if pkt[3] != EP_IQ:
                continue
            seq = struct.unpack(">I", pkt[4:8])[0]
            if self._last_seq is not None:
                gap = (seq - self._last_seq - 1) & 0xFFFFFFFF
                if 0 < gap < 1024:
                    self.dropped_datagrams += gap
                    out.append(np.zeros(gap * SAMPLES_PER_DATAGRAM,
                                        np.complex64))
                    have += gap * SAMPLES_PER_DATAGRAM
            self._last_seq = seq
            for off in (8, 8 + FRAME_BYTES):
                _, iq, _ = decode_frame(pkt[off:off + FRAME_BYTES])
                out.append(iq)
                have += len(iq)
        buf = np.concatenate(out)
        self._pending = buf[n:]
        return buf[:n]

    def read_bandscope(self) -> np.ndarray:
        """Drain the buffered EP4 wideband samples (raw real ADC view, [-1,
        1] float32).  Fills as a side effect of read_block; feed the result
        to bandscope_spectrum for the display path."""
        if not self._bs_buf:
            return np.zeros(0, np.float32)
        buf = np.concatenate(self._bs_buf)
        self._bs_buf.clear()
        return buf

    def close(self) -> None:
        try:
            self.stop()
        except OSError:
            pass
        self._sock.close()


def bandscope_spectrum(samples: np.ndarray, bins: int = 2048,
                       db_offset: float = 0.0) -> np.ndarray:
    """Raw EP4 samples -> dB power spectrum [bins] for the display path (the
    Receiver::processBandscopeData analog, receiver.cpp:1010-1025: the
    reference expects pre-computed dB bytes; we get raw ADC samples, so run
    the windowed transform here).  Real input: returns the positive-frequency
    half-spectrum spread over `bins` points, newest `2*bins` samples used."""
    from pebblesdr_tpu.ops import spectrum as spec_mod

    n = 2 * bins
    if len(samples) < n:
        samples = np.concatenate([np.zeros(n - len(samples), np.float32),
                                  samples])
    x = samples[-n:].astype(np.float64)
    w, cg = spec_mod.make_window(n)
    xs = np.fft.rfft(x * w)[:bins]
    p = np.abs(xs / (n * cg)) ** 2
    return (10.0 * np.log10(np.maximum(p, 1e-20)) + db_offset).astype(
        np.float32)


def discover(timeout: float = 2.0,
             target_host: str = "255.255.255.255",
             port: int = METIS_PORT) -> list[dict]:
    """Broadcast a Metis discovery request; returns [{ip, port, mac,
    fw_version, board_id}] (hpsdrnetwork.cpp:75-90)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.settimeout(timeout)
    sock.sendto(bytes([0xEF, 0xFE, 0x02]) + b"\x00" * 60, (target_host, port))
    found = []
    try:
        while True:
            pkt, addr = sock.recvfrom(2048)
            if (len(pkt) >= 11 and pkt[0] == 0xEF and pkt[1] == 0xFE
                    and pkt[2] in (0x02, 0x03)):
                found.append({"ip": addr[0], "port": addr[1],
                              "mac": pkt[3:9].hex(":"),
                              "fw_version": pkt[9], "board_id": pkt[10],
                              "sending": pkt[2] == 0x03})
    except socket.timeout:
        pass
    finally:
        sock.close()
    return found
