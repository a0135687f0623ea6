"""RFSpace SDR-IP / AFEDRI network protocol (ASCP): client source + server.

Capability parity with plugins/RFSpaceDevice (rfspacedevice.{h,cpp}) in its
network (SDR-IP) personality — the USB SDR-IQ path is out of scope on an
accelerator host (SURVEY.md §2.3/§2.5):
  * ASCP control over TCP: 2-byte header (13-bit length + 3-bit type,
    rfspacedevice.cpp:1334-1342), little-endian control-item codes — receiver
    state 0x0018 (run/stop, rfspacedevice.cpp:1143-1159), NCO frequency 0x0020
    (5-byte LE, :1279-1293), IQ output sample rate 0x00B8 (:1040-1046),
    RF gain 0x0038 / IF gain 0x0040 (:1065-1085), target name/serial/
    interface-version/status queries 0x0001-0x0006 (:545-605);
  * IQ data over UDP: 1028-byte datagrams [0x04][0x84][u16 seq][512 x int16
    LE] = 256 complex samples, IQ order swapped on the wire, sent to the TCP
    client's address at the device's TCP port (rfspacedevice.cpp:850-906);
  * UDP discovery: broadcast request to port 48321 with key 0x5A,0xA5,
    response carries name/serial/ip/port (rfspacedevice.cpp:936-1006).

The server half serves any Source over ASCP (the SdrGarage idea applied to
the RFSpace protocol) and doubles as the hardware-free test fixture.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from pebblesdr_tpu.io.sources import Source, SourceInfo

# control items (ASCP / rfspacedevice.cpp)
ITEM_TARGET_NAME = 0x0001
ITEM_SERIAL = 0x0002
ITEM_INTERFACE_VERSION = 0x0003
ITEM_STATUS = 0x0005
ITEM_RECEIVER_STATE = 0x0018
ITEM_FREQUENCY = 0x0020
ITEM_RF_GAIN = 0x0038
ITEM_IF_GAIN = 0x0040
ITEM_IQ_SAMPLE_RATE = 0x00B8
ITEM_UDP_ADDR = 0x00C5

TYPE_SET = 0        # host->target SetControlItem
TYPE_REQUEST = 1    # host->target RequestCurrentControlItem
TYPE_RESPONSE = 0   # target->host ResponseControlItem

STATE_IDLE = 0x01
STATE_RUN = 0x02

DATAGRAM_BYTES = 1028
SAMPLES_PER_DATAGRAM = 256
DISCOVER_REQUEST_PORT = 48321   # device listens (rfspacedevice.cpp:940)
DISCOVER_RESPONSE_PORT = 48322  # host listens (rfspacedevice.cpp:939)
DISCOVER_KEY = b"\x5a\xa5"


def pack_msg(msg_type: int, payload: bytes) -> bytes:
    """2-byte ASCP header: 13-bit total length, 3-bit type in the high bits
    of byte 1 (rfspacedevice.cpp:1334-1342)."""
    total = len(payload) + 2
    if not 2 <= total < 8192:
        raise ValueError(f"ASCP message length {total} out of range")
    return bytes([total & 0xFF, ((total >> 8) & 0x1F) | (msg_type << 5)]) + payload


def unpack_header(b0: int, b1: int) -> tuple[int, int]:
    """Returns (type, total_length); length==0 means an 8194-byte data block
    (the SDR-IQ USB special case, rfspacedevice.cpp:708-711)."""
    return b1 >> 5, b0 | (b1 & 0x1F) << 8


def pack_item(msg_type: int, item: int, params: bytes = b"") -> bytes:
    return pack_msg(msg_type, struct.pack("<H", item) + params)


def pack_frequency(item_params_hz: float, channel: int = 0) -> bytes:
    """Set NCO frequency: channel byte + 40-bit little-endian Hz
    (example 20 MHz = [0A][00][20][00][00][00][2D][31][01][00],
    rfspacedevice.cpp:261)."""
    f = int(round(item_params_hz))
    return pack_item(TYPE_SET, ITEM_FREQUENCY,
                     bytes([channel]) + f.to_bytes(5, "little"))


def decode_cpx16(raw: bytes, swap_iq: bool = True) -> np.ndarray:
    """512 int16 LE -> 256 complex64 in [-1, 1); the wire carries IQ order
    swapped relative to Pebble's convention (normalizeIQ(..., true),
    rfspacedevice.cpp:899-900)."""
    v = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    i, q = (v[1::2], v[0::2]) if swap_iq else (v[0::2], v[1::2])
    return (i + 1j * q).astype(np.complex64)


def encode_cpx16(x: np.ndarray, swap_iq: bool = True) -> bytes:
    v = np.empty(2 * len(x), "<i2")
    i = np.clip(np.round(x.real * 32768.0), -32768, 32767)
    q = np.clip(np.round(x.imag * 32768.0), -32768, 32767)
    if swap_iq:
        v[0::2], v[1::2] = q, i
    else:
        v[0::2], v[1::2] = i, q
    return v.tobytes()


class _AscpStream:
    """Shared TCP message framing over a blocking socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("ASCP peer closed connection")
            buf += chunk
        return buf

    def recv_msg(self) -> tuple[int, bytes]:
        hdr = self.recv_exact(2)
        msg_type, total = unpack_header(hdr[0], hdr[1])
        if total < 2 or total > 8191:
            raise ConnectionError(f"ASCP header error (length {total})")
        return msg_type, self.recv_exact(total - 2)

    def send(self, msg: bytes) -> None:
        self.sock.sendall(msg)


class SdrIpServer:
    """Serve a Source over the SDR-IP wire protocol (TCP control + UDP data).

    Data pacing follows the reference device model: on receiver-state RUN the
    producer streams 1028-byte datagrams to the client's address at this
    server's TCP port (rfspacedevice.cpp:652-656 binds that port client-side).
    """

    def __init__(self, source: Source, host: str = "127.0.0.1", port: int = 0,
                 name: str = "SDR-IP", serial: str = "PT0001"):
        self.source = source
        self.name, self.serial = name, serial
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self._sock.listen(1)
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._stop = threading.Event()
        self._running = threading.Event()
        self._thread: threading.Thread | None = None
        self._data_thread: threading.Thread | None = None
        self._client_addr: tuple[str, int] | None = None
        self.commands: list[tuple[int, bytes]] = []
        self._disc_sock: socket.socket | None = None
        self._disc_thread: threading.Thread | None = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._running.clear()
        self._sock.close()
        if self._disc_sock is not None:
            self._disc_sock.close()
        for t in (self._thread, self._data_thread, self._disc_thread):
            if t:
                t.join(timeout=2)

    def enable_discovery(self, bind_host: str = "127.0.0.1",
                         port: int = DISCOVER_REQUEST_PORT) -> None:
        """Answer ASCP discovery broadcasts (rfspacedevice.cpp:936-1006)."""
        self._disc_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._disc_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._disc_sock.bind((bind_host, port))
        self._disc_thread = threading.Thread(target=self._discovery_loop,
                                             daemon=True)
        self._disc_thread.start()

    def _discovery_loop(self) -> None:
        while not self._stop.is_set():
            try:
                pkt, addr = self._disc_sock.recvfrom(1024)
            except OSError:
                return
            if len(pkt) < 5 or pkt[2:4] != DISCOVER_KEY or pkt[4] != 0:
                continue
            resp = self._discover_response()
            self._disc_sock.sendto(resp, (addr[0], DISCOVER_RESPONSE_PORT))

    def _discover_response(self) -> bytes:
        # fixed 56-byte DISCOVER_MSG (rfspacedevice.h:49-71), op=1 response
        name = self.name.encode()[:15].ljust(16, b"\x00")
        sn = self.serial.encode()[:15].ljust(16, b"\x00")
        ip = socket.inet_aton(self.host)[::-1] + b"\x00" * 12
        body = DISCOVER_KEY + b"\x01" + name + sn + ip + struct.pack(
            "<H", self.port) + b"\x00"
        return struct.pack("<H", len(body) + 2) + body

    # --------------------------------------------------------------- serving

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._client_addr = (addr[0], self.port)
            stream = _AscpStream(conn)
            try:
                while not self._stop.is_set():
                    msg_type, payload = stream.recv_msg()
                    resp = self._handle(msg_type, payload)
                    if resp:
                        stream.send(resp)
            except (ConnectionError, OSError):
                pass
            finally:
                self._running.clear()
                conn.close()

    def _handle(self, msg_type: int, payload: bytes) -> bytes | None:
        if len(payload) < 2:
            return None
        item = struct.unpack("<H", payload[:2])[0]
        params = payload[2:]
        self.commands.append((item, params))
        if msg_type == TYPE_REQUEST:
            if item == ITEM_TARGET_NAME:
                return pack_item(TYPE_RESPONSE, item, self.name.encode() + b"\x00")
            if item == ITEM_SERIAL:
                return pack_item(TYPE_RESPONSE, item, self.serial.encode() + b"\x00")
            if item == ITEM_INTERFACE_VERSION:
                return pack_item(TYPE_RESPONSE, item, struct.pack("<H", 100))
            if item == ITEM_FREQUENCY:
                f = int(self.source.get("center_freq_hz") or 0)
                return pack_item(TYPE_RESPONSE, item,
                                 b"\x00" + f.to_bytes(5, "little"))
            if item == ITEM_STATUS:
                return pack_item(TYPE_RESPONSE, item, b"\x0b")
            return pack_item(TYPE_RESPONSE, item, b"\x00")
        # SetControlItem: device echoes the set as its ACK (ASCP semantics)
        if item == ITEM_FREQUENCY and len(params) >= 6:
            freq = int.from_bytes(params[1:6], "little")
            self.source.set("center_freq_hz", float(freq))
        elif item == ITEM_IQ_SAMPLE_RATE and len(params) >= 5:
            self.source.set("sample_rate", struct.unpack("<I", params[1:5])[0])
        elif item == ITEM_RECEIVER_STATE and len(params) >= 2:
            if params[1] == STATE_RUN and not self._running.is_set():
                self._running.set()
                self._data_thread = threading.Thread(target=self._stream_data,
                                                     daemon=True)
                self._data_thread.start()
            elif params[1] == STATE_IDLE:
                self._running.clear()
        return pack_item(TYPE_RESPONSE, item, params)

    def _stream_data(self) -> None:
        seq = 0
        while self._running.is_set() and not self._stop.is_set():
            blk = self.source.read_block(SAMPLES_PER_DATAGRAM)
            if blk is None:
                return
            pkt = (bytes([0x04, 0x84]) + struct.pack("<H", seq & 0xFFFF)
                   + encode_cpx16(np.asarray(blk)))
            try:
                self._udp.sendto(pkt, self._client_addr)
            except OSError:
                return
            seq += 1


class SdrIpSource(Source):
    """Client: drive an SDR-IP (or SdrIpServer) and stream its UDP IQ."""

    def __init__(self, host: str = "127.0.0.1", port: int = 50000,
                 sample_rate: int = 2_000_000, center_freq_hz: float = 10e6,
                 timeout: float = 5.0, native: bool | None = None):
        """native=True routes the UDP data plane through the C++ pump
        (runtime.NativeUdpPump: dedicated receiver thread, native decode +
        seq tracking, drop-oldest ring) — required headroom at Msps rates
        where per-datagram Python processing steals the chain feeder's time.
        None = auto (native when the runtime library is available)."""
        self._tcp = _AscpStream(
            socket.create_connection((host, port), timeout=timeout))
        # device datagrams target the TCP port number at our address
        # (rfspacedevice.cpp:652-656)
        if native is None:
            from pebblesdr_tpu import runtime as _rt

            native = _rt.available()
        self._pump = None
        self._udp = None
        if native:
            from pebblesdr_tpu.runtime import NativeUdpPump

            # swap_iq: the ASCP wire carries Q first (normalizeIQ(..., true),
            # rfspacedevice.cpp:899-900) — same convention as decode_cpx16
            self._pump = NativeUdpPump(
                port=port, header_bytes=4, seq_le16_offset=2, fmt="i16",
                swap_iq=True, block_samples=4 * SAMPLES_PER_DATAGRAM,
                ring_buffers=64)
            self._timeout_ms = int(timeout * 1000)
        else:
            self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._udp.bind(("", port))
            self._udp.settimeout(timeout)
        self.target_name = self._request_string(ITEM_TARGET_NAME)
        self.serial = self._request_string(ITEM_SERIAL)
        self.info = SourceInfo(sample_rate=sample_rate,
                               center_freq_hz=center_freq_hz,
                               name=f"ascp://{host}:{port} ({self.target_name})")
        self.dropped_datagrams = 0
        self._last_seq: int | None = None
        self._pending = np.zeros(0, np.complex64)
        self.set_sample_rate(sample_rate)
        self.set_center_freq(center_freq_hz)

    # ---------------------------------------------------------------- control

    def _transact(self, msg: bytes) -> bytes:
        self._tcp.send(msg)
        _, payload = self._tcp.recv_msg()
        return payload

    def _request_string(self, item: int) -> str:
        payload = self._transact(pack_item(TYPE_REQUEST, item))
        return payload[2:].split(b"\x00")[0].decode(errors="replace")

    def set_center_freq(self, freq_hz: float) -> None:
        self.info.center_freq_hz = freq_hz
        self._transact(pack_frequency(freq_hz))

    def set_sample_rate(self, rate: int) -> None:
        self.info.sample_rate = rate
        self._transact(pack_item(TYPE_SET, ITEM_IQ_SAMPLE_RATE,
                                 b"\x00" + struct.pack("<I", int(rate))))

    def set_rf_gain(self, gain_db: int) -> None:
        """0, -10, -20, -30 dB attenuator steps (rfspacedevice.cpp:1063)."""
        self._transact(pack_item(TYPE_SET, ITEM_RF_GAIN,
                                 b"\x00" + struct.pack("b", gain_db)))

    def start(self) -> None:
        """Receiver state RUN: complex IQ, 16-bit contiguous capture
        (rfspacedevice.cpp:1143-1144)."""
        self._transact(pack_item(TYPE_SET, ITEM_RECEIVER_STATE,
                                 bytes([0x80, STATE_RUN, 0x00, 0x00])))

    def stop(self) -> None:
        self._transact(pack_item(TYPE_SET, ITEM_RECEIVER_STATE,
                                 bytes([0x80, STATE_IDLE, 0x00, 0x00])))

    # ------------------------------------------------------------------- data

    def read_block(self, n: int) -> np.ndarray:
        """Assemble n complex64 samples from 256-sample datagrams; missed
        sequence numbers are zero-filled and counted (the reference notes but
        ignores gaps, rfspacedevice.cpp:876-878 — we surface them)."""
        if self._pump is not None:
            out = [self._pending]
            have = len(self._pending)
            while have < n:
                blk = self._pump.read_block(self._timeout_ms)
                if blk is None:
                    raise TimeoutError("sdr_ip: no UDP data from the radio")
                out.append(blk)
                have += len(blk)
            self.dropped_datagrams = self._pump.counters["dropped_datagrams"]
            buf = np.concatenate(out)
            self._pending = buf[n:]
            return buf[:n]
        out = [self._pending]
        have = len(self._pending)
        while have < n:
            pkt = self._udp.recv(DATAGRAM_BYTES)
            if (len(pkt) != DATAGRAM_BYTES or pkt[0] != 0x04
                    or pkt[1] != 0x84):
                continue
            seq = struct.unpack("<H", pkt[2:4])[0]
            if self._last_seq is not None:
                gap = (seq - self._last_seq - 1) & 0xFFFF
                if 0 < gap < 1024:
                    self.dropped_datagrams += gap
                    out.append(np.zeros(gap * SAMPLES_PER_DATAGRAM,
                                        np.complex64))
                    have += gap * SAMPLES_PER_DATAGRAM
            self._last_seq = seq
            samples = decode_cpx16(pkt[4:])
            out.append(samples)
            have += len(samples)
        buf = np.concatenate(out)
        self._pending = buf[n:]
        return buf[:n]

    def close(self) -> None:
        try:
            self.stop()
        except (ConnectionError, OSError):
            pass
        self._tcp.sock.close()
        if self._pump is not None:
            self._pump.close()
        if self._udp is not None:
            self._udp.close()


def discover(timeout: float = 2.0, bind_host: str = "",
             target_host: str = "255.255.255.255",
             request_port: int = DISCOVER_REQUEST_PORT) -> list[dict]:
    """Broadcast an ASCP discovery request; returns [{name, serial, ip, port}]
    (rfspacedevice.cpp:936-1006)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.bind((bind_host, DISCOVER_RESPONSE_PORT))
    sock.settimeout(timeout)
    req = struct.pack("<H", 5) + DISCOVER_KEY + b"\x00"
    sock.sendto(req, (target_host, request_port))
    found = []
    try:
        while True:
            pkt, _ = sock.recvfrom(1024)
            if len(pkt) < 56 or pkt[2:4] != DISCOVER_KEY or pkt[4] != 1:
                continue
            name = pkt[5:21].split(b"\x00")[0].decode(errors="replace")
            sn = pkt[21:37].split(b"\x00")[0].decode(errors="replace")
            ip = socket.inet_ntoa(pkt[37:41][::-1])
            port = struct.unpack("<H", pkt[53:55])[0]
            found.append({"name": name, "serial": sn, "ip": ip, "port": port})
    except socket.timeout:
        pass
    finally:
        sock.close()
    return found
