"""RDS (Radio Data System) decode: 57 kHz BPSK subcarrier -> PS/RadioText.

Capability parity with the reference RDS path (demod_wfm.cpp:297-353 device
side; rdsdecode.{h,cpp} + rbdsconstants.h host side):
  * 57 kHz subcarrier downconvert + decimate (CDownConvert :297),
  * subcarrier recovery (RDS PLL) — here a Costas loop for BPSK,
  * matched filter + symbol-rate sampling + differential decode (:301-353),
  * 26-bit block syndrome check with offset words A/B/C/C'/D, group sync,
    and group assembly into PI / PTY / PS name / RadioText
    (checkBlock :708+, processNewRdsBit :583+, CRdsDecode).

Device/host split: everything through soft symbol values is jit'd JAX
(RdsDemod.process); bit slicing, block sync, and text assembly are a small
host state machine (RdsBlockDecoder / RdsGroupDecoder) — bit-level control
flow XLA has no business compiling.

Rate plan: composite (e.g. 512 kHz) -> mix -57 kHz -> halfband cascade to
16 kHz -> polyphase resample to 19 kHz = EXACTLY 16 samples per RDS symbol
(1187.5 baud * 16 = 19000), so symbol timing is a static reshape + argmax
over 16 phases instead of the reference's per-sample bit-sync resonator.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core.block import pytree_dataclass, static_field
from pebblesdr_tpu.ops import decimator, fir, pll, resampler

RDS_CARRIER_HZ = 57000.0
RDS_BAUD = 1187.5
SPS = 16  # samples per symbol at 19 kHz


@pytree_dataclass
class RdsConfig:
    composite_rate: float = static_field()
    plan: object = static_field()           # decimator plan composite->16k
    rs_plan: object = static_field()        # 16k -> 19k resampler
    pll: pll.PLLConfig = static_field()
    mf_taps: np.ndarray = static_field()    # biphase matched filter @19k
    n_sym: int = static_field()             # symbols per block
    # carrier recovery: "open" (default) = scan-free squaring loop
    # (pll.costas_open_run) — zero sequential ops, so the RDS tap rides the
    # batched multi-block fast path; "scan" = the per-sample Costas lax.scan
    # (the reference-shaped RDS PLL, demod_wfm.cpp:301-317)
    alg: str = static_field(default="open")
    costas_open: pll.CostasOpenConfig = static_field(default=None)
    chunk19: int = static_field(default=16)  # open-loop chunk at 19 kHz,
    #                                          adapted to divide one block's
    #                                          symbol stream so batched and
    #                                          per-block calls share the grid
    # composite -> 16 kHz decimation as ONE composed-FIR banded matmul
    # (noble identity, like the chain's front end) instead of the staged
    # per-stage polyphase passes — the RDS subchain's dominant cost at
    # composite rate becomes one matmul; "staged" keeps the per-stage form
    h_composed: np.ndarray = static_field(default=None)
    composed: bool = static_field(default=True)
    # PREMIX (round 4): fold the -57 kHz mix INTO the decimation taps.
    # The input is then the RAW REAL composite [C, N] — no composite-rate
    # oscillator, no complex-baseband materialization, and the banded
    # matmul reads C real rows instead of 2C (mixed re/im) rows:
    #   y[m] = e^{-j2pi f mD/fs} * sum_j (h[j] e^{+j2pi f j/fs}) x[mD-j]
    # so taps split into (h cos, h sin) real sets applied in ONE paired
    # banded matmul (fir_apply_real_signal_pair), and the residual twiddle
    # runs at the 16 kHz output rate with the EXACT per-sample advance
    # f/16000 mod 1 (= 9/16 for the 57 kHz subcarrier: drift-free).
    premix: bool = static_field(default=True)
    h_mix_re: np.ndarray = static_field(default=None)
    h_mix_im: np.ndarray = static_field(default=None)
    mix_adv16: float = static_field(default=0.0)

    @staticmethod
    def make(composite_rate: float, block: int,
             alg: str = "open") -> "RdsConfig":
        plan = decimator.build_plan(composite_rate, 4800.0, sample_rate_out=16000)
        assert plan.rate_out == 16000.0, plan.rate_out
        n16 = block // plan.factor
        rs = resampler.plan(16000, 19000, n16, taps=16)
        n19 = rs.n_out
        if n19 % SPS:
            raise ValueError(
                f"RDS needs whole symbols per block: a {block}-sample "
                f"composite block yields {n19} samples at 19 kHz, not a "
                f"multiple of {SPS} (use a block length whose 16 kHz "
                f"stream is a multiple of {SPS * 16})")
        # biphase (Manchester) matched filter: +half, -half of a symbol
        half = SPS // 2
        mf = np.concatenate([np.ones(half), -np.ones(half)]) / SPS
        cfg_pll = pll.make_pll_config(19000.0, bw_hz=30.0, zeta=0.707,
                                      center_hz=0.0, range_hz=100.0,
                                      detector="costas")
        # open-loop chunk: multiple of SPS (chunk sums then null the baud
        # harmonics of the squared signal) that divides the per-block stream
        ell = 64
        while ell > SPS and n19 % ell:
            ell //= 2
        assert ell >= SPS and n19 % ell == 0  # n19 % SPS == 0 checked above
        h = decimator.compose_response(plan)
        jj = np.arange(len(h), dtype=np.float64)
        th = 2.0 * np.pi * (RDS_CARRIER_HZ / composite_rate) * jj
        return RdsConfig(composite_rate=composite_rate, plan=plan, rs_plan=rs,
                         pll=cfg_pll, mf_taps=mf, n_sym=n19 // SPS, alg=alg,
                         costas_open=pll.make_costas_open_config(19000.0),
                         chunk19=ell, h_composed=h,
                         h_mix_re=(h * np.cos(th)).astype(np.float32),
                         h_mix_im=(h * np.sin(th)).astype(np.float32),
                         mix_adv16=float(np.mod(RDS_CARRIER_HZ / 16000.0,
                                                1.0)))


@pytree_dataclass
class RdsState:
    decim: tuple
    resamp: jax.Array
    pll: pll.PLLState
    mf_tail: jax.Array
    phase_acc: jax.Array   # [C, SPS] EWMA of |mf| per symbol phase (timing)
    mix_phase: jax.Array = None  # [C] premix twiddle phase at the 16 kHz grid


def rds_init(cfg: RdsConfig, channels: int) -> RdsState:
    if cfg.premix:
        decim0 = jnp.zeros((channels, len(cfg.h_composed) - 1), jnp.float32)
    elif cfg.composed:
        decim0 = jnp.zeros((2 * channels, len(cfg.h_composed) - 1),
                           jnp.float32)
    else:
        decim0 = decimator.state_init(cfg.plan, channels)
    return RdsState(
        decim=decim0,
        resamp=resampler.state_init(cfg.rs_plan, channels, jnp.complex64),
        pll=(pll.costas_open_init(channels) if cfg.alg == "open"
             else pll.pll_init(cfg.pll, channels)),
        mf_tail=fir.fir_tail_init(channels, len(cfg.mf_taps), jnp.float32),
        phase_acc=jnp.zeros((channels, SPS), jnp.float32),
        mix_phase=jnp.zeros((channels,), jnp.float32),
    )


def rds_process(cfg: RdsConfig, state: RdsState, rds_baseband: jax.Array):
    """rds_baseband: with cfg.premix (default) the RAW REAL composite
    [C, N] float32 (the WFM discriminator output — no mixing upstream);
    legacy complex [C, N] input (already mixed by -57 kHz) is also
    accepted for cfg.premix=False configs.

    N may span K concatenated logical blocks (the batched step_many path):
    every stage is streaming-exact on the concatenated stream (decimator
    tails, block-periodic resampler, chunked open-loop carrier, matched
    filter); only the symbol-timing EWMA updates once per CALL rather than
    once per block (it tracks a slowly-moving sampling phase — the K-block
    aggregate is the same statistic at a different smoothing rate).

    Returns (state', soft [C, n_sym_total] float32 soft symbol values,
    timing_phase [C] int32) — sign(soft) are the biphase symbols; host does
    the rest (RdsBlockDecoder).
    """
    new_mix_phase = state.mix_phase
    if cfg.premix and not jnp.iscomplexobj(rds_baseband):
        # complex-tap decimation of the REAL composite + 16 kHz twiddle
        # (config comment above: one paired banded matmul over C real rows)
        ya, yb, st_d = fir.fir_apply_real_signal_pair(
            rds_baseband, state.decim, cfg.h_mix_re, cfg.h_mix_im,
            decim=cfg.plan.factor)
        n16 = ya.shape[-1]
        m = jnp.arange(n16, dtype=jnp.float32)[None, :]
        ph = jnp.mod(state.mix_phase[:, None]
                     + m * jnp.float32(cfg.mix_adv16), 1.0)
        tw_c = jnp.cos(2.0 * np.pi * ph)
        tw_s = jnp.sin(2.0 * np.pi * ph)
        # (ya + j yb) * e^{-j 2pi ph}
        x = jax.lax.complex(ya * tw_c + yb * tw_s, yb * tw_c - ya * tw_s)
        new_mix_phase = jnp.mod(
            state.mix_phase + n16 * jnp.float32(cfg.mix_adv16), 1.0)
    elif cfg.composed:
        # whole cascade as one real banded matmul on stacked [2C, N] rows
        c_in = rds_baseband.shape[0]
        xr = jnp.concatenate([rds_baseband.real, rds_baseband.imag], axis=0)
        y, st_d = fir.fir_apply_real_signal(
            xr, None, state.decim, decim=cfg.plan.factor,
            taps_np=np.asarray(cfg.h_composed, np.float32))
        x = jax.lax.complex(y[:c_in], y[c_in:])                         # 16 k
    else:
        st_d, x = decimator.apply(cfg.plan, state.decim, rds_baseband)  # 16 k
    st_r, x = resampler.apply_many(cfg.rs_plan, state.resamp, x)        # 19 k
    if cfg.alg == "open":
        st_p, phases, _ = pll.costas_open_run(cfg.costas_open, state.pll, x,
                                              chunk=cfg.chunk19)
    else:
        st_p, phases, _ = pll.pll_run(cfg.pll, state.pll, x)            # scan
    coherent = (x * jnp.exp(-1j * phases.astype(jnp.complex64))).real   # BPSK
    taps = jnp.asarray(cfg.mf_taps, jnp.float32)
    mf, mf_tail = fir.fir_apply_real_signal(coherent, taps, state.mf_tail)
    c, n19 = mf.shape
    sym = mf.reshape(c, n19 // SPS, SPS)
    # symbol-timing: EWMA the mean |mf| per intra-symbol phase, sample at max
    acc = 0.9 * state.phase_acc + 0.1 * jnp.mean(jnp.abs(sym), axis=1)
    best = jnp.argmax(acc, axis=-1)                                      # [C]
    soft = jnp.take_along_axis(sym, best[:, None, None], axis=-1)[..., 0]
    new_state = RdsState(decim=st_d, resamp=st_r, pll=st_p, mf_tail=mf_tail,
                         phase_acc=acc, mix_phase=new_mix_phase)
    return new_state, soft, best.astype(jnp.int32)


# ---------------------------------------------------------------- host side

# parity-check generator g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 (CENELEC EN 50067)
_G = 0b10110111001
_OFFSETS = {
    "A": 0b0011111100,
    "B": 0b0110011000,
    "C": 0b0101101000,
    "Cp": 0b1101010000,
    "D": 0b0110110100,
}
_BLOCK_SEQ = ["A", "B", "C", "D"]  # C may be C' in B-version groups


def _syndrome(block26: int) -> int:
    """10-bit syndrome of a 26-bit block (information*2^10 + checkword)."""
    reg = block26
    for i in range(25, 9, -1):
        if reg & (1 << i):
            reg ^= _G << (i - 10)
    return reg & 0x3FF


def _expected_offset(name: str) -> int:
    return _OFFSETS[name]


def _build_burst_table(max_burst: int = 5) -> dict:
    """syndrome(error) -> 26-bit error mask, for every burst error of width
    <= max_burst (errors confined to `max_burst` consecutive bit positions).

    The RDS (26,16) shortened cyclic code guarantees such bursts map to
    unique syndromes, so FEC is one dict lookup per errored block instead of
    the reference's per-bit Meggitt register walk (demod_wfm.cpp:705-756,
    USE_FEC at :64 — same correction power, blockwise formulation).
    """
    table: dict[int, int] = {}
    for start in range(26):  # msb position of the burst (bit index from lsb)
        for width in range(1, max_burst + 1):
            if start - width + 1 < 0:
                continue
            # first and last bit of the burst are set; interior bits free
            if width <= 2:
                interiors = [0]
            else:
                interiors = range(1 << (width - 2))
            for inner in interiors:
                e = 1 << start
                if width > 1:
                    e |= 1 << (start - width + 1)
                    e |= inner << (start - width + 2)
                syn = _syndrome(e)
                prev = table.get(syn)
                if prev is None or bin(e).count("1") < bin(prev).count("1"):
                    table[syn] = e
    return table


_BURST_TABLE = _build_burst_table()


def check_block(block26: int, offset: int, use_fec: bool):
    """Syndrome-check one 26-bit block against its offset word; with FEC,
    correct any <=5-bit burst error (checkBlock capability,
    demod_wfm.cpp:705-756).

    Returns (ok, corrected_block26, n_corrected_bits).
    """
    syn = _syndrome(block26) ^ offset
    if syn == 0:
        return True, block26, 0
    if use_fec:
        e = _BURST_TABLE.get(syn)
        if e is not None:
            return True, block26 ^ e, bin(e).count("1")
    return False, block26, 0


# decoder states (processNewRdsBit capability, demod_wfm.cpp:73-78,588-679)
_BITSYNC = 0      # sliding bit-by-bit, looking for a clean block A
_BLOCKSYNC = 1    # need B, C, D clean in sequence before trusting position
_GROUPDECODE = 2  # locked: decode groups, FEC enabled
_GROUPRESYNC = 3  # skip to the next group boundary after a block error

BLOCK_ERROR_LIMIT = 5  # bad blocks before falling back to bit-level sync


@dataclasses.dataclass
class RdsBlockDecoder:
    """Bits -> synced 26-bit blocks -> 4-block groups.

    Mirrors the reference's 4-state machine (demod_wfm.cpp:588-679):
    BITSYNC slides bit-by-bit until a block-A checkword passes WITHOUT FEC;
    BLOCKSYNC then requires B, C, D clean in sequence (a 26-bit false sync in
    noise dies here); GROUPDECODE runs with burst FEC (<=5 bits) and falls
    back to BITSYNC after BLOCK_ERROR_LIMIT consecutive bad blocks;
    GROUPRESYNC skips the remainder of a damaged group.  Differential decode
    included.
    """

    _state: int = _BITSYNC
    _bits: int = 0
    _nbits: int = 0
    _last_raw: int = 0
    _block_idx: int = 0
    _version_b: bool = False
    _group: list = dataclasses.field(default_factory=list)
    groups: list = dataclasses.field(default_factory=list)
    block_errors: int = 0        # cumulative bad blocks (stat)
    _consec_errors: int = 0      # consecutive bad blocks (resync trigger)
    blocks_ok: int = 0
    bits_corrected: int = 0      # FEC-corrected bit count (stat)

    @property
    def synced(self) -> bool:
        return self._state != _BITSYNC

    def feed_symbols(self, symbols: np.ndarray) -> None:
        """symbols: [n] biphase symbol signs (+-1 or bool).  RDS data is
        differentially encoded: bit = sym[k] XOR sym[k-1]."""
        raw = (np.asarray(symbols) > 0).astype(np.uint8)
        for s in raw:
            bit = int(s ^ self._last_raw)
            self._last_raw = int(s)
            self._push_bit(bit)

    def _offset_name(self) -> str:
        name = _BLOCK_SEQ[self._block_idx]
        if name == "C" and self._version_b:
            name = "Cp"
        return name

    def _push_bit(self, bit: int) -> None:
        self._bits = ((self._bits << 1) | bit) & ((1 << 26) - 1)
        self._nbits += 1
        if self._state == _BITSYNC:
            if self._nbits < 26:
                return
            ok, _, _ = check_block(self._bits, _OFFSETS["A"], use_fec=False)
            if ok:  # candidate bit position; BLOCKSYNC must confirm it
                self._group = [self._bits >> 10]
                self._block_idx = 1
                self._version_b = False
                self._nbits = 0
                self._state = _BLOCKSYNC
            return
        if self._nbits < 26:
            return
        self._nbits = 0
        if self._state == _BLOCKSYNC:
            ok, _, _ = check_block(self._bits, _OFFSETS[self._offset_name()],
                                   use_fec=False)
            if not ok:  # false bit sync — start over at the bit level
                self._state = _BITSYNC
                self._nbits = 26  # keep sliding bit-by-bit immediately
                self._group = []
                return
            self._take_block(self._bits)
            if self._block_idx == 0:  # D landed: bit position confirmed
                self._consec_errors = 0
                self._state = _GROUPDECODE
            return
        if self._state == _GROUPRESYNC:
            self._block_idx = (self._block_idx + 1) % 4
            if self._block_idx == 0:
                self._state = _GROUPDECODE
            return
        # GROUPDECODE
        ok, corrected, nbits = check_block(
            self._bits, _OFFSETS[self._offset_name()], use_fec=True)
        if not ok:
            self.block_errors += 1
            self._consec_errors += 1
            self._group = []
            if self._consec_errors > BLOCK_ERROR_LIMIT:
                self._state = _BITSYNC
                self._nbits = 26
                return
            self._block_idx = (self._block_idx + 1) % 4
            if self._block_idx != 0:  # skip the rest of this damaged group
                self._state = _GROUPRESYNC
            return
        self._consec_errors = 0
        self.bits_corrected += nbits
        self._take_block(corrected)

    def _take_block(self, block26: int) -> None:
        info = block26 >> 10
        self.blocks_ok += 1
        name = _BLOCK_SEQ[self._block_idx]
        if name == "A":
            self._group = [info]
        else:
            self._group.append(info)
        if name == "B":
            self._version_b = bool((info >> 11) & 1)
        if name == "D" and len(self._group) == 4:
            self.groups.append(tuple(self._group))
            self._group = []
        self._block_idx = (self._block_idx + 1) % 4


_PTY_NAMES_RBDS = [
    "None", "News", "Information", "Sports", "Talk", "Rock", "Classic Rock",
    "Adult Hits", "Soft Rock", "Top 40", "Country", "Oldies", "Soft",
    "Nostalgia", "Jazz", "Classical", "R&B", "Soft R&B", "Language",
    "Religious Music", "Religious Talk", "Personality", "Public", "College",
    "Spanish Talk", "Spanish Music", "Hip-Hop", "", "", "Weather",
    "Emergency Test", "Emergency",
]


@dataclasses.dataclass
class RdsGroupDecoder:
    """Groups -> station data (CRdsDecode capability: PI, PTY, PS name,
    RadioText, callsign from PI for RBDS; rdsdecode.cpp:115-146 — plus
    group 1A Extended Country Code / PIN decode, which the reference's
    GRPTYPE_1A case recognizes but leaves empty at rdsdecode.cpp:133)."""

    pi: int = 0
    pty: int = 0
    ecc: int = 0      # Extended Country Code (group 1A variant 0)
    pin: int = 0      # Programme Item Number (group 1 block D)
    ps: list = dataclasses.field(default_factory=lambda: [" "] * 8)
    rt: list = dataclasses.field(default_factory=lambda: [" "] * 64)

    def reset(self) -> None:
        """Station changed (new PI): clear per-station text (the reference's
        decodeReset-on-PI-change, rdsdecode.cpp:117-121)."""
        self.ps = [" "] * 8
        self.rt = [" "] * 64
        self.ecc = 0
        self.pin = 0

    def decode(self, group: tuple[int, int, int, int]) -> None:
        a, b, c, d = group
        if a and a != self.pi and self.pi:
            self.reset()
        self.pi = a
        gtype = (b >> 12) & 0xF
        version_b = (b >> 11) & 1
        self.pty = (b >> 5) & 0x1F
        if gtype == 0:  # PS name
            seg = b & 0x3
            self.ps[2 * seg] = chr((d >> 8) & 0xFF)
            self.ps[2 * seg + 1] = chr(d & 0xFF)
        elif gtype == 1:  # slow labelling codes / programme item number
            self.pin = d
            if not version_b:
                variant = (c >> 12) & 0x7
                if variant == 0:
                    self.ecc = c & 0xFF
        elif gtype == 2:  # RadioText
            seg = b & 0xF
            if version_b:
                self.rt[2 * seg] = chr((d >> 8) & 0xFF)
                self.rt[2 * seg + 1] = chr(d & 0xFF)
            else:
                self.rt[4 * seg] = chr((c >> 8) & 0xFF)
                self.rt[4 * seg + 1] = chr(c & 0xFF)
                self.rt[4 * seg + 2] = chr((d >> 8) & 0xFF)
                self.rt[4 * seg + 3] = chr(d & 0xFF)

    @property
    def ps_name(self) -> str:
        return "".join(self.ps)

    @property
    def radiotext(self) -> str:
        return "".join(self.rt).rstrip()

    @property
    def pty_name(self) -> str:
        return _PTY_NAMES_RBDS[self.pty] if self.pty < 32 else ""

    @property
    def callsign(self) -> str:
        """RBDS PI -> US callsign (rbdsconstants.h capability, K/W stations)."""
        pi = self.pi
        if 0x1000 <= pi <= 0x994F:
            if pi < 0x54A8:
                first, n = "K", pi - 0x1000
            else:
                first, n = "W", pi - 0x54A8
            c1, rem = divmod(n, 26 * 26)
            c2, c3 = divmod(rem, 26)
            return first + chr(65 + c1) + chr(65 + c2) + chr(65 + c3)
        return ""


def encode_group(a: int, b: int, c: int, d: int, version_b=False) -> list[int]:
    """Test helper: build the 104-bit differential-ready block bitstream for
    one group (information + checkwords + offsets)."""
    out_bits = []
    names = ["A", "B", "Cp" if version_b else "C", "D"]
    for info, name in zip((a, b, c, d), names):
        block = info << 10
        check = _syndrome(block) ^ _expected_offset(name)
        block |= check
        # verify
        assert _syndrome(block) == _expected_offset(name)
        out_bits.extend((block >> i) & 1 for i in range(25, -1, -1))
    return out_bits


def ps_group_bits(pi: int, ps_text: str, repeats: int = 8) -> list[int]:
    """Transmit side, for test signals: type-0A groups (PTY 5, no AF codes)
    carrying an 8-character PS name, `repeats` full cycles."""
    if len(ps_text) != 8:
        raise ValueError("a PS name is exactly 8 characters")
    bits = []
    for _ in range(repeats):
        for seg in range(4):
            b = (5 << 5) | seg
            d = (ord(ps_text[2 * seg]) << 8) | ord(ps_text[2 * seg + 1])
            bits.extend(encode_group(pi, b, 0xE0E0, d))
    return bits


def differential_encode(bits) -> list[int]:
    """The RDS differential coder (IEC 62106 §1.6): out_k = out_{k-1} ^ b_k."""
    out = []
    last = 0
    for b in bits:
        last ^= b
        out.append(last)
    return out
