"""RDS decode tests: block coding roundtrip + full signal path through the
WFM receiver (composite synthesis -> FM -> chain -> PS name recovery)."""

import numpy as np
import pytest

from pebblesdr_tpu.demod import rds


make_ps_groups = rds.ps_group_bits
differential_encode = rds.differential_encode


class TestBlockCoding:
    def test_syndrome_of_valid_block_matches_offset(self):
        bits = rds.encode_group(0x54A8, 0x0408, 0xE0E0, 0x4142)
        # reconstruct first block
        block = 0
        for b in bits[:26]:
            block = (block << 1) | b
        assert rds._syndrome(block) == rds._OFFSETS["A"]

    def test_block_decoder_syncs_and_groups(self):
        bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=4)
        # prepend junk bits to force a mid-stream sync
        bits = [1, 0, 1, 1, 0, 0, 1] + bits
        diff = differential_encode(bits)
        symbols = np.asarray(diff) * 2 - 1
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(symbols)
        assert dec.synced
        assert len(dec.groups) >= 3
        assert dec.block_errors == 0

    def test_group_decoder_ps_and_pty(self):
        bits = make_ps_groups(0x54A8, "KPBL-FM ", repeats=3)
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(bits)) * 2 - 1)
        g = rds.RdsGroupDecoder()
        for grp in dec.groups:
            g.decode(grp)
        assert g.ps_name == "KPBL-FM "
        assert g.pi == 0x54A8
        assert g.pty == 5

    def test_callsign_from_pi(self):
        g = rds.RdsGroupDecoder()
        g.pi = 0x54A8  # first W station
        assert g.callsign == "WAAA"
        g.pi = 0x1000
        assert g.callsign == "KAAA"

    def test_radiotext_2a(self):
        text = "HELLO FROM THE PEBBLE SDR CHAIN!"
        bits = []
        for seg in range(8):
            b = (2 << 12) | (5 << 5) | seg
            chunk = text[4 * seg:4 * seg + 4].ljust(4)
            c = (ord(chunk[0]) << 8) | ord(chunk[1])
            d = (ord(chunk[2]) << 8) | ord(chunk[3])
            bits.extend(rds.encode_group(0x1234, b, c, d))
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(bits)) * 2 - 1)
        g = rds.RdsGroupDecoder()
        for grp in dec.groups:
            g.decode(grp)
        assert text in g.radiotext


class TestFec:
    def test_single_bit_errors_corrected(self):
        bits = rds.encode_group(0x54A8, 0x0408, 0xE0E0, 0x4142)
        block = 0
        for b in bits[:26]:
            block = (block << 1) | b
        for pos in range(26):
            bad = block ^ (1 << pos)
            ok, fixed, n = rds.check_block(bad, rds._OFFSETS["A"], True)
            assert ok and fixed == block and n == 1, pos

    def test_burst_errors_up_to_5_corrected(self):
        bits = rds.encode_group(0x1234, 0x2405, 0x4865, 0x4C4C)
        block = 0
        for b in bits[:26]:
            block = (block << 1) | b
        rng = np.random.default_rng(1)
        for width in (2, 3, 4, 5):
            for _ in range(20):
                start = int(rng.integers(width - 1, 26))
                inner = int(rng.integers(0, 1 << max(0, width - 2)))
                e = (1 << start) | (1 << (start - width + 1))
                e |= inner << (start - width + 2)
                bad = block ^ e
                ok, fixed, n = rds.check_block(bad, rds._OFFSETS["A"], True)
                assert ok and fixed == block, (width, start)
                assert n == bin(e).count("1")

    def test_fec_rejects_wide_errors(self):
        """Errors spanning more than 5 positions are mostly rejected.  Some
        alias onto a correctable-burst syndrome (the burst table covers ~36%
        of the 1023 nonzero syndromes — inherent to correcting 5-bit bursts
        with 10 check bits; the reference's Meggitt walk has the same
        aliasing), which is why the sync machine, not FEC alone, guards
        group integrity."""
        bits = rds.encode_group(0x1234, 0x2405, 0x4865, 0x4C4C)
        block = 0
        for b in bits[:26]:
            block = (block << 1) | b
        rejected = 0
        wrong = 0
        rng = np.random.default_rng(2)
        for _ in range(200):
            e = 0
            for pos in rng.choice(26, size=8, replace=False):
                e |= 1 << int(pos)
            ok, fixed, _ = rds.check_block(block ^ e, rds._OFFSETS["A"], True)
            if not ok:
                rejected += 1
            elif fixed != block:
                wrong += 1
        assert rejected > 110, rejected
        assert rejected + wrong == 200

    def test_no_fec_in_sync_acquisition(self):
        """BITSYNC/BLOCKSYNC use the raw checkword (no FEC) — a corrupted
        stream must not sync off corrected blocks (demod_wfm.cpp:594,608)."""
        bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=2)
        bits = np.asarray(bits)
        bits[10] ^= 1  # corrupt block A of the first group
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(list(bits[:26]))) * 2 - 1)
        assert not dec.synced


class TestSyncMachine:
    def test_false_block_a_dies_in_blocksync(self):
        """A random 26-bit pattern that happens to pass the block-A check
        must be rejected by the B/C/D sequence check, and the decoder must
        then still acquire the true sync."""
        # find junk bits whose window passes the A check at some alignment
        rng = np.random.default_rng(3)
        junk = None
        while junk is None:
            cand = rng.integers(0, 2, size=40).tolist()
            window = 0
            for i, b in enumerate(cand):
                window = ((window << 1) | int(b)) & ((1 << 26) - 1)
                if i >= 25 and rds._syndrome(window) == rds._OFFSETS["A"]:
                    junk = cand[:i + 1]
                    break
        bits = junk + make_ps_groups(0x54A8, "PEBBLES ", repeats=3)
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(bits)) * 2 - 1)
        assert dec.synced
        assert len(dec.groups) >= 2
        g = rds.RdsGroupDecoder()
        for grp in dec.groups:
            g.decode(grp)
        assert g.ps_name == "PEBBLES "

    def test_groupdecode_uses_fec(self):
        bits = np.asarray(make_ps_groups(0x54A8, "PEBBLES ", repeats=4))
        # corrupt 3 consecutive bits inside a mid-stream block (group 2, block C)
        pos = 104 * 2 + 26 * 2 + 7
        bits[pos:pos + 3] ^= 1
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(list(bits))) * 2 - 1)
        assert dec.synced
        assert dec.bits_corrected >= 3
        assert len(dec.groups) >= 3
        g = rds.RdsGroupDecoder()
        for grp in dec.groups:
            g.decode(grp)
        assert g.ps_name == "PEBBLES "

    def test_error_limit_falls_back_to_bitsync(self):
        good = make_ps_groups(0x54A8, "PEBBLES ", repeats=2)
        rng = np.random.default_rng(4)
        garbage = rng.integers(0, 2, size=26 * 30).tolist()
        bits = good + garbage + make_ps_groups(0x54A8, "PEBBLES ", repeats=3)
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(bits)) * 2 - 1)
        # must have re-acquired after the garbage and decoded the tail groups
        assert dec.synced
        assert dec.block_errors > 0
        g = rds.RdsGroupDecoder()
        for grp in dec.groups:
            g.decode(grp)
        assert g.ps_name == "PEBBLES "


class TestGroup1A:
    def test_ecc_and_pin_decoded(self):
        groups = []
        b = (1 << 12) | (5 << 5)            # group 1A, PTY 5
        c = (0 << 12) | 0xE2                # variant 0, ECC 0xE2 (Germany)
        d = 0x1234                          # PIN
        bits = rds.encode_group(0x54A8, b, c, d)
        dec = rds.RdsBlockDecoder()
        dec.feed_symbols(np.asarray(differential_encode(
            bits + make_ps_groups(0x54A8, "PEBBLES ", repeats=1))) * 2 - 1)
        g = rds.RdsGroupDecoder()
        for grp in dec.groups:
            g.decode(grp)
        assert g.ecc == 0xE2
        assert g.pin == 0x1234

    def test_pi_change_resets_station_text(self):
        g = rds.RdsGroupDecoder()
        for grp_bits in (make_ps_groups(0x54A8, "PEBBLES ", 1),):
            dec = rds.RdsBlockDecoder()
            dec.feed_symbols(np.asarray(differential_encode(grp_bits)) * 2 - 1)
            for grp in dec.groups:
                g.decode(grp)
        assert g.ps_name == "PEBBLES "
        # new station: PS must not show the old station's text
        dec = rds.RdsBlockDecoder()
        seg_bits = rds.encode_group(0x1000, (0 << 12) | (5 << 5) | 0, 0xE0E0,
                                    (ord("K") << 8) | ord("X"))
        dec.feed_symbols(np.asarray(differential_encode(
            seg_bits * 4)) * 2 - 1)
        for grp in dec.groups:
            g.decode(grp)
        assert g.pi == 0x1000
        assert "PEBBLES" not in g.ps_name


class TestRdsSignalPath:
    def test_full_chain_recovers_ps(self):
        """Synthesize an FM composite with a real RDS BPSK subcarrier, run the
        WFM receiver with rds=True, decode PS via the host state machine."""
        import jax.numpy as jnp

        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode

        FS, N = 2_048_000, 32768
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMS, rds=True)
        rx = Receiver(cfg)

        bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
        diff = differential_encode(bits)
        # biphase waveform at 1187.5 baud on the 57 kHz subcarrier
        sym = np.asarray(diff, np.float64) * 2 - 1
        sps = FS / rds.RDS_BAUD  # samples per symbol at device rate
        n_total = 40 * N
        t = np.arange(n_total) / FS
        sym_idx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
        frac = t * rds.RDS_BAUD - sym_idx
        biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
        # composite: mono tone + pilot + RDS at 57 kHz
        comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
                + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t))
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))).astype(np.complex64)

        state = rx.init_state()
        params = rx.default_params(300_000.0)
        block_dec = rds.RdsBlockDecoder()
        for i in range(40):
            state, out = rx.step(state, params, jnp.asarray(iq[None, i * N:(i + 1) * N]))
            block_dec.feed_symbols(np.asarray(out["rds_soft"])[0])
        assert block_dec.synced
        assert len(block_dec.groups) >= 4, (block_dec.blocks_ok, block_dec.block_errors)
        g = rds.RdsGroupDecoder()
        for grp in block_dec.groups:
            g.decode(grp)
        assert g.ps_name == "PEBBLES "
        assert g.callsign == "WAAA"

    def test_hq_geometry_recovers_ps(self):
        """Same signal through the wfm_hq geometry: RDS rides the
        composite DECIMATED to the 256k tail rate (WFMConfig.comp_decim,
        round 5) — the premix/decimation/carrier subchain must decode
        identically there."""
        import jax.numpy as jnp

        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode

        FS, N = 2_048_000, 32768
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMS, rds=True, wfm_hq=True)
        rx = Receiver(cfg)
        assert rx.wfm_comp_decim == 2

        bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
        sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
        n_total = 40 * N
        t = np.arange(n_total) / FS
        sym_idx = np.minimum((t * rds.RDS_BAUD).astype(np.int64),
                             len(sym) - 1)
        frac = t * rds.RDS_BAUD - sym_idx
        biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
        comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
                + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t))
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))
              ).astype(np.complex64)

        state = rx.init_state()
        params = rx.default_params(300_000.0)
        block_dec = rds.RdsBlockDecoder()
        for i in range(40):
            state, out = rx.step(state, params,
                                 jnp.asarray(iq[None, i * N:(i + 1) * N]),
                                 spectra=False)
            block_dec.feed_symbols(np.asarray(out["rds_soft"])[0])
        assert block_dec.synced
        assert block_dec.block_errors == 0
        g = rds.RdsGroupDecoder()
        for grp in block_dec.groups:
            g.decode(grp)
        assert g.ps_name == "PEBBLES "

    def test_noisy_chain_with_carrier_offset(self):
        """Off-air-like conditions: AWGN at ~20 dB IQ SNR plus a few-Hz
        carrier offset.  The FEC + 4-state sync machine must still recover
        the PS name; block error rate is measured and bounded (VERDICT
        round-1 item 4 — the round-1 decoder only ever saw a clean signal)."""
        import jax.numpy as jnp

        from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu.demod.modes import DemodMode

        FS, N = 2_048_000, 32768
        cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                             mode=DemodMode.FMS, rds=True)
        rx = Receiver(cfg)

        bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
        diff = differential_encode(bits)
        sym = np.asarray(diff, np.float64) * 2 - 1
        n_blocks = 40
        n_total = n_blocks * N
        t = np.arange(n_total) / FS
        sym_idx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
        frac = t * rds.RDS_BAUD - sym_idx
        biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
        comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
                + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t))
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        # carrier 4 Hz off the tune frequency + 20 dB AWGN
        carrier = 0.5 * np.exp(1j * (2 * np.pi * 300_004.0 * t + phase))
        rng = np.random.default_rng(11)
        snr_db = 20.0
        sig_pow = 0.5 ** 2
        sigma = np.sqrt(sig_pow / 10 ** (snr_db / 10) / 2)
        iq = (carrier + sigma * (rng.normal(size=n_total)
                                 + 1j * rng.normal(size=n_total))
              ).astype(np.complex64)

        state = rx.init_state()
        params = rx.default_params(300_000.0)
        block_dec = rds.RdsBlockDecoder()
        for i in range(n_blocks):
            state, out = rx.step(state, params,
                                 jnp.asarray(iq[None, i * N:(i + 1) * N]))
            block_dec.feed_symbols(np.asarray(out["rds_soft"])[0])
        assert block_dec.synced
        total_blocks = block_dec.blocks_ok + block_dec.block_errors
        bler = block_dec.block_errors / max(1, total_blocks)
        assert len(block_dec.groups) >= 4, (block_dec.blocks_ok,
                                            block_dec.block_errors)
        assert bler < 0.5, f"block error rate {bler:.2f}"
        g = rds.RdsGroupDecoder()
        for grp in block_dec.groups:
            g.decode(grp)
        assert g.ps_name == "PEBBLES "


class TestConfigGuards:
    def test_incompatible_block_raises_clearly(self):
        """A block whose 19 kHz stream is not whole symbols must raise a
        clear ValueError, not divide by zero (code-review r3 finding 3)."""
        with pytest.raises(ValueError, match="whole symbols"):
            rds.RdsConfig.make(256000.0, 2048)
