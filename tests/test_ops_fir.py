import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from pebblesdr_tpu.ops import decimator, fir


def _stream_apply(x, taps, decim, block):
    """Run fir_apply block-by-block and concatenate."""
    c = x.shape[0]
    tail = fir.fir_tail_init(c, len(taps))
    outs = []
    for i in range(0, x.shape[1], block):
        y, tail = fir.fir_apply(jnp.asarray(x[:, i:i + block]),
                                jnp.asarray(taps, jnp.float32), tail, decim)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


class TestFirApply:
    def test_matches_scipy_lfilter(self):
        rng = np.random.default_rng(1)
        x = (rng.normal(size=(2, 1024)) + 1j * rng.normal(size=(2, 1024))).astype(np.complex64)
        taps = scipy.signal.firwin(31, 0.25)
        y = _stream_apply(x, taps, 1, 256)
        ref = scipy.signal.lfilter(taps, [1.0], x, axis=1)
        np.testing.assert_allclose(y, ref, atol=1e-4)

    def test_streaming_equals_oneshot(self):
        rng = np.random.default_rng(2)
        x = (rng.normal(size=(1, 2048)) + 1j * rng.normal(size=(1, 2048))).astype(np.complex64)
        taps = scipy.signal.firwin(51, 0.1)
        y_stream = _stream_apply(x, taps, 1, 256)
        y_one = _stream_apply(x, taps, 1, 2048)
        np.testing.assert_allclose(y_stream, y_one, atol=1e-5)

    def test_decimation_matches_scipy(self):
        rng = np.random.default_rng(3)
        x = (rng.normal(size=(1, 1024)) + 1j * rng.normal(size=(1, 1024))).astype(np.complex64)
        taps = scipy.signal.firwin(31, 0.2)
        y = _stream_apply(x, taps, 2, 256)
        ref = scipy.signal.lfilter(taps, [1.0], x, axis=1)[:, ::2]
        np.testing.assert_allclose(y, ref, atol=1e-4)

    def test_complex_taps_hilbert(self):
        """Analytic bandpass passes +f, rejects -f."""
        taps = fir.design_hilbert(61, 1000.0, 1800.0, 8000.0)
        n = np.arange(4096)
        pos = np.exp(2j * np.pi * 1000 * n / 8000).astype(np.complex64)[None]
        neg = np.exp(-2j * np.pi * 1000 * n / 8000).astype(np.complex64)[None]
        tail = fir.fir_tail_init(1, len(taps))
        yp, _ = fir.fir_apply_complex(jnp.asarray(pos), jnp.asarray(taps, jnp.complex64), tail)
        yn, _ = fir.fir_apply_complex(jnp.asarray(neg), jnp.asarray(taps, jnp.complex64), tail)
        p_pos = float(jnp.mean(jnp.abs(yp[:, 100:]) ** 2))
        p_neg = float(jnp.mean(jnp.abs(yn[:, 100:]) ** 2))
        assert 10 * np.log10(p_pos / p_neg) > 50

    def test_complex_taps_banded_fast_path_matches_conv(self):
        # taps_np engages the paired banded-matmul path; must equal the conv
        # lowering, streaming, including the carried complex tail
        taps = fir.design_hilbert(61, 1000.0, 1800.0, 8000.0)
        rng = np.random.default_rng(6)
        x = (rng.normal(size=(3, 4096))
             + 1j * rng.normal(size=(3, 4096))).astype(np.complex64)
        t_conv = fir.fir_tail_init(3, len(taps))
        t_fast = fir.fir_tail_init(3, len(taps))
        outs_c, outs_f = [], []
        for i in range(0, 4096, 1024):
            blk = jnp.asarray(x[:, i:i + 1024])
            yc, t_conv = fir.fir_apply_complex(
                blk, jnp.asarray(taps, jnp.complex64), t_conv)
            yf, t_fast = fir.fir_apply_complex(
                blk, jnp.asarray(taps, jnp.complex64), t_fast, taps_np=taps)
            outs_c.append(np.asarray(yc))
            outs_f.append(np.asarray(yf))
        np.testing.assert_allclose(np.concatenate(outs_f, -1),
                                   np.concatenate(outs_c, -1), atol=2e-5)


class TestHalfbandDesign:
    @pytest.mark.parametrize("ntaps,wpass", decimator.HALFBAND_SPECS[1:])
    def test_response(self, ntaps, wpass):
        h = fir.design_halfband(ntaps, wpass)
        w, resp = scipy.signal.freqz(h, worN=4096, fs=1.0)
        mag = np.abs(resp)
        passband = mag[w <= wpass / 2 * 0.95]
        stopband = mag[w >= 0.5 - wpass / 2 * 0.95]
        assert np.max(np.abs(passband - 1.0)) < 0.01, "passband ripple"
        assert 20 * np.log10(np.max(stopband) + 1e-12) < -40, "stopband attenuation"

    def test_halfband_structure(self):
        h = fir.design_halfband(23, 0.1820)
        center = 11
        for i in range(23):
            if i != center and (i - center) % 2 == 0:
                assert h[i] == 0.0
        assert h[center] == pytest.approx(0.5, abs=1e-6)


class TestDecimatorChain:
    def test_plan_2msps(self):
        plan = decimator.build_plan(2_048_000, 20_000)
        # 2.048M -> 32k in 6 stages (at 32k no halfband can still protect a
        # full 20 kHz: 20k/32k=.625 > hb55's .40 — same bound as the reference
        # wPass table, decimator.h:152-171)
        assert plan.factor == 64
        assert plan.rate_out == 32000.0
        # 20k/2.048M = .0098 > CIC3's .0030 -> first stage is hb11 (.05)
        assert plan.stages[0].name == "hb11"
        # later stages need progressively wider filters
        # (last stage at 64k: 20k/64k = .3125 -> hb47's .3200)
        assert plan.stages[-1].name == "hb47"

    def test_plan_cic3_first_stage(self):
        # narrow protect bw at high rate: 5 kHz at 4.096 Msps -> .0012 < .0030
        plan = decimator.build_plan(4_096_000, 5_000)
        assert plan.stages[0].name == "cic3"

    def test_plan_respects_out_rate(self):
        plan = decimator.build_plan(2_048_000, 20_000, sample_rate_out=200_000)
        assert plan.rate_out >= 200_000

    def test_tone_survives(self):
        """A 2 kHz tone at 2.048 Msps survives 128x decimation."""
        plan = decimator.build_plan(2_048_000, 20_000)
        n = 1 << 15
        t = np.arange(n)
        x = np.exp(2j * np.pi * 2000 * t / 2_048_000).astype(np.complex64)[None]
        st = decimator.state_init(plan, 1)
        st, y = decimator.apply(plan, st, jnp.asarray(x))
        y = np.asarray(y)[0]
        skip = len(y) // 4
        power = np.mean(np.abs(y[skip:]) ** 2)
        assert power == pytest.approx(1.0, rel=0.02)
        # frequency preserved: peak bin of decimated signal at 2 kHz/16 kHz
        spec = np.abs(np.fft.fft(y[skip:]))
        peak_f = np.argmax(spec) / len(y[skip:]) * plan.rate_out
        assert peak_f == pytest.approx(2000.0, abs=plan.rate_out / len(y[skip:]) * 2)

    def test_alias_rejected(self):
        """Noise above the protected bandwidth is strongly attenuated."""
        plan = decimator.build_plan(1_024_000, 20_000)
        n = 1 << 15
        t = np.arange(n)
        # tone at 300 kHz — far outside 20 kHz protect bw, would alias
        x = np.exp(2j * np.pi * 300_000 * t / 1_024_000).astype(np.complex64)[None]
        st = decimator.state_init(plan, 1)
        _, y = decimator.apply(plan, st, jnp.asarray(x))
        y = np.asarray(y)[0]
        power = np.mean(np.abs(y[len(y) // 4:]) ** 2)
        assert 10 * np.log10(power + 1e-12) < -50

    def test_streaming_continuity(self):
        plan = decimator.build_plan(256_000, 20_000)
        rng = np.random.default_rng(4)
        x = (rng.normal(size=(1, 8192)) + 1j * rng.normal(size=(1, 8192))).astype(np.complex64)
        st = decimator.state_init(plan, 1)
        outs = []
        for i in range(0, 8192, 2048):
            st, y = decimator.apply(plan, st, jnp.asarray(x[:, i:i + 2048]))
            outs.append(np.asarray(y))
        stream = np.concatenate(outs, axis=1)
        st2 = decimator.state_init(plan, 1)
        _, oneshot = decimator.apply(plan, st2, jnp.asarray(x))
        np.testing.assert_allclose(stream, np.asarray(oneshot), atol=1e-5)

    def test_compose_response_equals_cascade(self):
        plan = decimator.build_plan(2_048_000, 30_000)
        h = decimator.compose_response(plan)
        # DC gain of the composed filter == product of unity stage gains
        assert abs(h.sum() - 1.0) < 1e-9
        # impulse through the staged pipeline == composed response, decimated
        c = 1
        n = 4096
        x = np.zeros((c, n), np.complex64)
        x[0, 0] = 1.0
        ds = decimator.state_init(plan, c)
        _, y = decimator.apply(plan, ds, jnp.asarray(x))
        y = np.asarray(y)[0]
        f = plan.factor
        d = len(h) - 1
        expect = np.zeros_like(y)
        # y[m] = H[f*m] for f*m <= d (impulse at 0, zero history)
        for m in range(len(y)):
            if f * m <= d:
                expect[m] = h[f * m]
        assert np.abs(y - expect).max() < 1e-6


class TestRound5FirDesigns:
    def test_cfir_kaiser_matches_spec(self):
        """design_cfir_kaiser_lp replicates CFir::InitLPFilter's exact
        formula (fir.cpp): 6 dB point at (pass+stop)/2, >= Astop-3 dB in
        the stopband, unity DC gain."""
        import numpy as np

        from pebblesdr_tpu.ops import fir

        fs = 64000.0
        h = fir.design_cfir_kaiser_lp(40.0, 4500.0, 5500.0, fs)
        w = np.fft.rfftfreq(8192, 1 / fs)
        H = np.abs(np.fft.rfft(h, 8192))
        dc = H[0]
        assert abs(dc - 1.0) < 0.01
        # 6 dB cutoff at the midpoint
        i6 = np.argmin(np.abs(H - dc / 2))
        assert abs(w[i6] - 5000.0) < 150.0
        # stopband (the Kaiser estimate is within ~3 dB of the spec)
        stop = H[w > 6500.0].max()
        assert 20 * np.log10(stop / dc) < -37.0

    def test_rail_pair_is_quadrature(self):
        """design_rail_pair's (2h cos, 2h sin) rails are 90 deg apart at
        the shift frequency and together form the analytic BP."""
        import numpy as np

        from pebblesdr_tpu.ops import fir

        fs = 64000.0
        h = fir.design_cfir_kaiser_lp(40.0, 4500.0, 5500.0, fs)
        hi_, hq_ = fir.design_rail_pair(h, 5000.0, fs)
        # analytic combination must reject negative frequencies ~like the
        # underlying LP's stopband
        ha = hi_ + 1j * hq_
        W = np.fft.fftfreq(8192, 1 / fs)
        A = np.abs(np.fft.fft(ha, 8192))
        pos = A[(W > 1000) & (W < 9000)].min()
        neg = A[(W < -1000) & (W > -9000)].max()
        assert 20 * np.log10(neg / pos) < -30.0
