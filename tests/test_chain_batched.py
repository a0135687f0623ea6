"""step_many batched (straight-line, no-scan) path == sequential step()
for every supported mode, including spectra/S-meter/squelch and carry state
(the XLA front end over the whole dispatch vs one block at a time)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode

FS, N, K, C = 2_048_000, 32768, 3, 2


def _signal():
    t = np.arange(K * N) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)
    rng = np.random.default_rng(0)
    iq = iq + 1e-4 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape)).astype(np.complex64)
    return iq[None, :] * np.ones((C, 1), np.float32)


@pytest.mark.parametrize("mode", [DemodMode.AM, DemodMode.USB, DemodMode.LSB,
                                  DemodMode.CWU, DemodMode.DSB])
def test_batched_matches_sequential(mode):
    iq = _signal()
    xr2 = np.ascontiguousarray(iq.real.astype(np.float32).T)   # [K*N, C]
    xi2 = np.ascontiguousarray(iq.imag.astype(np.float32).T)
    blocks_tm = np.stack([xr2.reshape(K, N, C), xi2.reshape(K, N, C)], axis=1)

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=mode, batched_many=True)
    rx = Receiver(cfg)
    assert rx.batched_capable
    params = rx.default_params(250_000.0)

    st = rx.init_state()
    outs = []
    step = jax.jit(functools.partial(rx._step_impl, spectra=True))
    for k in range(K):
        st, o = step(st, params, jnp.asarray(blocks_tm[k]))
        outs.append(o)
    audio_seq = np.concatenate([np.asarray(o["audio"]) for o in outs], -1)
    spec_seq = np.stack([np.asarray(o["spectrum"]) for o in outs])
    zoom_seq = np.stack([np.asarray(o["zoomed"]) for o in outs])
    snr_seq = np.stack([np.asarray(o["smeter"]["snr_db"]) for o in outs])
    sq_seq = np.stack([np.asarray(o["squelch_open"]) for o in outs])

    st2 = rx.init_state()
    st2, ob = jax.jit(functools.partial(rx._step_many_impl, spectra=True))(
        st2, params, (jnp.asarray(xr2), jnp.asarray(xi2)))
    audio_b = np.asarray(ob["audio"]).transpose(1, 0, 2).reshape(C, -1)

    assert np.abs(audio_seq - audio_b).max() < 2e-4
    assert np.abs(spec_seq - np.asarray(ob["spectrum"])).max() < 0.1
    assert np.abs(zoom_seq - np.asarray(ob["zoomed"])).max() < 0.1
    assert np.abs(snr_seq - np.asarray(ob["smeter"]["snr_db"])).max() < 0.1
    assert (sq_seq == np.asarray(ob["squelch_open"])).all()

    # carry state must continue identically
    for name in ("fastfir", "agc", "resamp", "dc", "decim", "demod"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(st, name)),
                        jax.tree_util.tree_leaves(getattr(st2, name))):
            d = float(jnp.abs(jnp.asarray(a) - jnp.asarray(b)).max())
            assert d < 1e-4, (name, d)


def _wfm_signal():
    """Stereo FM composite: L-only 1 kHz program + 19 kHz pilot."""
    t = np.arange(K * N) / FS
    a = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * a + 0.1 * np.sin(th) + 0.45 * a * np.sin(2 * th)
    phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + phase))
          ).astype(np.complex64)
    return iq[None, :] * np.ones((C, 1), np.float32)


@pytest.mark.parametrize("mode", [DemodMode.FMS, DemodMode.FMM,
                                  DemodMode.FMN, DemodMode.SAM])
def test_batched_fm_matches_sequential(mode):
    iq = (_wfm_signal() if mode in (DemodMode.FMS, DemodMode.FMM)
          else _signal())
    xr2 = np.ascontiguousarray(iq.real.astype(np.float32).T)   # [K*N, C]
    xi2 = np.ascontiguousarray(iq.imag.astype(np.float32).T)
    x_pk = np.concatenate([xr2, xi2], axis=1)                  # [K*N, 2C]

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=mode, batched_many=True, batched_wfm=True)
    rx = Receiver(cfg)
    params = rx.default_params(250_000.0)

    st = rx.init_state()
    outs = []
    step = jax.jit(functools.partial(rx._step_impl, spectra=False))
    for k in range(K):
        st, o = step(st, params,
                     jnp.asarray(x_pk[k * N:(k + 1) * N]))
        outs.append(o)
    audio_seq = np.concatenate([np.asarray(o["audio"]) for o in outs], -1)

    st2 = rx.init_state()
    st2, ob = jax.jit(functools.partial(rx._step_many_impl, spectra=False))(
        st2, params, jnp.asarray(x_pk))
    a_b = np.asarray(ob["audio"])                  # [K, C, (2,) M]
    audio_b = np.moveaxis(a_b, 0, -2).reshape(audio_seq.shape)

    scale = max(np.abs(audio_seq).max(), 1e-6)
    # blockwise PLLs are streaming-equivalent to ~1e-3 rad (fp32 ramp
    # precision), so PLL-mode parity is tolerance-bounded, not bit-exact
    tol = 2e-4 if mode == DemodMode.FMN else 2e-3
    assert np.abs(audio_seq - audio_b).max() / scale < tol
    if mode == DemodMode.FMS:
        locked = np.asarray(ob["pilot_locked"])
        assert locked.shape == (K, C) and locked[-1].all()


@pytest.mark.parametrize("mode,hq", [(DemodMode.AM, False),
                                     (DemodMode.FMS, False),
                                     (DemodMode.FMS, True)])
def test_batched_time_fold_matches_sequential(mode, hq):
    """K=4 blocks at C=2 through the batched front; audio and display
    spectra must match sequential step() calls — including the wfm_hq
    (>=400 kHz composite) geometry."""
    kf = 4
    t = np.arange(kf * N) / FS
    if mode == DemodMode.FMS:
        a = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        th = 2 * np.pi * 19000.0 * t
        comp = 0.45 * a + 0.1 * np.sin(th) + 0.45 * a * np.sin(2 * th)
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + phase))
              ).astype(np.complex64)
    else:
        env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
        iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
              ).astype(np.complex64)
    rng = np.random.default_rng(0)
    iq = iq + 1e-4 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape)
                      ).astype(np.complex64)  # floor >> DFT rounding noise
    iq = iq[None, :] * np.ones((C, 1), np.float32)
    xr2 = np.ascontiguousarray(iq.real.astype(np.float32).T)
    xi2 = np.ascontiguousarray(iq.imag.astype(np.float32).T)
    x_pk = np.concatenate([xr2, xi2], axis=1)                  # [K*N, 2C]

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=mode, batched_many=True, agc_mode="off",
                         wfm_hq=hq)
    rx = Receiver(cfg)
    params = rx.default_params(250_000.0)

    st = rx.init_state()
    outs = []
    step = jax.jit(functools.partial(rx._step_impl, spectra=True))
    for k in range(kf):
        st, o = step(st, params, jnp.asarray(x_pk[k * N:(k + 1) * N]))
        outs.append(o)
    audio_seq = np.concatenate([np.asarray(o["audio"]) for o in outs], -1)
    spec_seq = np.stack([np.asarray(o["spectrum"]) for o in outs])

    st2 = rx.init_state()
    st2, ob = jax.jit(functools.partial(rx._step_many_impl, spectra=True))(
        st2, params, jnp.asarray(x_pk))
    a_b = np.asarray(ob["audio"])
    audio_b = np.moveaxis(a_b, 0, -2).reshape(audio_seq.shape)

    scale = max(np.abs(audio_seq).max(), 1e-6)
    assert np.abs(audio_seq - audio_b).max() / scale < 2e-3
    # FM's wideband composite leaves low floor bins where seq-vs-batched
    # rounding alone wiggles ~0.4 dB; an ordering bug shows up as ~20 dB
    spec_tol = 0.1 if mode == DemodMode.AM else 1.0
    assert np.abs(spec_seq - np.asarray(ob["spectrum"])).max() < spec_tol
    for name in ("dc", "decim", "mixer"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(st, name)),
                        jax.tree_util.tree_leaves(getattr(st2, name))):
            d = float(jnp.abs(jnp.asarray(a) - jnp.asarray(b)).max())
            assert d < 1e-4, (name, d)


def test_i16_entry_planes_match_f32():
    """int16 packed entry planes (the native-ADC container, dequantized at
    entry) == the f32 plane of the SAME dequantized values, bit-close, on
    both the batched and the sequential path."""
    import functools

    kf = 4
    t = np.arange(kf * N) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)
    iq = iq[None, :] * np.ones((C, 1), np.float32)
    x_pk_f = np.concatenate([iq.real.astype(np.float32).T,
                             iq.imag.astype(np.float32).T], axis=1)
    x_i16 = np.clip(np.round(x_pk_f * 32768.0), -32768, 32767).astype(np.int16)
    x_deq = x_i16.astype(np.float32) / 32768.0   # what the entry dequantizes

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=DemodMode.AM, agc_mode="off")
    rx = Receiver(cfg)
    params = rx.default_params(250_000.0)
    step_many = jax.jit(functools.partial(rx._step_many_impl, spectra=True))

    st_f = rx.init_state()
    st_f, of = step_many(st_f, params, jnp.asarray(x_deq))
    st_i = rx.init_state()
    st_i, oi = step_many(st_i, params, jnp.asarray(x_i16))
    np.testing.assert_allclose(np.asarray(oi["audio"]),
                               np.asarray(of["audio"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(oi["spectrum"]),
                               np.asarray(of["spectrum"]), atol=1e-3)

    # sequential single-block path accepts i16 too
    st1 = rx.init_state()
    step1 = jax.jit(functools.partial(rx._step_impl, spectra=False))
    st1, o1 = step1(st1, params, jnp.asarray(x_i16[:N]))
    st2 = rx.init_state()
    st2, o2 = step1(st2, params, jnp.asarray(x_deq[:N]))
    np.testing.assert_allclose(np.asarray(o1["audio"]),
                               np.asarray(o2["audio"]), atol=1e-6)


def test_anf_on_batched_path():
    """enable_anf no longer forces the scan path: the batched tail runs
    block-LMS at one update per logical block.  Streaming-exact across
    dispatches, and the notch actually adapts (nonzero weights, tonal
    output preserved)."""
    import functools

    kf = 4
    t = np.arange(2 * kf * N) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)
    rng = np.random.default_rng(9)
    iq = iq + 0.01 * (rng.standard_normal(len(t))
                      + 1j * rng.standard_normal(len(t))).astype(np.complex64)
    iq = iq[None, :] * np.ones((C, 1), np.float32)
    x_pk = np.concatenate([iq.real.astype(np.float32).T,
                           iq.imag.astype(np.float32).T], axis=1)

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=DemodMode.AM, agc_mode="off", enable_anf=True)
    rx = Receiver(cfg)
    assert rx.batched_capable          # ANF no longer disables it
    params = rx.default_params(250_000.0)
    step = jax.jit(functools.partial(rx._step_many_impl, spectra=False))

    st = rx.init_state()
    st, o1 = step(st, params, jnp.asarray(x_pk[:kf * N]))
    st, o2 = step(st, params, jnp.asarray(x_pk[kf * N:]))
    once = np.concatenate([np.asarray(o1["audio"]),
                           np.asarray(o2["audio"])], axis=0)

    st2 = rx.init_state()
    st2, ob = jax.jit(functools.partial(rx._step_many_impl, spectra=False))(
        st2, params, jnp.asarray(x_pk))
    np.testing.assert_allclose(np.asarray(ob["audio"]), once, atol=1e-5)
    # weights adapted toward the periodic component
    assert float(jnp.max(jnp.abs(st.anf.weights))) > 1e-3
    assert np.all(np.isfinite(once))


def test_batched_falls_back_for_scan_modes():
    """Configs the batched graph cannot serve (here: WFM with the legacy
    per-sample Costas RDS carrier) must take the scan path even when batched
    is requested."""
    iq = _wfm_signal()
    blocks_tm = np.stack(
        [iq.real.astype(np.float32).T.reshape(K, N, C),
         iq.imag.astype(np.float32).T.reshape(K, N, C)], axis=1)
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=DemodMode.FMS, rds=True, rds_alg="scan",
                         batched_many=True, batched_wfm=True)
    rx = Receiver(cfg)
    params = rx.default_params(250_000.0)
    st = rx.init_state()
    st, out = jax.jit(functools.partial(rx._step_many_impl, spectra=False))(
        st, params, jnp.asarray(blocks_tm))
    assert out["audio"].shape[0] == K


def test_batched_wfm_rds_decodes_ps():
    """The flagship config — WFM stereo + RDS — on the BATCHED fast path
    (scan-free open pilot + scan-free squaring-loop RDS carrier): step_many
    dispatches of K blocks must decode the PS name end to end."""
    from test_rds import differential_encode, make_ps_groups
    from pebblesdr_tpu.demod import rds as rds_mod

    n_disp, kb = 5, 8                       # 5 dispatches x 8 blocks
    n_total = n_disp * kb * N
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
    sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
    t = np.arange(n_total) / FS
    sym_idx = np.minimum((t * rds_mod.RDS_BAUD).astype(np.int64),
                         len(sym) - 1)
    frac = t * rds_mod.RDS_BAUD - sym_idx
    biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
    comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t))
    phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))
          ).astype(np.complex64)
    x_pk = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)  # [T, 2]

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=1,
                         mode=DemodMode.FMS, rds=True, batched_many=True)
    rx = Receiver(cfg)
    assert rx.batched_wfm and rx.rds_cfg.alg == "open"
    params = rx.default_params(300_000.0)
    st = rx.init_state()
    dec = rds_mod.RdsBlockDecoder()
    step = jax.jit(functools.partial(rx._step_many_impl, spectra=False))
    for d in range(n_disp):
        st, out = step(st, params,
                       jnp.asarray(x_pk[d * kb * N:(d + 1) * kb * N]))
        soft = np.asarray(out["rds_soft"])          # [K, C, n_sym]
        assert soft.shape[0] == kb
        dec.feed_symbols(soft[:, 0].reshape(-1))
        locked = np.asarray(out["pilot_locked"])
        assert locked.shape == (kb, 1)
    assert dec.synced
    assert len(dec.groups) >= 4, (dec.blocks_ok, dec.block_errors)
    g = rds_mod.RdsGroupDecoder()
    for grp in dec.groups:
        g.decode(grp)
    assert g.ps_name == "PEBBLES "


def test_batched_tm_checkpoint_and_retune():
    """Batched-path state (front carries, WFM tails, open-loop tracker
    states) must checkpoint/restore bit-exactly mid-stream and retune
    without recompiling (the recovery + no-recompile contracts hold on the
    batched graph)."""
    import dataclasses

    from pebblesdr_tpu.utils import checkpoint as ckpt

    kf = 4
    t = np.arange(2 * kf * N) / FS
    a = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * a + 0.1 * np.sin(th) + 0.45 * a * np.sin(2 * th)
    phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + phase))
          ).astype(np.complex64)
    iq = iq[None, :] * np.ones((C, 1), np.float32)
    x_pk = np.concatenate([iq.real.astype(np.float32).T,
                           iq.imag.astype(np.float32).T], axis=1)

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N, channels=C,
                         mode=DemodMode.FMS)
    rx = Receiver(cfg)
    assert rx.batched_capable
    params = rx.default_params(250_000.0)
    step = jax.jit(functools.partial(rx._step_many_impl, spectra=False))

    st = rx.init_state()
    st, out1 = step(st, params, jnp.asarray(x_pk[:kf * N]))

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/state.npz"
        ckpt.save_state(path, st)
        st_restored, _ = ckpt.load_state(path, rx.init_state())

    # continuation from the restored state must equal the uninterrupted one
    st_a, out_a = step(st, params, jnp.asarray(x_pk[kf * N:]))
    st_b, out_b = step(st_restored, params, jnp.asarray(x_pk[kf * N:]))
    np.testing.assert_array_equal(np.asarray(out_a["audio"]),
                                  np.asarray(out_b["audio"]))

    # retune is a pure params change: same compiled executable (no trace)
    with jax.log_compiles(False):
        params2 = rx.retune(params, 260_000.0)
        st_c, out_c = step(st_a, params2, jnp.asarray(x_pk[:kf * N]))
    assert np.all(np.isfinite(np.asarray(out_c["audio"])))


@pytest.mark.parametrize("channels", [3, 5])
def test_batched_odd_channel_counts(channels):
    """Odd channel counts with per-channel tunes: the batched graph ==
    sequential step() calls, and each channel keeps its own tune."""
    kf = 3
    t = np.arange(kf * N) / FS
    tunes = 250_000.0 + 20_000.0 * np.arange(channels)
    cap = sum(0.3 * (1 + 0.8 * np.cos(2 * np.pi * (700.0 + 100 * i) * t)) / 2
              * np.exp(2j * np.pi * f * t) for i, f in enumerate(tunes))
    iq = np.broadcast_to(cap.astype(np.complex64), (channels, kf * N))
    x_pk = np.concatenate([iq.real.T, iq.imag.T], axis=1).astype(np.float32)

    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                         channels=channels, mode=DemodMode.AM, agc_mode="off")
    rx = Receiver(cfg)
    assert rx.batched_capable
    params = rx.default_params(tunes)
    st = rx.init_state()
    step = jax.jit(functools.partial(rx._step_impl, spectra=True))
    seq = []
    for k in range(kf):
        st, o = step(st, params, jnp.asarray(x_pk[k * N:(k + 1) * N]))
        seq.append(np.asarray(o["audio"]))
    _, ob = jax.jit(functools.partial(rx._step_many_impl, spectra=True))(
        rx.init_state(), params, jnp.asarray(x_pk))
    np.testing.assert_allclose(np.asarray(ob["audio"]), np.stack(seq),
                               atol=2e-4)
    # channel i demodulates its own (700 + 100 i) Hz tone
    a = np.stack(seq)[-1]
    tt = np.arange(a.shape[-1]) / cfg.audio_rate
    for i in range(channels):
        f = 700.0 + 100 * i
        amp = np.abs(np.mean(a[i] * np.exp(-2j * np.pi * f * tt))) * 2
        assert amp > 0.05, (i, amp)
