"""The XLA front end (ops.front, run by Receiver._front) vs the staged
reference ops: dc_removal_chunked -> iq_balance -> noise_blanker_chunked ->
mixer.mix -> decimator.apply, streaming block-by-block and as one
multi-block call."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu.ops import decimator, front, iir, mixer, scanops

FS = 2_048_000
# the 2.048 Msps plans the chain builds: AM (factor 32), WFM (the ~256 kHz
# composite) and WFM hq (~512 kHz)
PLANS = {"am": (DemodMode.AM, False), "wfm": (DemodMode.FMS, False),
         "hq": (DemodMode.FMS, True)}


def _blocks(c, n, k, seed):
    rng = np.random.default_rng(seed)
    xs = []
    for _ in range(k):
        b = (0.1 * (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n)))
             + 0.05 - 0.02j).astype(np.complex64)
        for pos in (100, 2046, 2049, n - 3):   # impulses for the blanker
            b[:, pos] += 8.0 + 8.0j
        xs.append(b)
    return xs


def _staged(plan, xs, hi, lo, nb_mode, gain, phase):
    c = xs[0].shape[0]
    dc = jnp.zeros((c,), jnp.complex64)
    nbs = scanops.noise_blanker_chunked_init(c)
    ms = mixer.mixer_init(c)
    ds = decimator.state_init(plan, c)
    out = []
    for b in xs:
        dc, y = iir.dc_removal_chunked(dc, jnp.asarray(b), alpha=0.9999)
        if nb_mode:
            y = scanops.iq_balance(y, gain, phase)
            nbs, y = scanops.noise_blanker_chunked(
                nbs, y, threshold=3.3, blank_width=7, alpha=0.001,
                mode=nb_mode)
        ms, y = mixer.mix(ms, y, hi, lo)
        ds, y = decimator.apply(plan, ds, y)
        out.append(np.asarray(y))
    return np.concatenate(out, -1), dc, ms.phase


@pytest.mark.parametrize("plan_name", sorted(PLANS))
@pytest.mark.parametrize("nb_mode", [None, "blank", "average"])
def test_front_matches_staged_cascade(plan_name, nb_mode):
    """The Receiver's front end, per block and over all blocks at once,
    equals the staged cascade; NB and static IQ balance ride along."""
    mode, hq = PLANS[plan_name]
    c, n, k = 3, 8192, 3
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         mode=mode, wfm_hq=hq,
                         enable_iq_balance=bool(nb_mode),
                         enable_noise_blanker=(nb_mode or False))
    rx = Receiver(cfg)
    plan = rx.plan
    tunes = 250_000.0 + 1000.0 * np.arange(c)
    params = dataclasses.replace(
        rx.default_params(tunes), iq_gain=jnp.float32(1.05),
        iq_phase=jnp.float32(0.02))
    xs = _blocks(c, n, k, seed=len(plan_name))
    ref, dc_ref, ph_ref = _staged(plan, xs, params.tune_hi, params.tune_lo,
                                  nb_mode, 1.05, 0.02)

    st = rx.init_state()
    per_block = []
    for b in xs:
        fields, y, _ = rx._front(st, params, jnp.asarray(b))
        st = dataclasses.replace(st, **fields)
        per_block.append(np.asarray(y))
    per_block = np.concatenate(per_block, -1)

    fields1, one_shot, _ = rx._front(rx.init_state(), params,
                                     jnp.asarray(np.concatenate(xs, -1)))

    scale = np.abs(ref).max()
    assert per_block.shape == ref.shape == one_shot.shape
    assert np.abs(per_block - ref).max() / scale < 3e-5
    assert np.abs(np.asarray(one_shot) - ref).max() / scale < 3e-5
    np.testing.assert_allclose(np.asarray(fields1["dc"]), np.asarray(dc_ref),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(fields1["mixer"].phase),
                               np.asarray(ph_ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(st.decim),
                               np.asarray(fields1["decim"]), atol=1e-5)


def test_decimate_composed_impulse_is_composed_response():
    """An impulse through the polyphase form reads back H[F*m]."""
    plan = decimator.build_plan(FS, 30_000)
    h = decimator.compose_response(plan)
    f = plan.factor
    x = np.zeros((1, 4096), np.complex64)
    x[0, 0] = 1.0
    _, y = front.decimate_composed(front.hist_init(plan, 1), jnp.asarray(x),
                                   h, f)
    y = np.asarray(y)[0]
    expect = np.array([h[f * m] if f * m < len(h) else 0.0
                       for m in range(len(y))])
    assert np.abs(y - expect).max() < 1e-6


def test_plan_with_no_stages():
    """A rate already at the demod rate plans no decimation (D = 0, factor
    1): the front is DC + mix only, and the batched graph still equals the
    per-block steps."""
    fs, n, k = 24_000, 4096, 3
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                 channels=2, mode=DemodMode.AM,
                                 spectrum_bins=1024, agc_mode="off"))
    assert rx.plan.factor == 1 and rx.init_state().decim.shape == (2, 0)
    assert rx.batched_capable
    t = np.arange(k * n) / fs
    iq = ((1 + 0.5 * np.cos(2 * np.pi * 400.0 * t)) / 2
          * np.exp(2j * np.pi * 3000.0 * t)).astype(np.complex64)
    iq = np.broadcast_to(iq, (2, k * n)).copy()
    params = rx.default_params(3000.0)
    st = rx.init_state()
    seq = []
    for i in range(k):
        st, o = rx.step(st, params, jnp.asarray(iq[:, i * n:(i + 1) * n]))
        seq.append(np.asarray(o["audio"]))
    blocks = jnp.asarray(np.moveaxis(iq.reshape(2, k, n), 1, 0))
    _, ob = rx.step_many(rx.init_state(), params, blocks)
    np.testing.assert_allclose(np.asarray(ob["audio"]), np.stack(seq),
                               atol=2e-4)
    assert np.abs(np.stack(seq)[-1]).max() > 0.05
