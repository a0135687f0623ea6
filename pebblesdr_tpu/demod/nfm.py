"""Narrowband FM demodulator: conjugate-product discriminator (+PLL variant).

Capability parity with Demod_NFM (application/demod/demod_nfm.cpp): three
algorithms — derivative-ratio FM1 (:99-119), conj-product phase-delta FM2
(:124-140), and the CuteSDR NCO-PLL (:225-257) — plus DC-offset tracking LP
and a voice low-pass.

Design: the conj-product form angle(x[n] * conj(x[n-1])) is exactly
vectorizable (one shifted multiply + atan2 over the block, carrying one sample
across blocks) and is the default; the PLL variant is available for parity
experiments (algorithm='pll').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.core.block import pytree_dataclass, static_field
from pebblesdr_tpu.ops import fir, iir, pll


@pytree_dataclass
class NFMConfig:
    sample_rate: float = static_field()
    max_deviation: float = static_field(default=5000.0)
    algorithm: str = static_field(default="conj")  # 'conj' | 'pll'
    voice_taps: np.ndarray = static_field(default=None)
    pll: pll.PLLConfig = static_field(default=None)

    @staticmethod
    def make(sample_rate: float, max_deviation: float = 5000.0,
             algorithm: str = "conj") -> "NFMConfig":
        taps = fir.design_lowpass_kaiser(3000.0, sample_rate, atten_db=50.0)
        pcfg = pll.make_pll_config(sample_rate, bw_hz=max_deviation,
                                   zeta=0.707, range_hz=max_deviation * 2,
                                   detector="atan2")
        return NFMConfig(sample_rate=sample_rate, max_deviation=max_deviation,
                         algorithm=algorithm, voice_taps=taps, pll=pcfg)


@pytree_dataclass
class NFMState:
    last: jax.Array      # [C] previous complex sample (conj discriminator)
    dc: jax.Array        # [C] DC-offset tracker
    lp_tail: jax.Array
    pll: pll.PLLState


def nfm_init(cfg: NFMConfig, channels: int) -> NFMState:
    return NFMState(
        last=jnp.zeros((channels,), jnp.complex64),
        dc=jnp.zeros((channels,), jnp.float32),
        lp_tail=fir.fir_tail_init(channels, len(cfg.voice_taps), jnp.float32),
        pll=pll.pll_init(cfg.pll, channels),
    )


def nfm_demod(cfg: NFMConfig, state: NFMState, x: jax.Array):
    """x: [C, N] complex64 -> (state', audio [C, N] float32)."""
    gain = cfg.sample_rate / (2.0 * np.pi * cfg.max_deviation)
    if cfg.algorithm == "pll":
        pll_state, _, freqs = pll.pll_run(cfg.pll, state.pll, x)
        audio = freqs * gain  # rad/sample deviation -> normalized audio
        new_last = state.last
    elif cfg.algorithm == "derivative":
        # FM1 derivative-ratio discriminator (demod_nfm.cpp:99-119):
        # (I*dQ - Q*dI) / |z|^2 — fully elementwise, no atan2
        prev = jnp.concatenate([state.last[:, None], x[:, :-1]], axis=-1)
        di = x.real - prev.real
        dq = x.imag - prev.imag
        mag2 = jnp.maximum(x.real**2 + x.imag**2, 1e-12)
        audio = (x.real * dq - x.imag * di) / mag2 * gain
        new_last = x[:, -1]
        pll_state = state.pll
    else:
        prev = jnp.concatenate([state.last[:, None], x[:, :-1]], axis=-1)
        delta = x * jnp.conj(prev)
        audio = jnp.arctan2(delta.imag, delta.real) * gain
        new_last = x[:, -1]
        pll_state = state.pll
    # DC-offset tracking (frequency error) removal
    dc, audio = iir.dc_removal_apply(state.dc, audio, alpha=0.999)
    audio, tail = fir.fir_apply_real_signal(audio, None, state.lp_tail,
                                            taps_np=cfg.voice_taps)
    return NFMState(last=new_last, dc=dc, lp_tail=tail, pll=pll_state), audio
