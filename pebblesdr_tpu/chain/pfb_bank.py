"""Dense-bank front end: ONE polyphase filterbank feeds many channel tails.

The mixer-front channelizer (chain.Receiver with C channels, or its sharded
twin) runs C independent NCO+decimate fronts over the full-rate capture —
front cost O(C·N).  For a DENSE bank (tens to hundreds of channels on a
roughly uniform grid — band monitoring, the >=100-channel north star) the
critically-sampled PFB (ops.pfb) produces ALL M uniform channels in one pass:
one prototype-FIR einsum + one M-point transform per output frame, O(N·T +
N·log M) TOTAL — sublinear per channel — after which each wanted channel runs
the normal narrowband tail (fine-tune mix -> FastFIR -> AGC -> demod ->
resample) at the LOW channel rate fs/M.

Structure: `PfbBankReceiver` = ops.pfb front + a standard `chain.Receiver`
built AT the channel rate.  The tail Receiver's own NCO handles the residual
offset between a station and its channel center (so tuning is arbitrary, not
just the grid), its decimation plan is typically empty (fs/M lands at demod
rate), and every downstream feature (squelch, S-meter, taps, modes, spectra)
comes along for free.

Limits (inherent to critical sampling): a station's bandwidth plus its
|residual| must fit inside the channel passband — the prototype cuts at
fs/(2M), so stations near channel EDGES lose sideband energy (alias-folded
at decimation, unrecoverable downstream).  For on-grid or near-grid stations
(the dense-bank use case) this is immaterial; for arbitrary sparse tunes use
the mixer front.  Reference analog: none — the reference tunes ONE channel
at a time (CDownConvert, pebblelib/downconvert.cpp:257-325); this is the
accelerator widening (SURVEY §7.6).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from pebblesdr_tpu.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu.ops import pfb


def pick_bank_size(sample_rate: float, lo: float = 16000.0,
                   hi: float = 64000.0) -> int:
    """Largest power-of-two M with fs/M in [lo, hi] (channel rate ~ demod
    rate, so the tail needs no further decimation)."""
    m = 1
    while sample_rate / (2 * m) >= lo:
        m *= 2
    if not lo <= sample_rate / m <= hi:
        raise ValueError(f"no power-of-two bank puts {sample_rate} Hz into "
                         f"[{lo}, {hi}] Hz channels")
    return m


class PfbBankReceiver:
    """One wideband capture -> C demodulated channels through a shared PFB.

    tunes: [C] Hz offsets from capture center (arbitrary; each maps to its
    nearest bank channel + a residual handled by the tail Receiver's NCO).
    n_bank: filterbank size M (default: pick_bank_size).
    Everything else mirrors ReceiverConfig (mode, audio_rate, agc, ...).

    step(state, iq): iq is ONE wideband block — [N] complex64, [1, N]
    complex64, or an [N, 2] float32 (re, im) plane.  Returns (state', outputs) with the tail Receiver's full output
    dict ([C, ...] rows in tune order).
    step_many(state, iq): K blocks in one dispatch ([K*N] / [K*N, 2] / ...).
    """

    def __init__(self, sample_rate: int, frames_per_buffer: int, tunes,
                 mode: DemodMode = DemodMode.AM, n_bank: int | None = None,
                 taps_per_branch: int = 12, spectrum_bins: int | None = None,
                 oversample: int = 1, **rx_kwargs):
        fs = float(sample_rate)
        m = int(n_bank) if n_bank else pick_bank_size(fs)
        if frames_per_buffer % m:
            raise ValueError(f"frames_per_buffer={frames_per_buffer} not "
                             f"divisible by bank size {m}")
        # oversample=2: channels run at 2·fs/M and the prototype passes a
        # full channel width, so stations near channel EDGES keep their
        # sidebands (the critical bank's inherent loss, see module
        # docstring); costs a longer prototype + 2x channel-rate tail
        self.pfb_plan = pfb.plan(fs, m, taps_per_branch=taps_per_branch,
                                 os=oversample)
        ch_rate = fs / self.pfb_plan.hop
        if ch_rate != int(ch_rate):
            raise ValueError(f"channel rate {ch_rate} not integral")
        self.n_bank = m
        self.ch_rate = int(ch_rate)
        n_ch_block = frames_per_buffer // self.pfb_plan.hop

        tunes = np.atleast_1d(np.asarray(tunes, np.float64))
        centers = pfb.channel_freqs(self.pfb_plan)             # [M] Hz
        # nearest center with Nyquist wrap
        diff = tunes[:, None] - centers[None, :]
        diff = (diff + fs / 2) % fs - fs / 2
        self.chan_idx = np.argmin(np.abs(diff), axis=1)        # [C]
        self.residuals = diff[np.arange(len(tunes)), self.chan_idx]
        if np.any(np.abs(self.residuals) > fs / (2 * m) + 1e-6):
            raise AssertionError("residual exceeds half a channel")

        # a station on its channel center IS the channel stream's DC term —
        # the front-end ADC-offset blocker would eat the AM carrier (offsets
        # land in bank channel 0 only, which no station assignment uses
        # unless tuned there deliberately)
        rx_kwargs.setdefault("enable_dc_removal", False)
        self.rx = Receiver(ReceiverConfig(
            sample_rate=self.ch_rate, frames_per_buffer=n_ch_block,
            channels=len(tunes), mode=mode,
            spectrum_bins=min(spectrum_bins or 2048, n_ch_block),
            **rx_kwargs))
        # the tail NCO takes out each station's residual offset
        self.params = self.rx.default_params(self.residuals)
        self.frames_per_buffer = frames_per_buffer
        self._step = jax.jit(self._step_impl, donate_argnums=(0,),
                             static_argnames=("spectra",))
        self._step_many = jax.jit(self._step_many_impl, donate_argnums=(0,),
                                  static_argnames=("spectra",))

    # ------------------------------------------------------------------ state
    def init_state(self):
        return (pfb.init_state(self.pfb_plan, 1), self.rx.init_state())

    def retune(self, tunes):
        """Runtime retune: same bank, new residuals (no recompile as long as
        each tune keeps its nearest-channel assignment pattern length C)."""
        fs = float(self.pfb_plan.fs_in)
        tunes = np.atleast_1d(np.asarray(tunes, np.float64))
        centers = pfb.channel_freqs(self.pfb_plan)
        diff = (tunes[:, None] - centers[None, :] + fs / 2) % fs - fs / 2
        self.chan_idx = np.argmin(np.abs(diff), axis=1)
        self.residuals = diff[np.arange(len(tunes)), self.chan_idx]
        self.params = self.rx.retune(self.params, self.residuals)

    # ------------------------------------------------------------------- step
    def _to_complex(self, iq: jax.Array) -> jax.Array:
        if jnp.issubdtype(iq.dtype, jnp.floating):  # [N, 2] plane
            return jax.lax.complex(iq[:, 0], iq[:, 1])[None, :]
        if iq.ndim == 1:
            return iq[None, :]
        return iq  # [1, N]

    def _front(self, pfb_state, chan_idx, iq):
        x = self._to_complex(iq)                              # [1, N]
        pfb_state, y = pfb.apply(self.pfb_plan, pfb_state, x)  # [1, M, N/M]
        return pfb_state, y[0][chan_idx]                       # [C, N/M]

    def _step_impl(self, state, params, chan_idx, iq, spectra=True):
        pfb_state, rx_state = state
        pfb_state, ch = self._front(pfb_state, chan_idx, iq)
        rx_state, out = self.rx._step_impl(rx_state, params, ch,
                                           spectra=spectra)
        return (pfb_state, rx_state), out

    def _step_many_impl(self, state, params, chan_idx, iq, spectra=True):
        n = self.frames_per_buffer
        rx = self.rx
        if rx.batched_capable:
            # ONE straight-line graph for the whole dispatch: filterbank
            # front once over the concatenated capture, then the tail
            # Receiver's batched front end and tail (Receiver._many_batched)
            pfb_state, rx_state = state
            x = self._to_complex(iq.reshape(-1, iq.shape[-1])
                                 if jnp.issubdtype(iq.dtype, jnp.floating)
                                 else iq.reshape(1, -1)[0])
            pfb_state, y = pfb.apply(self.pfb_plan, pfb_state, x)
            rx_state, out = rx._many_batched(rx_state, params, y[0][chan_idx],
                                             spectra=spectra)
            return (pfb_state, rx_state), out

        if jnp.issubdtype(iq.dtype, jnp.floating):
            blocks = iq.reshape(-1, n, 2)
        else:
            blocks = iq.reshape(-1, n)

        def body(st, blk):
            return self._step_impl(st, params, chan_idx, blk, spectra=spectra)

        return jax.lax.scan(body, state, blocks)

    def step(self, state, iq, params=None, spectra: bool = True):
        """params defaults to the bank's current residual tuning.  Both the
        RxParams and the channel-index gather are jit INPUTS, so retune
        (new residuals AND new channel assignments) never recompiles."""
        return self._step(state, self.params if params is None else params,
                          jnp.asarray(self.chan_idx), iq, spectra=spectra)

    def step_many(self, state, iq, params=None, spectra: bool = True):
        """K concatenated blocks in ONE dispatch (amortizes the dispatch
        floor; outputs gain a leading K axis)."""
        return self._step_many(state,
                               self.params if params is None else params,
                               jnp.asarray(self.chan_idx), iq,
                               spectra=spectra)
