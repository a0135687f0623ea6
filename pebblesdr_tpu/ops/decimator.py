"""Halfband decimator cascade: wideband IQ -> lowest rate protecting a bandwidth.

Capability parity with Decimator/HalfbandFilter (pebblelib/decimator.{h,cpp}):
  * buildDecimationChain (decimator.cpp:64-149): pick, per decimate-by-2 stage,
    the cheapest halfband filter whose alias-free bandwidth (wpass * input rate)
    still covers the protected bandwidth; stop at minDecimatedSampleRate=15000
    (decimator.h:245) or a requested output rate.
  * CIC3 comb for the earliest (widest) stages, equiripple halfbands after
    (taps/wpass spec table from decimator.h:152-171, filters re-designed here
    with scipy.remez — see ops.fir.design_halfband).
  * per-stage streaming state (convolveOS saved tail, decimator.cpp:323-378)
    -> explicit [C, T-1] tails in DecimatorState.

Design: each stage is one strided XLA conv over the whole
[channels, block]; the python loop over stages unrolls at trace time into a
fused pipeline.  Unlike the reference's stage-merging optimization
(decimator.cpp:130-143, which fights per-call overhead), XLA fuses the chain
automatically.  Block length must be divisible by the total decimation (static
shapes), which the chain planner guarantees.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from pebblesdr_tpu.ops import fir

MIN_DECIMATED_RATE = 15000  # decimator.h:245

# taps -> alias-free bandwidth fraction of input rate (decimator.h:152-171 spec)
HALFBAND_SPECS: list[tuple[int, float]] = [
    (7, 0.0030),
    (11, 0.0500),
    (15, 0.0980),
    (19, 0.1434),
    (23, 0.1820),
    (27, 0.2160),
    (31, 0.2440),
    (35, 0.2680),
    (39, 0.2880),
    (43, 0.3060),
    (47, 0.3200),
    (51, 0.3332),
    (55, 0.4000),
]


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str          # "cic3" or "hb{taps}"
    taps: np.ndarray   # float64 host-side taps (DC gain 1)


@dataclasses.dataclass(frozen=True)
class DecimatorPlan:
    stages: tuple[Stage, ...]
    rate_in: float
    rate_out: float
    protect_bw: float

    @property
    def factor(self) -> int:
        return 2 ** len(self.stages)


_halfband_cache: dict[int, np.ndarray] = {}


def _halfband(ntaps: int, wpass: float) -> np.ndarray:
    if ntaps not in _halfband_cache:
        _halfband_cache[ntaps] = fir.design_halfband(ntaps, wpass)
    return _halfband_cache[ntaps]


def build_plan(sample_rate: float, protect_bw: float,
               sample_rate_out: float = 0.0, use_cic3: bool = True) -> DecimatorPlan:
    """Build the decimate-by-2 chain (buildDecimationChain capability).

    Decimates while the post-stage rate stays >= max(min_rate, sample_rate_out)
    and a filter exists that protects protect_bw at the current input rate.
    """
    min_rate = max(float(sample_rate_out), float(MIN_DECIMATED_RATE))
    rate = float(sample_rate)
    stages: list[Stage] = []
    while rate / 2.0 >= min_rate:
        need = protect_bw / rate  # required alias-free fraction at this rate
        chosen = None
        for ntaps, wpass in HALFBAND_SPECS:
            if wpass >= need:
                if use_cic3 and ntaps == 7:
                    chosen = Stage("cic3", fir.CIC3_TAPS)
                else:
                    chosen = Stage(f"hb{ntaps}", _halfband(ntaps, wpass))
                break
        if chosen is None:
            break  # no filter can protect this bandwidth — stop decimating
        stages.append(chosen)
        rate /= 2.0
    return DecimatorPlan(tuple(stages), float(sample_rate), rate, float(protect_bw))


def compose_response(plan: DecimatorPlan) -> np.ndarray:
    """Collapse the stage cascade into ONE full-rate FIR (noble identity).

    conv(h1) ↓2 conv(h2) ↓2 ... == conv(H) ↓2^k with
    H = h1 * up2(h2) * up4(h3) * ...  (float64 host-side).  The composed form
    is the front end's path (ops.front): the whole cascade becomes one
    polyphase convolution instead of k strided passes (the staged form's
    per-stage even/odd splits and tails).  Matches the staged pipeline exactly in exact
    arithmetic; verified to ~1e-7 relative in float32.
    """
    h = np.array([1.0])
    up = 1
    for st in plan.stages:
        taps = np.asarray(st.taps, np.float64)
        hu = np.zeros((len(taps) - 1) * up + 1)
        hu[::up] = taps
        h = np.convolve(h, hu)
        up *= 2
    return h


def state_init(plan: DecimatorPlan, channels: int) -> tuple[jax.Array, ...]:
    return tuple(
        fir.fir_tail_init(channels, len(st.taps)) for st in plan.stages
    )


def apply(plan: DecimatorPlan, state: tuple[jax.Array, ...], x: jax.Array):
    """x: [C, N] complex64, N divisible by 2**len(stages).

    Returns (new_state, y [C, N / 2**nstages]).
    """
    new_tails = []
    y = x
    for st, tail in zip(plan.stages, state):
        # polyphase even/odd fast path: static taps, zero coefficients skipped
        y, nt = fir.fir_decimate2_polyphase(y, st.taps.astype(np.float32), tail)
        new_tails.append(nt)
    return tuple(new_tails), y
