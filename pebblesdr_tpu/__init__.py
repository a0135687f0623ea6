"""PebbleSDR: a software-defined-radio framework on a JAX accelerator.

A from-scratch JAX/XLA re-design of the capabilities of PebbleSDR
(reference: /root/reference, surveyed in SURVEY.md): a full SDR receive chain —
IQ ingest, NCO mixing, halfband decimator cascades, FFT overlap-save bandpass,
fractional resampling, windowed-FFT spectrum, AM/SAM/NFM/WFM(+RDS)/SSB/CW
demodulation, AGC, noise blanking, adaptive noise filtering, IQ balance, and
Goertzel digital-mode decoding — rebuilt as batched functional kernels over
``[channels, block]`` complex64 arrays with explicit carry-state pytrees,
jit-compiled chains, and channel/time sharding over device meshes.

Key architectural differences from the reference (deliberate):
  * per-sample stateful C++ loops -> batched pure functions w/ carry pytrees
  * QThread producer/consumer      -> double-buffered host feeder + jit steps
  * QMutex shared state            -> functional purity (no locks anywhere)
  * per-object malloc'd tails      -> explicit state arrays threaded via scan
  * single channel                 -> [channels, block] batched, mesh-sharded
"""

__version__ = "0.1.0"

def __getattr__(name):
    # lazy top-level exports (avoid importing jax-heavy modules on package import)
    if name in ("Receiver", "ReceiverConfig"):
        from pebblesdr_tpu.chain import receiver

        return getattr(receiver, name)
    if name == "DemodMode":
        from pebblesdr_tpu.demod.modes import DemodMode

        return DemodMode
    raise AttributeError(name)
