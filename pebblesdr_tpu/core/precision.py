"""The matrix-product precision of every accuracy-bearing dot and conv.

On an NVIDIA GPU a float32 matrix product or convolution may run in TF32,
which keeps about three decimal digits, unless a precision asks for more.
The chain cannot afford that: its DFT-by-matmul spectra cancel terms
(ops/spectrum.py), its FIR and IIR closed forms sum hundreds of products,
and a reduced-precision product lifts the displayed noise floor and biases
the S-meter by tens of dB while every CPU test still passes (the CPU runs
float32 products exactly).

So every such site passes DOT_PRECISION, and it is HIGHEST: true float32
on the CUDA cores, no TF32.  Relaxing it for one op is a measured change,
and the device-vs-CPU parity phase of chip_smoke.py is its gate.
"""

import jax

DOT_PRECISION = jax.lax.Precision.HIGHEST
