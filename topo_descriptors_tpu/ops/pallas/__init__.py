"""Hand-written Pallas kernels for the GPU.

The reference's closest analogue to native code is its Numba-JIT Sx loop
(topo.py:928-953). Here a hot path gets a kernel only where it beats what
XLA compiles from the plain version on the card:

* :mod:`sx_gpu` — the Sx horizon scan through Pallas's Triton route: one
  program per (azimuth, output tile) loops over its ray table, serving the
  shifted loads from L1/L2 instead of streaming the field from device
  memory once per ray.
"""
