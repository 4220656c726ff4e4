"""SUREL+ in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `surel_plus_tpu` (which stays the reference).
The sub-packages mirror its layout: `graph/`, `spg/`, `ops/` with
`ops/kernels/` in place of `ops/pallas/`, `models/`, `train/`, and
`csrc/` for the CUDA sources. This package imports neither JAX nor
anything of `surel_plus_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; on a
CPU tensor every kernel wrapper takes its plain PyTorch version.
"""
