"""video_encoder_tpu_torch — the TVC1 encoder on PyTorch and CUDA.

A port of `video_encoder_tpu` (JAX/Pallas) to one NVIDIA H100: plain
tensor code is PyTorch, and each Pallas kernel on the ported path is a
CUDA C++ kernel for sm_90a under `csrc/`, built at first use by
`ops/kernels/build.py`. The JAX package stays the reference: streams from
this package are byte-identical to its streams, to the numpy golden model
and to the C++ oracle (`oracle/`).

This package imports `torch` and never `jax`. It reuses the reference's
JAX-free host modules (`codec.spec`, `codec.config`, `codec.golden.Frame`,
`codec.bitstream`, `io.yuv`, `utils.metrics`, `pipeline.encoder`) as they
are.
"""

__version__ = "0.1.0"
