"""video_encoder_tpu_torch — the TVC1 encoder on PyTorch and CUDA.

A port of `video_encoder_tpu` (JAX/Pallas) to one NVIDIA H100: plain
tensor code is PyTorch, and each Pallas kernel on the ported path is a
CUDA C++ kernel for sm_90a under `csrc/`, built at first use by
`ops/kernels/build.py`. The JAX package stays the reference: streams from
this package are byte-identical to its streams, to the numpy golden model
and to the C++ oracle (`oracle/`).

This package imports `torch`, never `jax`, and nothing of
`video_encoder_tpu`: it keeps its own copies of the host modules it needs
(`codec/spec.py`, `codec/config.py`, `codec/bitstream.py`,
`codec/frame.py`, `codec/native.py`, the numpy golden model
`codec/golden.py` and its `codec/bitio.py`, `io/yuv.py`, `utils/metrics.py`,
`pipeline/checkpoint.py`, `pipeline/bitstream_writer.py`, and the
stage timer and event log of `utils/trace.py`), held equal to the
reference's by tests/test_torch_copies.py.
"""

__version__ = "0.1.0"
