"""The benchmark of the PyTorch and CUDA port (`video_encoder_tpu_torch`):
run.py runs one cell; README.md says how it is laid out and extended."""
