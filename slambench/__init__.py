"""The benchmark of the PyTorch and CUDA port (`orbslam3_tpu_torch`): see README.md."""
