"""The benchmark of the PyTorch/CUDA port (``kubernetes_tpu_torch``); see README.md."""
