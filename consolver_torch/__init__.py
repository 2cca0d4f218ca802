"""PyTorch/CUDA port of consolver_tpu for NVIDIA Hopper GPUs."""
