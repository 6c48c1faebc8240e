"""PyTorch / CUDA port of ssr_speech_tpu for NVIDIA Hopper GPUs (see README).

Mirrors the JAX package module by module; never imports jax."""
