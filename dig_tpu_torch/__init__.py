"""PyTorch + CUDA port of dig_tpu for NVIDIA Hopper (H100).

The JAX package `dig_tpu` is the reference; this package imports none of
it.  Its entry points are the CLIs `dig_tpu_torch.cli.run_predict`,
`run_pretrain` and `run_finetune` (every recognizer kind of `dig_tpu`, one
card a process, data-parallel under torchrun); the hand-written CUDA
kernels that replace the JAX package's Pallas kernels live in
`dig_tpu_torch/ops/csrc/`.
"""
