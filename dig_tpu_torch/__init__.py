"""PyTorch + CUDA port of dig_tpu for NVIDIA Hopper (H100).

The JAX package `dig_tpu` is the reference; this package imports none of
it.  Slice 1 covers the batch-inference path (`dig_tpu_torch.cli.run_predict`).
"""
