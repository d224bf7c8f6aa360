"""PyTorch + CUDA port of dig_tpu for NVIDIA Hopper (H100).

The JAX package `dig_tpu` is the reference; this package imports none of
it.  Slice 1 covers the batch-inference path (`dig_tpu_torch.cli.run_predict`),
slice 2 one pre-training step (`dig_tpu_torch.train.pretrain.make_pretrain_step`),
slice 3 the JAX package's opt-in kernels and the recognizer's fine-tuning
and eval steps (`dig_tpu_torch.train.finetune`).
"""
