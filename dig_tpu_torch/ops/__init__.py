"""The port's kernel wrappers (`attention`, `layernorm`, `fused_dense`).

Each wrapper adds one to its `launches` attribute where it launches its
kernel on the card, and nowhere else; `launch_counts` reads them all."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from dig_tpu_torch.ops import attention, fused_dense, layernorm

    fns = (attention.attention_lse_fwd, attention.attention_lse_bwd, attention.attention_fwd,
           attention.attention_bwd, layernorm.layer_norm_fwd, layernorm.layer_norm_bwd,
           fused_dense.column_sum)
    return {fn.__name__: fn for fn in fns}


def launch_counts() -> dict:
    """The launch count of every kernel wrapper of the port."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
