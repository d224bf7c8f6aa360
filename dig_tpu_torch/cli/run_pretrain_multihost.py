"""Multi-host pre-training launcher.

Counterpart of `dig_tpu/cli/run_pretrain_multihost.py` (reference:
run_mae_pretraining_moco_multiMachine.py:542-552, one process per GPU with
a tcp:// rendezvous).  It creates the process group from the launcher's
variables (torchrun's RANK / WORLD_SIZE / LOCAL_RANK with MASTER_ADDR /
MASTER_PORT, or Open MPI's or SLURM's with MASTER_ADDR / MASTER_PORT set
by the job), names each rank once, runs
`dig_tpu_torch.cli.run_pretrain.main` in that group (its stdout on rank 0
only) and tears the group down.  Launch on each host, one process per
card:

    torchrun --nnodes 2 --node_rank <host> --nproc_per_node 8 \
        --master_addr host0 --master_port 29500 \
        -m dig_tpu_torch.cli.run_pretrain_multihost --flags...
"""

from __future__ import annotations

from dig_tpu_torch.cli import run_pretrain
from dig_tpu_torch.config import PretrainConfig, parse_config
from dig_tpu_torch.parallel.dist import destroy, init_distributed_mode


def main(cfg: PretrainConfig, device="cuda"):
    info = init_distributed_mode(device)
    try:
        print(f"multi-host pretrain: rank {info['rank']} of {info['world_size']} "
              f"({info['device']}, {info['backend'] or 'one process'})", flush=True)
        return run_pretrain.main(cfg, device)  # which prints on rank 0 only
    finally:
        if info["created"]:
            destroy()


if __name__ == "__main__":
    main(parse_config(PretrainConfig))
