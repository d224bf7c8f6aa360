"""One scratch fine-tuning arm of the validation study on the CPU, in either
package, for comparing the two over many epochs:

    python tests/_torch_port_scratch_arms.py {port,jax} CORPUS OUT EPOCHS [SEED]

CORPUS is a `gen_synth --easy --test_pool shared` output (its labeled/ and
test/ LMDBs).  The recipe is `tools/validation_study.sh`'s arm (batch 128,
lr 8e-4, warm-up 2 epochs, the CLI defaults for dropout and augmentation)
at the micro width, with one loader worker, so that both packages read the
same batches; their initial weights and dropout draws are their own, as in
the study.  Prints one line: RESULT, the package, the seed, the seconds and
[train loss, test word accuracy] per epoch from the CLI's log.txt."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(pkg, corpus, out, epochs, seed="0"):
    argv = ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder",
            "--data_path", os.path.join(corpus, "labeled"),
            "--eval_data_path", os.path.join(corpus, "test"),
            "--batch_size", "128", "--epochs", epochs, "--warmup_epochs", "2",
            "--num_workers", "1", "--lr", "8e-4", "--no_save_ckpt", "--output_dir", out,
            "--eval_freq", "0", "--seed", seed]
    t0 = time.time()
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from dig_tpu.cli.run_finetune import main as run
        from dig_tpu.config import FinetuneConfig, parse_config

        run(parse_config(FinetuneConfig, argv))
    else:
        import torch

        torch.set_num_threads(4)
        from dig_tpu_torch.cli.run_finetune import main as run
        from dig_tpu_torch.config import FinetuneConfig, parse_config

        run(parse_config(FinetuneConfig, argv), device="cpu")
    with open(os.path.join(out, "log.txt")) as f:
        rows = [json.loads(line) for line in f]
    print("RESULT", pkg, seed, round(time.time() - t0),
          json.dumps([[round(r["train_loss"], 3), round(r["val_acc"], 4)] for r in rows]))


if __name__ == "__main__":
    main(*sys.argv[1:])
