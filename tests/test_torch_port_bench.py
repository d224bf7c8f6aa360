"""bench_torch.py on the CPU at the micro width: each of bench.py's four
modes through `main(device="cpu")` prints one JSON line with bench.py's
keys (plus "device"), its FLOPs from `utils/flops.py`; two gloo ranks
(tests/_torch_port_ranks.py) run the data-parallel steps and rank 0 alone
prints; run as a script without a card it exits non-zero and prints no
result.  Times and rates here are the CPU's and mean nothing."""

import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_port_ranks as ranks
import bench_torch
from dig_tpu_torch.utils.flops import (
    FinetuneShape,
    PretrainShape,
    finetune_step_flops,
    pretrain_step_flops,
)
from dig_tpu_torch.utils.profiling import busy_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_port_bench_worker.py")
KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
MODE_KEYS = {
    "pretrain": KEYS | {"step_ms", "mfu", "step_tflops", "breakdown_ms"},
    "finetune": KEYS | {"step_ms", "mfu", "step_tflops"},
    "eval": KEYS,
    "input": KEYS | {"host_cores", "workers", "pretrain_seqclr_aug", "finetune_abi_aug",
                     "finetune_plain", "per_core", "device_demand_pretrain", "worker_sweep"},
}
METRICS = {"pretrain": "pretrain_imgs_per_sec_per_chip",
           "finetune": "finetune_imgs_per_sec_per_chip",
           "eval": "eval_greedy_imgs_per_sec_per_chip", "input": "input_host_imgs_per_sec"}
BREAKDOWN = {"student_fwd", "key_fwd", "step_device", "bwd_opt", "dispatch"}
MICRO_PRE = PretrainShape(depth=2, width=64, heads=2)
MICRO_FT = FinetuneShape(depth=2, width=64, heads=2, dec_layers=6)
PEAK = 0.5  # TFLOP/s, so that the CPU's mfu is a number to check
BASELINES = {"pretrain": bench_torch.A100_BASELINE_IMGS_PER_SEC,
             "finetune": bench_torch.A100_FINETUNE_BASELINE_IMGS_PER_SEC,
             "eval": bench_torch.A100_EVAL_BASELINE_IMGS_PER_SEC}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(monkeypatch, mode, batch=2):
    model = ("pretrain_simmim_moco_ori_vit_micro_patch4_32x128" if mode in ("pretrain", "input")
             else "vit_micro_patch4_32x128")
    for k, v in dict(BENCH_MODE=mode, BENCH_MODEL=model, BENCH_BATCH=str(batch),
                     BENCH_STEPS="2", BENCH_PEAK_TFLOPS=str(PEAK), BENCH_INPUT_SAMPLES="24",
                     BENCH_WORKERS="2", BENCH_INPUT_SWEEP="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_DATA", raising=False)
    monkeypatch.delenv("BENCH_BREAKDOWN", raising=False)


def _one_line(text):
    lines = text.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("mode", ["pretrain", "finetune", "eval", "input"])
def test_mode_prints_bench_keys(mode, monkeypatch, capsys):
    _env(monkeypatch, mode, batch=4 if mode == "input" else 2)
    assert bench_torch.main("cpu") == 0
    captured = capsys.readouterr()
    line = _one_line(captured.out)
    assert set(line) == MODE_KEYS[mode]
    assert line["metric"] == METRICS[mode] and line["device"] == "cpu"
    assert line["value"] > 0
    if mode in BASELINES:
        assert line["vs_baseline"] == round(line["value"] / BASELINES[mode], 3)
    else:
        # both printed rounded to 0.01: a small demand (the CPU's) moves the quotient
        assert line["vs_baseline"] == pytest.approx(
            line["value"] / line["device_demand_pretrain"], rel=1e-2)
    assert "bench_torch: launches per step" in captured.err
    if mode == "pretrain":
        flops = pretrain_step_flops(MICRO_PRE, 2)
        parts = line["breakdown_ms"]
        assert set(parts) == BREAKDOWN
        assert parts["student_fwd"] + parts["key_fwd"] + parts["bwd_opt"] == pytest.approx(
            parts["step_device"], abs=0.011)
    if mode == "finetune":
        flops = finetune_step_flops(MICRO_FT, 2)
    if mode in ("pretrain", "finetune"):
        assert line["step_tflops"] == round(flops / 1e12, 3)
        want = flops / (line["step_ms"] / 1e3) / (PEAK * 1e12)
        assert line["mfu"] == pytest.approx(want, rel=0.01, abs=1e-4)
    if mode == "input":
        assert set(line["worker_sweep"]) == {f"{w}_{n}" for w in ("thread", "process")
                                             for n in (1, 2, 4, 8)}


def test_unknown_card_leaves_mfu_out(monkeypatch, capsys):
    _env(monkeypatch, "finetune")
    monkeypatch.delenv("BENCH_PEAK_TFLOPS")
    assert bench_torch.main("cpu") == 0
    captured = capsys.readouterr()
    line = _one_line(captured.out)
    assert "mfu" not in line and "step_tflops" not in line
    assert "no peak known" in captured.err


def test_script_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("mode", ["pretrain", "finetune"])
def test_two_gloo_ranks_print_one_line(mode, tmp_path):
    """Two ranks, batch 2 each, through the port's data-parallel step:
    rank 0 prints one line whose FLOPs are the global batch's (4)."""
    out = ranks.finish(mode, tmp_path, ranks.start(mode, tmp_path, 2, worker=WORKER),
                       worker=WORKER)
    assert [r["rc"] for r in out] == [0, 0]
    assert out[1]["stdout"] == ""
    line = _one_line(out[0]["stdout"])
    assert set(line) == MODE_KEYS[mode]
    flops = (pretrain_step_flops(MICRO_PRE, 4) if mode == "pretrain"
             else finetune_step_flops(MICRO_FT, 4))
    assert line["step_tflops"] == round(flops / 1e12, 3)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10), (5, 20), (30, 40), (40, 41)], 0.031),
    ([(5, 6), (0, 100), (20, 30)], 0.1),
], ids=["none", "overlapping_and_touching", "nested"])
def test_busy_time_is_the_union_of_kernel_intervals(intervals, want):
    """breakdown_ms's busy time: overlapping kernels count once (us in, ms out)."""
    assert busy_ms(intervals) == pytest.approx(want)
