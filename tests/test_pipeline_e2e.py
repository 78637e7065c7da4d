"""End-to-end pipeline test over the CLI binaries on synthetic shards:

train -> validate -> convert -> finetune -> eval -> infer -> max_ensemble

the rebuild's version of the reference's five-binary bash pipeline
(run_train.sh .. run_eval.sh), on tiny dimensions.
"""

import glob
import os

import numpy as np
import pytest

from efficientvideoclassification_youtube8m_tpu.data import (
    write_synthetic_frame_shard,
)

TINY_FLAGS = [
    "--num_classes", "40",
    "--batch_size", "8",
    "--lstm_cells", "8",
    "--lstm_layers", "2",
    "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4",
    "--num_inputs_L1", "2",
    "--every_n", "2",
    "--feature_names", "rgb, audio",
    "--feature_sizes", "6, 2",
    "--num_readers", "2",
    "--compute_dtype", "float32",
    "--top_k", "5",
    "--scan_unroll", "1",
]


@pytest.fixture(scope="module")
def pipeline_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    data_dir = root / "data"
    data_dir.mkdir()
    for s in range(2):
        write_synthetic_frame_shard(
            str(data_dir / f"train-{s:04d}.tfrecord"), num_videos=12, seed=s,
            feature_names=("rgb", "audio"), feature_sizes=(6, 2),
            max_frames=40, vocab_size=40)
    write_synthetic_frame_shard(
        str(data_dir / "validate-0000.tfrecord"), num_videos=10, seed=9,
        feature_names=("rgb", "audio"), feature_sizes=(6, 2),
        max_frames=40, vocab_size=40)
    train_dir = str(root / "model_train") + "/"
    os.makedirs(train_dir, exist_ok=True)
    return {
        "root": root,
        "train_pattern": str(data_dir / "train-*.tfrecord"),
        "eval_pattern": str(data_dir / "validate-*.tfrecord"),
        "train_dir": train_dir,
    }


def test_01_train(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import train as train_cli

    train_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["train_dir"],
        "--train_data_pattern", pipeline_dirs["train_pattern"],
        "--num_epochs", "2",
        "--start_new_model", "true",
    ])
    from efficientvideoclassification_youtube8m_tpu.train import latest_checkpoint

    ckpt = latest_checkpoint(pipeline_dirs["train_dir"])
    assert ckpt is not None
    # 24 videos * 2 epochs / batch 8 = 6 batches -> global_step 12 (2/batch)
    assert ckpt.endswith("model.ckpt-12.msgpack")
    # event file written
    assert glob.glob(os.path.join(pipeline_dirs["train_dir"], "events.out.*"))


def test_01b_train_resume(pipeline_dirs):
    """Relaunching WITHOUT start_new_model resumes from the latest
    checkpoint (train.py:470-475 recover_model semantics)."""
    from efficientvideoclassification_youtube8m_tpu.cli import train as train_cli
    from efficientvideoclassification_youtube8m_tpu.train import latest_checkpoint

    train_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["train_dir"],
        "--train_data_pattern", pipeline_dirs["train_pattern"],
        "--num_epochs", "1",
    ])
    ckpt = latest_checkpoint(pipeline_dirs["train_dir"])
    # 12 (from the first run) + 24/8*2 more
    assert ckpt.endswith("model.ckpt-18.msgpack"), ckpt


def test_01c_train_shardmap(pipeline_dirs):
    """--use_shardmap_train drives the explicit-collectives step through
    the same CLI and produces the same checkpoint cadence."""
    from efficientvideoclassification_youtube8m_tpu.cli import train as train_cli
    from efficientvideoclassification_youtube8m_tpu.train import latest_checkpoint

    sm_dir = str(pipeline_dirs["root"] / "model_train_sm") + "/"
    train_cli.main(TINY_FLAGS + [
        "--train_dir", sm_dir,
        "--train_data_pattern", pipeline_dirs["train_pattern"],
        "--num_epochs", "1",
        "--start_new_model", "true",
        "--use_shardmap_train", "true",
    ])
    ckpt = latest_checkpoint(sm_dir)
    assert ckpt is not None and ckpt.endswith("model.ckpt-6.msgpack"), ckpt


def test_02_validate(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import validate as val_cli

    val_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["train_dir"],
        "--eval_data_pattern", pipeline_dirs["eval_pattern"],
        "--run_once", "true",
    ])


def test_02b_validate_steps_per_dispatch_identical(pipeline_dirs):
    """cli.validate --steps_per_dispatch K: identical epoch metrics to
    the per-batch loop (both towers run; L_REP rides the stacked
    output)."""
    from efficientvideoclassification_youtube8m_tpu.cli import validate as val_cli
    from efficientvideoclassification_youtube8m_tpu.metrics import eval_util

    captured = {}
    orig = eval_util.EvaluationMetrics.get

    def capture(self):
        data = orig(self)
        captured.setdefault("runs", []).append(data)
        return data

    eval_util.EvaluationMetrics.get = capture
    try:
        for steps in ("1", "3"):
            val_cli.main(TINY_FLAGS + [
                "--train_dir", pipeline_dirs["train_dir"],
                "--eval_data_pattern", pipeline_dirs["eval_pattern"],
                "--run_once", "true",
                "--steps_per_dispatch", steps,
            ])
    finally:
        eval_util.EvaluationMetrics.get = orig
    base, stacked = captured["runs"]
    for key in ("avg_hit_at_one", "avg_perr", "gap"):
        assert base[key] == stacked[key], (key, base[key], stacked[key])
    # avg_loss to f32-ulp tolerance: on CPU, XLA may vectorize the CE
    # reduction differently inside the scan body than in the standalone
    # step, so per-example losses can differ by an ulp for SOME weights
    # (rank metrics stay exact)
    np.testing.assert_allclose(base["avg_loss"], stacked["avg_loss"],
                               rtol=1e-6)
    np.testing.assert_array_equal(base["aps"], stacked["aps"])


def test_03_convert(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import convert as conv_cli

    conv_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["train_dir"],
    ])
    finetune_dir = pipeline_dirs["train_dir"].replace("train", "") + "finetune/"
    assert os.path.exists(os.path.join(finetune_dir, "model.ckpt-0.msgpack"))
    pipeline_dirs["finetune_dir"] = finetune_dir


def test_04_finetune(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import finetune as ft_cli

    ft_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["finetune_dir"],
        "--train_data_pattern", pipeline_dirs["train_pattern"],
        "--num_epochs", "1",
    ])
    from efficientvideoclassification_youtube8m_tpu.train import latest_checkpoint

    ckpt = latest_checkpoint(pipeline_dirs["finetune_dir"])
    # 24 videos / batch 8 = 3 batches -> student global_step 3 (1/batch)
    assert ckpt.endswith("model.ckpt-3.msgpack")


def test_05_eval(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import eval as eval_cli

    eval_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["finetune_dir"],
        "--eval_data_pattern", pipeline_dirs["eval_pattern"],
        "--run_once", "true",
    ])


def test_05b_eval_quantized_close_to_float(pipeline_dirs):
    """cli.eval --quantize int8 (the deploy-gate accuracy check) runs the
    full epoch machinery on the int8 forward and lands near the float
    epoch metrics."""
    from efficientvideoclassification_youtube8m_tpu.cli import eval as eval_cli
    from efficientvideoclassification_youtube8m_tpu.metrics import eval_util

    captured = {}
    orig = eval_util.EvaluationMetrics.get

    def capture(self):
        data = orig(self)
        captured.setdefault("runs", []).append(data)
        return data

    eval_util.EvaluationMetrics.get = capture
    try:
        for quant in ("none", "int8"):
            eval_cli.main(TINY_FLAGS + [
                "--train_dir", pipeline_dirs["finetune_dir"],
                "--eval_data_pattern", pipeline_dirs["eval_pattern"],
                "--run_once", "true",
                "--quantize", quant,
            ])
    finally:
        eval_util.EvaluationMetrics.get = orig
    base, quant = captured["runs"]
    assert abs(base["avg_hit_at_one"] - quant["avg_hit_at_one"]) <= 0.05
    assert abs(base["gap"] - quant["gap"]) <= 0.05
    assert np.isfinite(quant["avg_loss"])


def test_05d_eval_quantized_stacked_identical(pipeline_dirs):
    """--quantize int8 composed with --steps_per_dispatch K: the stacked
    int8 program must give EXACTLY the per-batch int8 loop's epoch
    metrics (the deploy-gate check is valid at any dispatch batching)."""
    from efficientvideoclassification_youtube8m_tpu.cli import eval as eval_cli
    from efficientvideoclassification_youtube8m_tpu.metrics import eval_util

    captured = {}
    orig = eval_util.EvaluationMetrics.get

    def capture(self):
        data = orig(self)
        captured.setdefault("runs", []).append(data)
        return data

    eval_util.EvaluationMetrics.get = capture
    try:
        for steps in ("1", "3"):
            eval_cli.main(TINY_FLAGS + [
                "--train_dir", pipeline_dirs["finetune_dir"],
                "--eval_data_pattern", pipeline_dirs["eval_pattern"],
                "--run_once", "true",
                "--quantize", "int8",
                "--steps_per_dispatch", steps,
            ])
    finally:
        eval_util.EvaluationMetrics.get = orig
    base, stacked = captured["runs"]
    for key in ("avg_hit_at_one", "avg_perr", "gap"):
        assert base[key] == stacked[key], (key, base[key], stacked[key])
    # avg_loss to f32-ulp tolerance: on CPU, XLA may vectorize the CE
    # reduction differently inside the scan body than in the standalone
    # step, so per-example losses can differ by an ulp for SOME weights
    # (rank metrics stay exact)
    np.testing.assert_allclose(base["avg_loss"], stacked["avg_loss"],
                               rtol=1e-6)
    np.testing.assert_array_equal(base["aps"], stacked["aps"])


def test_05c_eval_steps_per_dispatch_identical(pipeline_dirs):
    """--steps_per_dispatch K (the stacked K-batches-per-launch eval)
    must give EXACTLY the per-batch loop's epoch metrics — including the
    partial final stack (10 videos / batch 8 = 2 batches; K=3 pads the
    stack with a dummy batch whose slice is never read)."""
    from efficientvideoclassification_youtube8m_tpu.cli import eval as eval_cli
    from efficientvideoclassification_youtube8m_tpu.metrics import eval_util

    captured = {}
    orig = eval_util.EvaluationMetrics.get

    def capture(self):
        data = orig(self)
        captured.setdefault("runs", []).append(data)
        return data

    eval_util.EvaluationMetrics.get = capture
    try:
        for steps in ("1", "3"):
            eval_cli.main(TINY_FLAGS + [
                "--train_dir", pipeline_dirs["finetune_dir"],
                "--eval_data_pattern", pipeline_dirs["eval_pattern"],
                "--run_once", "true",
                "--steps_per_dispatch", steps,
            ])
    finally:
        eval_util.EvaluationMetrics.get = orig
    base, stacked = captured["runs"]
    for key in ("avg_hit_at_one", "avg_perr", "gap"):
        assert base[key] == stacked[key], (key, base[key], stacked[key])
    # avg_loss to f32-ulp tolerance: on CPU, XLA may vectorize the CE
    # reduction differently inside the scan body than in the standalone
    # step, so per-example losses can differ by an ulp for SOME weights
    # (rank metrics stay exact)
    np.testing.assert_allclose(base["avg_loss"], stacked["avg_loss"],
                               rtol=1e-6)
    np.testing.assert_array_equal(base["aps"], stacked["aps"])


def test_06_infer_and_bias(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import infer as infer_cli
    from efficientvideoclassification_youtube8m_tpu.ensemble import read_pred_file

    out_csv = str(pipeline_dirs["root"] / "preds_a.csv")
    infer_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["finetune_dir"],
        "--input_data_pattern", pipeline_dirs["eval_pattern"],
        "--output_file", out_csv,
    ])
    preds = read_pred_file(out_csv)
    assert len(preds) == 10
    labels, probs = next(iter(preds.values()))
    assert len(labels) == 5 and len(probs) == 5
    assert all(0 <= p <= 1 for p in probs)
    assert probs == sorted(probs, reverse=True)

    # bias-rescaled variant (inference_bias.py semantics)
    out_csv_b = str(pipeline_dirs["root"] / "preds_b.csv")
    infer_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["finetune_dir"],
        "--input_data_pattern", pipeline_dirs["eval_pattern"],
        "--output_file", out_csv_b,
        "--tensor_name", "classifier/experts/b",
        "--alpha_bias", "2.0",
    ])
    preds_b = read_pred_file(out_csv_b)
    assert len(preds_b) == 10
    pipeline_dirs["csv_a"] = out_csv
    pipeline_dirs["csv_b"] = out_csv_b


def test_06c_infer_steps_per_dispatch(pipeline_dirs):
    """cli.infer --steps_per_dispatch K builds rows from the device
    top-k out of the stacked packed buffer: per-video {label: prob}
    must equal the K=1 (full-predictions, host argpartition) CSV —
    ordering may legitimately differ only on exact probability ties."""
    from efficientvideoclassification_youtube8m_tpu.cli import infer as infer_cli
    from efficientvideoclassification_youtube8m_tpu.ensemble import read_pred_file

    out_csv = str(pipeline_dirs["root"] / "preds_stacked.csv")
    infer_cli.main(TINY_FLAGS + [
        "--train_dir", pipeline_dirs["finetune_dir"],
        "--input_data_pattern", pipeline_dirs["eval_pattern"],
        "--output_file", out_csv,
        "--steps_per_dispatch", "3",
    ])
    base = read_pred_file(pipeline_dirs["csv_a"])
    stacked = read_pred_file(out_csv)
    assert base.keys() == stacked.keys()
    for vid in base:
        bl, bp = base[vid]
        sl, sp = stacked[vid]
        assert dict(zip(bl, bp)) == dict(zip(sl, sp)), vid


def test_07_max_ensemble(pipeline_dirs):
    from efficientvideoclassification_youtube8m_tpu.cli import (
        max_ensemble as me_cli,
    )
    from efficientvideoclassification_youtube8m_tpu.ensemble import read_pred_file

    out_csv = str(pipeline_dirs["root"] / "ensembled.csv")
    me_cli.main([
        "--preds_pattern", str(pipeline_dirs["root"] / "preds_*.csv"),
        "--output_file", out_csv,
        "--num_classes", "40",
        "--top_k", "5",
    ])
    merged = read_pred_file(out_csv)
    a = read_pred_file(pipeline_dirs["csv_a"])
    b = read_pred_file(pipeline_dirs["csv_b"])
    assert set(merged) == set(a)
    # per-label max property on one video
    vid = next(iter(merged))
    dense = {}
    for src in (a, b):
        for c, p in zip(*src[vid]):
            dense[c] = max(dense.get(c, 0.0), p)
    for c, p in zip(*merged[vid]):
        np.testing.assert_allclose(p, dense[c], rtol=1e-5)


def test_08_inspect_checkpoint(pipeline_dirs, capsys):
    from efficientvideoclassification_youtube8m_tpu.cli import (
        inspect_checkpoint as ic_cli,
    )
    from efficientvideoclassification_youtube8m_tpu.train import latest_checkpoint

    ic_cli.main(["--file_name", latest_checkpoint(pipeline_dirs["finetune_dir"])])
    out = capsys.readouterr().out
    assert "params_student/classifier" in out
    assert "global_step" in out


def test_08b_inspect_checkpoint_orbax(tmp_path, capsys):
    """Orbax checkpoint DIRECTORIES inspect the same way as msgpack
    files (restored template-free to the raw host pytree)."""
    from efficientvideoclassification_youtube8m_tpu.cli import (
        inspect_checkpoint as ic_cli,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        latest_checkpoint,
        save_checkpoint,
    )

    state = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
             "global_step": np.int64(7)}
    save_checkpoint(str(tmp_path), state, 7, backend="orbax")
    ic_cli.main(["--file_name", latest_checkpoint(str(tmp_path))])
    out = capsys.readouterr().out
    assert "params/w" in out and "[2, 3]" in out
    assert "global_step" in out
