"""Config / flag-surface tests."""

import pytest

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.utils.config import (
    TrainConfig,
    parse_feature_csv,
)


def test_parse_feature_csv():
    names, sizes = parse_feature_csv("rgb, audio", "1024, 128")
    assert names == ["rgb", "audio"]
    assert sizes == [1024, 128]
    with pytest.raises(ValueError):
        parse_feature_csv("rgb", "1024, 128")


def test_config_defaults_match_reference():
    cfg = TrainConfig()
    # reference defaults (train.py:27-99, frame_level_models.py:16-47)
    assert cfg.batch_size == 256
    assert cfg.num_classes == 4716
    assert cfg.lstm_cells == 1024
    assert cfg.max_num_frames == 300
    assert cfg.num_inputs_to_lstm == 20
    assert cfg.moe_num_mixtures == 2
    assert cfg.label_loss == "CrossEntropyLoss"
    assert cfg.optimizer == "AdamOptimizer"
    assert cfg.clip_gradient_norm == 1.0
    assert cfg.video_level_classifier_model == "MoeModel"
    assert cfg.total_feature_size == 1152
    assert cfg.max_frames_student == 30


def test_reference_run_script_flags_parse():
    """The exact flag set of run_train.sh must parse."""
    parser = flags_lib.base_parser("t")
    args = parser.parse_args([
        "--train_data_pattern", "./yt8m/train*.tfrecord",
        "--train_dir", "./model_HLSTM_TeaStud_every10_train/",
        "--frame_features", "True",
        "--feature_names", "rgb, audio",
        "--feature_sizes", "1024, 128",
        "--model", "HierarchicalLstmModel",
        "--gpu", "0",
        "--batch_size", "256",
        "--num_inputs_to_lstm", "20",
        "--lstm_layers", "2",
        "--start_new_model", "True",
        "--num_epochs", "1",
        "--every_n", "10",
    ])
    cfg = flags_lib.config_from_args(args)
    assert cfg.every_n == 10
    assert cfg.lstm_layers == 2
    assert args.start_new_model is True
    assert cfg.model == "HierarchicalLstmModel"


def test_flag_surface_covers_reference_union():
    """Every flag name from the reference's DEFINE_* blocks resolves."""
    parser = flags_lib.base_parser("t")
    reference_flags = [
        "train_dir", "train_data_pattern", "eval_data_pattern",
        "input_data_pattern", "feature_names", "feature_sizes",
        "frame_features", "model", "start_new_model", "bagging",
        "batch_size", "every_n", "label_loss", "dropout",
        "regularization_penalty", "base_learning_rate",
        "learning_rate_decay", "learning_rate_decay_examples", "num_epochs",
        "num_readers", "optimizer", "gpu", "clip_gradient_norm",
        "log_device_placement", "iterations", "dbof_add_batch_norm",
        "sample_random_frames", "dbof_cluster_size", "dbof_hidden_size",
        "dbof_pooling_method", "video_level_classifier_model", "lstm_cells",
        "lstm_layers", "max_num_frames", "num_inputs_to_lstm",
        "moe_num_mixtures", "num_hidden_units", "top_k", "run_once",
        # vestigial import-time flags (frame_level_models.py:20-46)
        "ppfs_normalize", "input_features", "a_rate", "num_conv2d_layers",
        "filter_size", "att_hid_size",
    ]
    known = {a.dest for a in parser._actions}
    missing = [f for f in reference_flags if f not in known]
    assert not missing, missing


def test_hash_check_cli(tmp_path, capsys):
    """hash_check verifies md5s against a JSON manifest and prints
    re-download commands for bad/missing shards
    (hash_check_redownload.py:9-18; commands printed, not run — no egress)."""
    import hashlib
    import json

    from efficientvideoclassification_youtube8m_tpu.cli import hash_check

    good = tmp_path / "train-0.tfrecord"
    good.write_bytes(b"good shard bytes")
    bad = tmp_path / "train-1.tfrecord"
    bad.write_bytes(b"corrupted")
    manifest = {
        "train-0.tfrecord": hashlib.md5(b"good shard bytes").hexdigest(),
        "train-1.tfrecord": hashlib.md5(b"original bytes").hexdigest(),
        "train-2.tfrecord": "0" * 32,  # missing
    }
    mpath = tmp_path / "manifest.json"
    mpath.write_text(json.dumps(manifest))

    rc = hash_check.main([
        "--manifest", str(mpath), "--data_dir", str(tmp_path),
        "--redownload_base", "http://example.com/yt8m",
    ])
    out = capsys.readouterr().out
    assert rc == 1
    assert "MISMATCH train-1.tfrecord" in out
    assert "MISSING train-2.tfrecord" in out
    assert "curl -O http://example.com/yt8m/train-1.tfrecord" in out
    assert "1/3 shards OK" in out

    # all-good manifest -> rc 0
    ok_manifest = tmp_path / "ok.json"
    ok_manifest.write_text(json.dumps(
        {"train-0.tfrecord": manifest["train-0.tfrecord"]}))
    rc = hash_check.main([
        "--manifest", str(ok_manifest), "--data_dir", str(tmp_path),
    ])
    assert rc == 0
    assert "1/1 shards OK" in capsys.readouterr().out


def test_resolve_steps_per_dispatch_auto_rule():
    """--steps_per_dispatch 0 = auto: one batch per launch on every
    backend; explicit values win and are written back onto args."""
    import argparse

    from efficientvideoclassification_youtube8m_tpu.cli import flags as fl

    def ns(k):
        return argparse.Namespace(steps_per_dispatch=k)

    a = ns(0)
    assert fl.resolve_steps_per_dispatch(a) == 1
    assert a.steps_per_dispatch == 1
    # explicit always wins
    assert fl.resolve_steps_per_dispatch(ns(5)) == 5
    assert fl.resolve_steps_per_dispatch(ns(1)) == 1
    # a namespace without the flag (binaries that do not register it)
    assert fl.resolve_steps_per_dispatch(argparse.Namespace()) == 1


def test_resolve_steps_per_dispatch_negative_clamps_to_one():
    """Explicit negative values clamp to per-batch dispatch (the pre-auto
    max(1, k) behavior)."""
    import argparse

    from efficientvideoclassification_youtube8m_tpu.cli import flags as fl

    a = argparse.Namespace(steps_per_dispatch=-1)
    assert fl.resolve_steps_per_dispatch(a) == 1
    assert a.steps_per_dispatch == 1
