"""chip_smoke.py's phases at tiny widths on the CPU, and its refusal to
run without a GPU. What only the card can show (flagship compile, memory,
the golden-log band at batch 256, the GPU numerics) runs in chip_smoke.py
itself on the card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = cs.Widths(
    feature_sizes=(6, 2), lstm_cells=8, max_num_frames=40,
    num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2, num_classes=40,
    batch_size=8, train_videos=16, heldout_videos=11, serve_requests=(8, 3),
    numerics_batch=4, four_card_batch=8, golden=False,
)


@pytest.fixture(scope="module")
def clock():
    c = cs.CompileClock()
    yield c
    c.close()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory, clock):
    workdir = str(tmp_path_factory.mktemp("smoke"))
    return cs.phase_pipeline(workdir, TINY, clock)


def test_pipeline_phase(pipeline, capsys):
    finetune_dir, heldout = pipeline
    assert os.path.isdir(finetune_dir)
    assert len(heldout) == TINY.heldout_videos


def test_serve_phase_bf16_and_int8(pipeline, clock, capsys):
    cs.phase_serve(*pipeline, TINY, clock)
    out = capsys.readouterr().out
    assert "int8 vs bf16 max |dprob|" in out
    assert "serve int8 request of 3" in out
    assert "FAIL" not in out


def test_numerics_phase(clock, capsys):
    cs.phase_numerics(TINY, clock)
    out = capsys.readouterr().out
    assert "worst per-leaf cosine" in out and "FAIL" not in out


def test_snapshot_phase(tmp_path, clock, capsys):
    mode = cs.phase_snapshot(str(tmp_path), TINY, clock)
    # XLA:CPU has no pinned_host placement; the in-HBM copy is taken
    assert mode in ("host", "hbm")


def test_four_card_phase_on_virtual_devices(clock, capsys):
    """The --four-cards comparisons on 4 of the virtual CPU devices."""
    cs.phase_four_cards(TINY, clock)
    out = capsys.readouterr().out
    assert "MoE head is sharded over 'model'" in out
    assert "FAIL" not in out


def test_check_raises_on_failure(capsys):
    cs.check(True, "fine")
    with pytest.raises(cs.SmokeFailure):
        cs.check(False, "broken")
    assert "[FAIL] broken" in capsys.readouterr().out


def test_widths_config_uses_cli_defaults():
    cfg = cs.FLAGSHIP.config()
    assert cfg.compute_dtype == "bfloat16"  # the CLI default
    assert (cfg.num_classes, cfg.lstm_cells, cfg.max_num_frames) == (
        4716, 1024, 300)
    assert cfg.total_feature_size == 1152
    assert cs.FLAGSHIP.config(compute_dtype="float32").compute_dtype == (
        "float32")


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("flag", [[], ["--four-cards"]])
def test_exits_nonzero_without_gpu(flag):
    r = _run([os.path.join(REPO, "chip_smoke.py"), *flag], cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    """Copied out of the repo, the script cannot import the program and
    must fail rather than print a result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path),
             env_extra={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
