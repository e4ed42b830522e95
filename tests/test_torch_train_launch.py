"""The port's training launcher and example on the CPU.

``python -m repro_torch.launch.train --device cpu --reduced`` holds the
contract of the reference's ``tests/test_launcher_resume.py`` (run 10 of
20 steps, rerun the same command with the full horizon: it resumes from
step 10, logs no step below 10 and writes ``step_20``); a mesh larger
than the world is refused, whatever the config; the example's presets
are the reference's and its demo trains.
"""

import dataclasses
import os
import re
import subprocess
import sys
import time

import pytest

from repro_torch.launch import train as launch
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=timeout)


def test_train_resumes_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--arch", "qwen3-0.6b", "--reduced",
              "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt,
              "--ckpt-every", "5", "--log-every", "5", "--lr", "1e-3"]
    t0 = time.perf_counter()
    out1 = _run([*common, "--steps", "10"])
    assert out1.returncode == 0, out1.stderr[-2000:]
    assert os.path.isdir(os.path.join(ckpt, "step_10"))
    assert "resumed" not in out1.stdout
    out2 = _run([*common, "--steps", "20"])
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "resumed from step 10" in out2.stdout
    steps = [int(m) for m in re.findall(r"step=\s*(\d+)", out2.stdout)]
    assert steps and min(steps) >= 10, "restarted instead of resuming"
    assert os.path.isdir(os.path.join(ckpt, "step_20"))
    assert sorted(os.listdir(ckpt)) == ["step_10", "step_15", "step_20"]
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hymba-1.5b",
                                  "xlstm-1.3b"])
def test_multi_device_is_refused(arch):
    """What a mesh still refuses: a mesh larger than the world, before any
    process group is made, whatever the config (every kind splits over a
    model axis: tensor parallelism over ``--mesh DxM`` is
    ``tests/test_torch_dist_tp.py``, data parallelism over ``--mesh Dx1``
    ``tests/test_torch_dist_train.py``)."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="needs a world of 4 ranks"):
        launch.main(["--device", "cpu", "--reduced", "--steps", "1",
                     "--arch", arch, "--mesh", "1x4"])
    assert not dist.is_initialized()


def test_one_by_one_mesh_runs(capsys):
    launch.main(["--device", "cpu", "--reduced", "--steps", "2", "--batch",
                 "2", "--seq", "16", "--mesh", "1x1", "--microbatches", "2",
                 "--compress-grads", "--log-every", "1"])
    out = capsys.readouterr().out
    assert re.findall(r"step=\s*(\d+)", out) == ["0", "1"]
    assert "[train] done" in out


def test_example_presets_are_the_references():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import train_lm as ref_example
    finally:
        sys.path.pop(0)
    from repro_torch.examples import train_lm

    for name in ("demo", "full"):
        got, got_hp = train_lm.preset(name)
        want, want_hp = ref_example.preset(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got_hp == want_hp


def test_example_demo_trains(tmp_path, capsys):
    from repro_torch.examples import train_lm

    rc = train_lm.main(["--device", "cpu", "--steps", "12", "--ckpt-dir",
                        str(tmp_path)])
    out = capsys.readouterr().out
    first, last = (float(v) for v in re.search(
        r"loss (\d+\.\d+) -> (\d+\.\d+)", out).groups())
    assert rc == (0 if last < first - 0.5 else 1)
    assert last < first
