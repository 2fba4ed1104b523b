"""The launcher's remaining flags and the torch examples, against the JAX
package's launcher.

- ``config_parser.env_from_args`` on one ``Namespace`` and
  ``apply_config_file`` on one YAML file give both packages' environment,
  for every row the port shares; a config key whose feature the port lacks
  is refused before any worker starts.
- ``hosts.parse_host_files`` on one file.
- ``--output-filename`` writes ``DIR/rank.<r>/stdout`` and ``stderr`` and
  still echoes each line; the ``[r]<stdout>: `` prefix appears under
  ``-v`` only: the same lines as the JAX launcher gives, with ``sh``
  workers (fault C9).
- The three examples of ``examples/torch_port/`` at np=2 on the CPU at a
  tiny size: the synthetic benchmark (ResNet-50 at 32x32, batch 2, one
  iteration), the ImageNet script run twice so that the second resumes
  from the first's checkpoint, and Adasum BERT at 2 layers and s16; one
  job each, with a 60 s limit, each exiting 0 with its last line.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu.runner import config_parser as jax_config
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.runner import config_parser, hosts, launch

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch_port"
JOB_TIMEOUT = 60

# One value per row both packages share (each not 0: the JAX mapping drops
# a 0, the port keeps it, test_torch_response_cache.py).
_VALUES = {
    "fusion_threshold_mb": 2.5,
    "cycle_time_ms": 3.5,
    "cache_capacity": 512,
    "timeline_filename": "/tmp/tl.json",
    "timeline_mark_cycles": True,
    "no_stall_check": True,
    "stall_check_warning_time_seconds": 7,
    "stall_check_shutdown_time_seconds": 30,
    "log_level": "debug",
    "data_plane": "tcp",
}
_YAML_KEYS = {attr: key for attr, key, _, _ in config_parser._PARAMS}


def test_the_port_rows_are_jax_rows():
    theirs = {attr: (key, var) for attr, key, var, _ in jax_config._PARAMS}
    for attr, key, var, _ in config_parser._PARAMS:
        assert theirs[attr] == (key, var), attr
    assert set(_VALUES) == set(_YAML_KEYS)
    # Every JAX row is the port's or refused by it.
    for attr, (key, _) in theirs.items():
        assert attr in _YAML_KEYS or key in config_parser.UNSUPPORTED_KEYS


@pytest.mark.parametrize("attr", sorted(_VALUES))
def test_each_row_gives_the_jax_environment(attr):
    args = argparse.Namespace(**{attr: _VALUES[attr]})
    ours = config_parser.env_from_args(args)
    assert ours == jax_config.env_from_args(args) and len(ours) == 1


def test_one_namespace_gives_the_jax_environment():
    args = argparse.Namespace(**_VALUES)
    ours = config_parser.env_from_args(args)
    assert ours == jax_config.env_from_args(args)
    assert ours[env_mod.HOROVOD_FUSION_THRESHOLD] == str(int(2.5 * 2 ** 20))
    assert ours[env_mod.HOROVOD_TIMELINE_MARK_CYCLES] == "1"
    assert len(ours) == len(_VALUES)


def test_the_launchers_parse_the_shared_flags_alike():
    argv = ["-np", "2", "--fusion-threshold-mb", "8", "--cycle-time-ms",
            "2.5", "--cache-capacity", "16", "--timeline-filename", "t.json",
            "--timeline-mark-cycles", "--no-stall-check",
            "--stall-check-warning-time-seconds", "9",
            "--stall-check-shutdown-time-seconds", "4", "--log-level",
            "info", "--data-plane", "tcp", "-v", "--output-filename", "out",
            "--hostfile", "hf", "true"]
    ours = launch.build_parser().parse_args(argv)
    theirs = jax_launch.build_parser().parse_args(argv)
    assert launch.runtime_env(ours) == jax_config.env_from_args(theirs)
    for attr in ("verbose", "output_filename", "hostfile", "command"):
        assert getattr(ours, attr) == getattr(theirs, attr)


def _yaml(path: Path, values: dict) -> Path:
    import yaml

    path.write_text(yaml.safe_dump(
        {_YAML_KEYS[a]: v for a, v in values.items()}))
    return path


def test_a_config_file_gives_the_jax_environment(tmp_path):
    cfg = _yaml(tmp_path / "cfg.yaml", _VALUES)
    ours, theirs = argparse.Namespace(), argparse.Namespace()
    config_parser.apply_config_file(ours, str(cfg))
    jax_config.apply_config_file(theirs, str(cfg))
    assert vars(ours) == vars(theirs) == _VALUES
    assert config_parser.env_from_args(ours) == \
        jax_config.env_from_args(theirs)


def test_flags_win_over_the_config_file(tmp_path):
    cfg = _yaml(tmp_path / "cfg.yaml", _VALUES)
    argv = ["-np", "2", "--config-file", str(cfg), "--cycle-time-ms", "9",
            "--cache-capacity", "3", "true"]
    args = launch.build_parser().parse_args(argv)
    config_parser.apply_config_file(args, args.config_file)
    env = launch.runtime_env(args)
    assert env[env_mod.HOROVOD_CYCLE_TIME] == "9.0"
    assert env[env_mod.HOROVOD_CACHE_CAPACITY] == "3"
    assert env[env_mod.HOROVOD_TIMELINE] == "/tmp/tl.json"


@pytest.mark.parametrize("key,where", sorted(
    config_parser.UNSUPPORTED_KEYS.items()))
def test_a_config_key_the_port_lacks_is_refused_before_any_worker(
        tmp_path, capfd, key, where):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"{key}: 1\ncycle-time-ms: 2\n")
    marker = tmp_path / "started"
    code = launch.run_commandline(
        ["-np", "2", "--config-file", str(cfg), "sh", "-c",
         f"touch {marker}"])
    _, err = capfd.readouterr()
    assert code == 2 and not marker.exists()
    assert repr(key) in err and where in err


def test_a_config_file_without_pyyaml_raises_the_jax_text(tmp_path,
                                                          monkeypatch):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("cycle-time-ms: 2\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError) as ours:
        config_parser.apply_config_file(argparse.Namespace(), str(cfg))
    with pytest.raises(RuntimeError) as theirs:
        jax_config.apply_config_file(argparse.Namespace(), str(cfg))
    assert str(ours.value) == str(theirs.value)


_HOSTFILE = """# a comment
node1 slots=4
node2:2

node3   # one slot
node4 slots = 3
"""


def test_parse_host_files_is_the_jax_one(tmp_path):
    path = tmp_path / "hostfile"
    path.write_text(_HOSTFILE)
    ours = hosts.parse_host_files(str(path))
    assert ours == jax_hosts.parse_host_files(str(path))
    assert [vars(h) for h in hosts.parse_hosts(ours)] == \
        [vars(h) for h in jax_hosts.parse_hosts(ours)]


# ---------------------------------------------------------------------------
# the launchers with sh workers (fault C9)
# ---------------------------------------------------------------------------

_SH = ('echo "out $HOROVOD_RANK $HOROVOD_SIZE $HOROVOD_LOCAL_SIZE"; '
       'echo "err $HOROVOD_RANK" >&2; echo "two $HOROVOD_RANK"')


def _run_launcher(module: str, flags, out_dir: Path):
    argv = [sys.executable, "-m", module, "-np", "2", *flags,
            "--output-filename", str(out_dir)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(argv + ["sh", "-c", _SH], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=JOB_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    def lines(text):
        # The c10d store's own warnings are not the workers'.
        return sorted(line for line in text.splitlines()
                      if "out " in line or "err " in line or "two " in line)
    return lines(proc.stdout), lines(proc.stderr)


@pytest.mark.parametrize("flags", [[], ["-v"], ["--verbose"]],
                         ids=["plain", "v", "verbose"])
def test_the_rank_prefix_appears_under_verbose_only(tmp_path, flags):
    ours = _run_launcher("horovod_tpu_torch.runner.launch", flags,
                         tmp_path / "ours")
    theirs = _run_launcher("horovod_tpu.runner.launch", flags,
                           tmp_path / "theirs")
    assert ours == theirs
    out, err = ours
    if flags:
        assert out == sorted([f"[{r}]<stdout>: {w} {r}"
                              + (" 2 2" if w == "out" else "")
                              for r in range(2) for w in ("out", "two")])
        assert err == [f"[{r}]<stderr>: err {r}" for r in range(2)]
    else:
        assert out == sorted([f"{w} {r}" + (" 2 2" if w == "out" else "")
                              for r in range(2) for w in ("out", "two")])
        assert err == [f"err {r}" for r in range(2)]
    # The files hold the bare lines, whatever the flags.
    for r in range(2):
        for name in ("stdout", "stderr"):
            mine = (tmp_path / "ours" / f"rank.{r}" / name).read_text()
            assert mine == (tmp_path / "theirs" / f"rank.{r}"
                            / name).read_text()
        assert (tmp_path / "ours" / f"rank.{r}" / "stdout").read_text() == \
            f"out {r} 2 2\ntwo {r}\n"
        assert (tmp_path / "ours" / f"rank.{r}" / "stderr").read_text() == \
            f"err {r}\n"


def test_the_hostfile_stands_in_for_hosts(tmp_path, capfd):
    path = tmp_path / "hostfile"
    path.write_text("localhost slots=2\n")
    code = launch.run_commandline(
        ["-np", "2", "--hostfile", str(path), "-v", "sh", "-c",
         'echo "slots $HOROVOD_LOCAL_RANK/$HOROVOD_LOCAL_SIZE"'])
    out, _ = capfd.readouterr()
    assert code == 0
    for r in range(2):
        assert f"[{r}]<stdout>: slots {r}/2" in out


def test_the_new_flags_reach_every_rank(tmp_path, capfd):
    code = launch.run_commandline(
        ["-np", "2", "--fusion-threshold-mb", "0.5", "--cycle-time-ms", "4",
         "--timeline-filename", str(tmp_path / "tl.json"),
         "--timeline-mark-cycles", "--log-level", "debug", "sh", "-c",
         'echo "knobs $HOROVOD_RANK $HOROVOD_FUSION_THRESHOLD '
         '$HOROVOD_CYCLE_TIME $HOROVOD_TIMELINE '
         '$HOROVOD_TIMELINE_MARK_CYCLES $HOROVOD_LOG_LEVEL"'])
    out, _ = capfd.readouterr()
    assert code == 0
    for r in range(2):
        assert f"knobs {r} 524288 4.0 {tmp_path / 'tl.json'} 1 debug" in out


# ---------------------------------------------------------------------------
# the torch examples at np=2 on the CPU
# ---------------------------------------------------------------------------

def _example(script: str, *args: str) -> str:
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         sys.executable, str(EXAMPLES / script), "--device", "cpu", *args],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"{script} timed out after {JOB_TIMEOUT}s\n{stdout}\n"
                    f"{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    return stdout


@pytest.fixture(scope="module")
def synthetic():
    return _example("pytorch_synthetic_benchmark.py", "--image-size", "32",
                    "--batch-size", "2", "--num-warmup-batches", "1",
                    "--num-batches-per-iter", "1", "--num-iters", "1")


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("imagenet") / "checkpoint-{epoch}.pt"
    flags = ("--image-size", "32", "--batch-size", "2",
             "--synthetic-batches", "1", "--checkpoint-format", str(ckpt))
    first = _example("pytorch_imagenet_resnet50.py", "--epochs", "1",
                     *flags)
    second = _example("pytorch_imagenet_resnet50.py", "--epochs", "2",
                      *flags)
    return first, second, ckpt


@pytest.fixture(scope="module")
def bert():
    return _example("adasum_bert_pretraining.py", "--num-layers", "2",
                    "--seq-len", "16", "--steps", "6", "--batch-size", "4")


def test_the_synthetic_benchmark_prints_its_lines(synthetic):
    lines = synthetic.strip().splitlines()
    assert lines[0] == "Model: resnet50, batch size 2, ranks 2"
    assert lines[1].startswith("Iter #0: ") and \
        lines[1].endswith(" img/sec per rank")
    assert lines[-1].startswith("Total img/sec on 2 rank(s): ")
    per_rank = float(lines[-2].split()[-1])
    assert per_rank > 0 and float(lines[-1].split()[-1]) > per_rank


def test_the_imagenet_example_resumes_from_its_checkpoint(imagenet):
    first, second, ckpt = imagenet
    assert "resumed from epoch 0" in first and "epoch 0: loss " in first
    assert first.strip().splitlines()[-1] == "trained epochs 0..0"
    assert "resumed from epoch 1" in second
    assert "epoch 0:" not in second and "epoch 1: loss " in second
    assert second.strip().splitlines()[-1] == "trained epochs 1..1"
    for epoch in (1, 2):
        assert Path(str(ckpt).format(epoch=epoch)).exists()


def test_the_adasum_bert_example_trains(bert):
    lines = bert.strip().splitlines()
    assert lines[-1] == "ADASUM BERT DONE"
    losses = [float(line.split()[-1]) for line in lines
              if line.startswith("step ")]
    assert len(losses) == 2 and all(v > 0 for v in losses)
