"""Shared fixture and helper of the ``tests/test_torch_*.py`` files of the
PyTorch port."""

import os
import signal
import subprocess

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel workers on a few cores: keep
    PyTorch's CPU kernels to one thread so these small tests do not starve
    the timing-sensitive multi-process tests running beside them."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def run_job(cmd, timeout: float, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run(cmd, capture_output=True, text=True,
    timeout=timeout)`` for a launcher, in a session of its own: the whole
    process group (the launcher and every worker it spawned) is killed once
    the launcher ends or times out, so that no worker outlives the test."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kwargs)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.returncode is None:
            proc.communicate()
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)
