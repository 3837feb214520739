"""Fixtures of the benchmark's own tests.  They run on the CPU at tiny
sizes through the same harness, program files and references as a run on the
card; a test that needs the card is marked ``chip`` and decides inside a
fixture whether there is one."""

from __future__ import annotations

import pytest

from portbench_tiny import tiny_cell


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def cpu_runtime(monkeypatch):
    """The port's runtime on the CPU (Gloo), as its own tests run it."""
    monkeypatch.setenv("HVDTPU_PLATFORM", "cpu")
    yield
    import horovod_tpu_torch as hvd
    hvd.shutdown()


@pytest.fixture
def tiny():
    """``tiny(workload, **traffic)``: a cell cut to the test size."""
    return tiny_cell
