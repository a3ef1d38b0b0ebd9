"""Shared pieces of the benchmark's CPU tests: the tiny cells of
``data/BENCHMARK.json`` (the real configurations' shapes, cut to run on a
CPU in a second)."""

from pathlib import Path

import pytest

from portbench import spec

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(name: str) -> spec.Cell:
    return spec.load_cell(name, DATA / "BENCHMARK.json", DATA)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")
