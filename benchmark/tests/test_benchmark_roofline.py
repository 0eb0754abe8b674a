"""The roofline's counts against shapes worked by hand."""

import pytest
import torch

from benchmark import roofline


def test_search_work_by_hand():
    # 3 partitions of 10, 20 and 30 vectors, D 4, k 2; two queries probing
    # (0, 1) and (1, 1): partition 2 is not read.
    probes = torch.tensor([[0, 1], [1, 1]])
    sizes = torch.tensor([10, 20, 30])
    flops, nbytes = roofline.search_work(probes, sizes, d=4, k=2, codes="f32")
    # pairs 10 + 20 + 20 + 20 = 70; parent 2 queries x 3 centroids.
    assert flops == 2 * 4 * 70 + 2 * 4 * 2 * 3
    # rows read once: 30 x (16 + 4); centroids 3 x 16; queries 2 x 16;
    # results 2 x 2 x 8.
    assert nbytes == 30 * 20 + 3 * 16 + 2 * 16 + 2 * 2 * 8
    _, nb16 = roofline.search_work(probes, sizes, d=4, k=2, codes="bf16")
    assert nb16 == 30 * (8 + 4) + 3 * 16 + 2 * 16 + 2 * 2 * 8


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert roofline.bound_seconds(495e12, 0, "f32") == pytest.approx(1.0)
    assert roofline.bound_seconds(989e12, 0, "bf16") == pytest.approx(1.0)
    assert roofline.bound_seconds(0, 3.35e12, "f32") == pytest.approx(1.0)
    assert roofline.bound_seconds(495e12, 6.7e12, "f32") == pytest.approx(2.0)


def test_headline_batch_bound():
    # The f32 cell's batch: 16,384 queries, nprobe 9, 160 partitions of
    # 6,250: 0.478 ms of operations at the TF32 rate, bytes 0.154 ms.
    probes = torch.arange(16384 * 9).reshape(16384, 9) % 160
    sizes = torch.full((160,), 6250)
    flops, nbytes = roofline.search_work(probes, sizes, d=128, k=10, codes="f32")
    assert flops / 495e12 == pytest.approx(4.78e-4, rel=1e-2)
    assert nbytes / 3.35e12 == pytest.approx(1.56e-4, rel=2e-2)
    assert roofline.bound_seconds(flops, nbytes, "bf16") == pytest.approx(flops / 989e12)
