"""``correct`` comes out false when the timed path is broken underneath a
run (the chip's check skipped, everything else of a run driven as it is),
once for each fault a training cell can have: a step that returns its
state unchanged, and half of the batch left out with the mean taken over
the rest. The cells hold one chip, so no exchange between chips can be
left out. On a tiny graph in float32 a sound run passes the cell's own
limits."""

import pytest
import torch

from portbench import harness

CELLS = ["gcn-reddit.train", "sage-reddit.train", "gcn-reddit.seeds4"]


@pytest.fixture
def f32_cell(tiny_root):
    """The cell on the tiny graph in float32, where a sound run reads
    rounding: its own limits then part sound runs from broken ones."""
    return lambda cell: tiny_root(cell, cell + ".f32", compute_dtype="float32")


def _frozen(weights, grads, state, **kw):
    """Adam's step that leaves the weights and its state as they were."""


def _half(ce):
    def half(logits, labels, mask, num_samples):
        keep = mask & (torch.cumsum(mask.long(), 0) % 2 == 1)
        return ce(logits, labels, keep, (num_samples + 1) // 2)
    return half


def _run(cell):
    return harness.run(cell, 2**32 + 99, 0.3, False, t_start=0.0, require_cuda=False,
                       log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(f32_cell, cell):
    out = _run(f32_cell(cell))
    assert out.correct and out.failed == 0, out.checks


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(f32_cell, monkeypatch, cell):
    from parallel_gcn_tpu_torch import seeds, train

    monkeypatch.setattr(train, "adam_step", _frozen)
    monkeypatch.setattr(seeds, "adam_step", _frozen)
    out = _run(f32_cell(cell))
    assert not out.correct and out.failed == out.attempted, out.checks


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(f32_cell, monkeypatch, cell):
    from parallel_gcn_tpu_torch import train

    monkeypatch.setattr(train, "masked_softmax_xent", _half(train.masked_softmax_xent))
    out = _run(f32_cell(cell))
    assert not out.correct, out.checks
