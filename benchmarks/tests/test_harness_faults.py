"""The rest of a run with the chip check skipped, on the CPU at toy sizes:
sound runs come out correct, and with a fault planted in the timed path
``correct`` comes out false. On the card: the control and the faults at the
cells' own sizes (marked ``cuda``)."""

import time

import pytest
import torch

from benchmarks import control, faults, run, spec

TINY = {"vit_b16": {"model": {"embed_dim": 64, "depth": 2, "num_heads": 4,
                              "input_size": 128}},
        "convnextv2_tiny": {"model": {"input_size": 128}}}
SERVE = {"request_boards": 16, "pool_boards": 64, "batch_size": 16,
         "inflight": 2, "sample_requests": 4}
TRAIN = {"corpus_boards": 64, "batch_size": 8}
SEED = 3_000_000_007


def _tiny(name: str):
    cell = spec.load(name)
    small = SERVE if cell.traffic["kind"] == "serve" else TRAIN
    return cell.with_overrides(TINY[cell.config["name"]], small)


def _run(cell, seed=SEED):
    return run.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.mark.parametrize("name", ["vit_b16.serve_bf16", "vit_b16.serve_int8",
                                  "convnextv2_tiny.serve_bf16",
                                  "vit_b16.train_bf16"])
def test_sound_run_is_correct(name):
    _, correct, checks = _run(_tiny(name))
    assert correct, checks


@pytest.mark.parametrize("name", ["vit_b16.serve_bf16", "vit_b16.serve_int8",
                                  "convnextv2_tiny.serve_bf16"])
def test_altered_answer_is_not_correct(name):
    with faults.altered_answer():
        _, correct, checks = _run(_tiny(name))
    assert not correct, checks


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_broken_train_step_is_not_correct(fault):
    with faults.PLANTED[fault]():
        _, correct, checks = _run(_tiny("vit_b16.train_bf16"))
    assert not correct, checks


@pytest.mark.parametrize("name", ["vit_b16.serve_bf16", "vit_b16.serve_int8",
                                  "convnextv2_tiny.serve_bf16"])
def test_control_reads_three_times_the_program(name):
    """At toy sizes the limits (set at the cells' sizes) do not apply; on the
    same boards the compared numbers still separate the control from the
    program."""
    cell = _tiny(name)
    cpu = torch.device("cpu")
    program = control.serve_control(cell, SEED, {"kind": "program",
                                                 "traffic": {}}, cpu)
    reading = control.serve_control(cell, SEED, cell.control, cpu)
    assert any(reading[k] > 3 * program[k] for k in cell.limits), (
        reading, program)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vit_b16.serve_bf16", "vit_b16.serve_int8",
                                  "convnextv2_tiny.serve_bf16",
                                  "vit_b16.train_bf16"])
def test_control_fails_on_the_card(name, cuda_device):
    cell = spec.load(name)
    kind = cell.traffic["kind"]
    fn = control.serve_control if kind == "serve" else control.train_control
    reading = fn(cell, SEED, cell.control, cuda_device)
    assert any(reading[k] > limit for k, limit in cell.limits.items()), reading
