"""The comparison fails a run whose timed path is broken underneath, and
passes the reference put in the program's place, and fails it again once
it breaks the delivery guarantee (the control).

Each fault is planted in the program for one run on the CPU at a small
size; the harness runs as it does on the card, past its look for a card.
"""

import numpy as np
import pytest
import torch

from bench import control, harness
from conftest import SMALL
from repro_torch.core.controller import RebalanceController
from repro_torch.streams import operators
from repro_torch.streams.backends import DeviceBackend
from repro_torch.streams.device import DeviceStateFleet
from repro_torch.streams.engine import KeyedStage


def _run(cell="wc-k1m.drift", **kw):
    return harness.run_cell(cell, 2**31 + 17, 0.5, False, device="cpu",
                            overrides=SMALL, log=lambda s: None, **kw)


def _wrong(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


def test_sound_run_reads_correct():
    r = _run()
    assert r["correct"] and not _wrong(r)


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    orig = DeviceStateFleet.interval_step

    def frozen(self, *a, **kw):
        vals, pres = self.vals.clone(), self.pres.clone()
        out = orig(self, *a, **kw)
        self.vals.copy_(vals)
        self.pres.copy_(pres)
        return out

    monkeypatch.setattr(DeviceStateFleet, "interval_step", frozen)
    r = _run()
    assert not r["correct"]
    assert {"ring_wrong", "outputs_wrong"} <= _wrong(r)


@pytest.mark.parametrize("cell", ["wc-k1m.drift", "stock-selfjoin.burst"])
def test_half_the_batch_left_out_and_the_rest_counted_twice(monkeypatch,
                                                            cell):
    orig = KeyedStage.process_interval_arrays

    def half(self, keys, values=None):
        return orig(self, np.repeat(keys[::2], 2)[:keys.size], values)

    monkeypatch.setattr(KeyedStage, "process_interval_arrays", half)
    r = _run(cell)
    assert not r["correct"] and r["failed"] > 0
    assert {"loads_gap", "ring_wrong", "outputs_wrong"} <= _wrong(r)


@pytest.mark.parametrize("op", ["WordCount", "WindowedSelfJoin"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, op):
    cls = getattr(operators, op)
    orig = cls.device_finish

    def altered(self, counts, win0, slot0):
        cost, out, emit = orig(self, counts, win0, slot0)
        out = out.copy()
        out[0] += 1
        return cost, out, emit

    monkeypatch.setattr(cls, "device_finish", altered)
    r = _run("wc-k1m.drift" if op == "WordCount" else "stock-selfjoin.burst")
    assert not r["correct"] and "outputs_wrong" in _wrong(r)


def test_a_destination_altered_where_it_is_produced(monkeypatch):
    orig = DeviceStateFleet.dest_host_dense

    def altered(self, dev):
        out = orig(self, dev).copy()
        out[7] = (out[7] + 1) % 15
        return out

    monkeypatch.setattr(DeviceStateFleet, "dest_host_dense", altered)
    r = _run()
    assert not r["correct"] and "dest_wrong" in _wrong(r)


def test_migration_that_moves_no_state(monkeypatch):
    def no_move(self, keys, old, new):
        fleet = self.fleet
        keys = keys[(keys >= 0) & (keys < fleet.domain)]
        moving = keys[old.dest(keys) != new.dest(keys)]
        held = moving[fleet.task[moving] >= 0]
        return float(fleet.mem[held].sum())

    monkeypatch.setattr(DeviceBackend, "migrate", no_move)
    r = _run()
    assert not r["correct"] and "owner_wrong" in _wrong(r)


def test_controller_that_plans_without_its_trigger(monkeypatch):
    orig = RebalanceController.on_interval

    def always(self, stats, force=False, interval=None):
        return orig(self, stats, force=True, interval=interval)

    monkeypatch.setattr(RebalanceController, "on_interval", always)
    r = _run("wc-k1m.steady")
    assert not r["correct"] and "trigger_wrong" in _wrong(r)


def test_table_key_outside_the_domain(monkeypatch):
    orig = RebalanceController.on_interval

    def stray(self, stats, force=False, interval=None):
        ev = orig(self, stats, force=force, interval=interval)
        if ev.triggered:
            self.assignment.table[10**7] = 0
        return ev

    monkeypatch.setattr(RebalanceController, "on_interval", stray)
    r = _run()
    assert not r["correct"] and "table_wrong" in _wrong(r)


@pytest.mark.parametrize("cell", ["wc-k1m.drift", "stock-selfjoin.burst",
                                  "wc-k1m.steady"])
def test_control_fails_and_the_reference_in_its_place_passes(monkeypatch,
                                                             cell):
    shed = _run(cell, stage_factory=control.ControlStage)
    assert not shed["correct"]
    assert {"tuples_wrong", "loads_gap", "ring_wrong",
            "outputs_wrong", "emitted_gap"} <= _wrong(shed)
    monkeypatch.setattr(control, "SHED_EVERY", 1 << 40)
    whole = _run(cell, stage_factory=control.ControlStage)
    assert whole["correct"] and not _wrong(whole)


def test_torch_is_the_cpu_build_here_or_the_card_is_not_used():
    # the faults above run the program's plain versions: no card is touched
    assert not torch.cuda.is_initialized()
