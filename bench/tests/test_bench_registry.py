"""A cell, a configuration, a traffic mix, an operator, a runner and a
per-layer metric are added by new files and ``BENCHMARK.json`` entries
alone: the harness finds each by its name."""

import json
import shutil

import pytest

from bench import harness
from conftest import ROOT

NEW_METRIC = '''"""engine.intervals: the intervals the window completed."""

SPANS = {"engine.closed_forms.tiny": "repro_torch.streams.operators:"
                                     "WindowedSelfJoin.device_finish"}


def read(run):
    run.notes.append(f"{len(run.spans['engine.closed_forms.tiny'])} calls")
    return len(run.interval_ms)
'''


#: an operator added by its file: the self-join's semantics under a new
#: name, beside the program's operator of that name
NEW_OPERATOR = (ROOT / "bench" / "operators" / "selfjoin.py").read_text()

#: a runner added by its file: the keyed stage's, noting that it ran
NEW_RUNNER = '''"""A runner that drives the keyed stage and says so."""

from bench import harness


def run(ctx):
    ctx.run.notes.append("tiny runner")
    base = harness.load_file(ctx.cell.root, "runners", "keyed_stage")
    return base.run(ctx)
'''


def _tree(tmp_path):
    """A copy of the benchmark's files with one of each added."""
    for part in ("configs", "traffic", "metrics", "operators", "runners"):
        shutil.copytree(ROOT / "bench" / part, tmp_path / "bench" / part)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "bench" / "configs" / "stock-selfjoin.json")
                        .read_text())
    config.update(name="join-tiny", keys=1500, tasks=4, window=2,
                  tuples_per_interval=5000, operator="join-tiny",
                  runner="tiny")
    (tmp_path / "bench" / "configs" / "join-tiny.json").write_text(
        json.dumps(config))
    (tmp_path / "bench" / "operators" / "join-tiny.py").write_text(
        NEW_OPERATOR)
    (tmp_path / "bench" / "runners" / "tiny.py").write_text(NEW_RUNNER)
    (tmp_path / "bench" / "traffic" / "uniform-tiny.json").write_text(
        json.dumps({"z": 0.0, "cycle_intervals": 2}))
    (tmp_path / "bench" / "metrics" / "engine.intervals.py").write_text(
        NEW_METRIC)
    bench["configs"].append({"name": "join-tiny", "source": "a test",
                             "file": "bench/configs/join-tiny.json",
                             "reduced": ["keys"], "why": "a test"})
    bench["workloads"].append({"name": "join-tiny.uniform",
                               "config": "join-tiny",
                               "traffic": "uniform-tiny", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "engine.intervals", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "tuples_per_s",
                               "workloads": ["join-tiny.uniform"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_cell_config_mix_and_metric_by_files_alone(tmp_path):
    root = _tree(tmp_path)
    notes = []
    r = harness.run_cell("join-tiny.uniform", 4, 0.3, True, device="cpu",
                         root=root, log=notes.append)
    assert r["correct"]
    assert "tiny runner" in notes
    m = r["metrics"]
    # attempted: the window's intervals and the window + 1 judged after it
    assert m["engine.intervals"]["value"] == r["attempted"] - 3 > 0
    assert m["engine.intervals"]["unit"] == "count"
    assert any(n.endswith(" calls") for n in notes)
    assert "routing_lookup.roofline" not in m      # not listed for it
    r = harness.run_cell("join-tiny.uniform", 4, 0.3, False, device="cpu",
                         root=root, log=notes.append)
    assert set(r["metrics"]) == {"tuples_per_s", "parallel_efficiency",
                                 "setup_s"}


def test_metric_entries_follow_workloads_and_moves():
    cell = harness.load_cell("wc-k1m.steady")
    traced = {m["name"] for m in harness.metric_entries(cell, True)}
    assert "routing_lookup.roofline" not in traced
    assert "device.idle" in traced
    assert {m["name"] for m in harness.metric_entries(cell, False)} == {
        "tuples_per_s", "parallel_efficiency", "setup_s"}


def test_every_metric_and_mix_named_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for c in bench["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert (ROOT / "bench" / "runners"
                / f"{config.get('runner', 'keyed_stage')}.py").is_file()
        assert (ROOT / "bench" / "operators"
                / f"{config['operator']}.py").is_file()


def test_a_cell_that_names_no_runner_file_is_refused(tmp_path):
    root = _tree(tmp_path)
    (root / "bench" / "runners" / "tiny.py").unlink()
    with pytest.raises(harness.Refused, match="no runners file"):
        harness.run_cell("join-tiny.uniform", 4, 0.3, False, device="cpu",
                         root=root, log=lambda s: None)
