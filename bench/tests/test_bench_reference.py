"""The plain reference: its semantics on hand-made intervals, and its
agreement with the program (``repro_torch``) on the CPU at a small size."""

import numpy as np
import pytest

from bench import harness, judge, reference
from conftest import SMALL, keyed_stage

CELLS = ("wc-k1m.drift", "stock-selfjoin.burst", "wc-k1m.steady")


def test_hash_matches_murmur3_finalizer_values():
    # fmix32 of 0 is 0; of 1 with seed 0 is murmur3's 0x514E28B7
    h = reference.fmix32(np.array([0, 1], dtype=np.int64))
    assert h.tolist() == [0, 0x514E28B7]
    assert reference.hash_dest(np.array([1]), 15).tolist() == [
        0x514E28B7 % 15]


def test_table_overrides_hash():
    base = reference.hash_dest(np.arange(10), 3)
    f = reference.dest_table(base, {4: 0, 7: 2})
    assert f[4] == 0 and f[7] == 2
    np.testing.assert_array_equal(np.delete(f, [4, 7]),
                                  np.delete(base, [4, 7]))


def test_wordcount_window_and_eviction():
    ref = reference.ReferenceStage("wordcount", 4, 2, window=2)
    ref.step(np.array([0, 0, 1]), {})          # interval 1
    ref.step(np.array([0]), {})                # sees interval 1
    assert ref.output[0] == 3 and ref.output[1] == 1
    ref.step(np.array([0]), {})                # sees intervals 1 and 2
    assert ref.output[0] == 4
    assert not ref.held[1]                     # interval 1 evicted after 3
    # emits: 1, 2 and 1 ; 3 ; 4
    assert ref.emitted == 11.0
    vals, pres = ref.ring(3)
    assert vals[:, 0].tolist() == [1, 0, 1] and pres[:, 1].sum() == 0


def test_unknown_operator_is_refused():
    with pytest.raises(ValueError, match="unknown operator"):
        reference.ReferenceStage("nosuch", 4, 2, window=2)


def test_selfjoin_probes_and_cost():
    ref = reference.ReferenceStage("selfjoin", 2, 1, window=2,
                                   probe_cost=0.5)
    loads, _, _ = ref.step(np.array([1, 1]), {})
    # probes 0 + 1; cost 2 inserts + 0.5 * 1
    assert loads.tolist() == [2.5] and ref.output[1] == 1
    loads, _, _ = ref.step(np.array([1]), {})
    # the held 2 tuples are probed: cost 1 + 0.5 * 2
    assert loads.tolist() == [2.0] and ref.output[1] == 2
    assert ref.mem[1] == 3 * 32.0


def test_migrated_bytes_are_the_held_keys_whose_f_moved():
    ref = reference.ReferenceStage("wordcount", 6, 2, window=3)
    ref.step(np.array([0, 1, 2]), {})
    ref.step(np.array([0]), {})
    base = ref.route({})
    table = {0: 1 - int(base[0]), 5: 1 - int(base[5])}   # 5 is not held
    _, moved, _ = ref.step(np.array([3]), table)
    assert moved == 2 * 16.0                   # key 0: two slots


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(cell):
    r = harness.run_cell(cell, 2**31 + 3, 0.6, False, device="cpu",
                         overrides=SMALL, log=lambda s: None)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert r["attempted"] > 0 and r["failed"] == 0


def test_judge_catches_an_interval_read_twice():
    """Handing one interval twice while the judge expects it once shows
    in the tuples, the loads, the ring and the outputs."""
    cell = harness.load_cell("wc-k1m.steady")
    cfg = {**cell.config, **SMALL["config"]}
    runner = keyed_stage()
    stage = runner.make_stage(cfg, "cpu")
    rec = runner.Recorder(stage)
    keys = [np.arange(cfg["keys"], dtype=np.int64)] * 3
    for i, k in enumerate(keys):
        rec.before()
        stage.process_interval_arrays(np.concatenate([k, k]) if i == 1
                                      else k)
        rec.after()
    checks, failed = judge.judge(cfg, runner.observe(stage, rec, keys))
    assert checks["tuples_wrong"] == 1 and failed == 1
    assert checks["ring_wrong"] > 0 and checks["outputs_wrong"] > 0
