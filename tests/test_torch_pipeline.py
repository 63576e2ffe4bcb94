"""The port's keyed data pipeline (``repro_torch.data.pipeline``) against the
JAX package's, bit for bit, on the CPU: the same numpy generators, the
same Mixed plans on the port's own ``core``, so every interval's worker
tokens, every packed batch, the routing table and the state dict are
equal. Worker counts 4 and 8 (ROADMAP C8 keeps them off 6 and 9)."""

import numpy as np
import pytest

from repro.data.pipeline import KeyedDataPipeline as JaxPipeline
from repro.data.pipeline import byte_tokenize as jax_byte_tokenize
from repro.data.pipeline import zipf_sources as jax_zipf_sources
from repro_torch.data import (KeyedDataPipeline, SourceSpec, byte_tokenize,
                              zipf_sources)


def _pair(n_workers, n_sources=40, seq_len=32):
    kw = dict(n_workers=n_workers, seq_len=seq_len, vocab=500,
              theta_max=0.1, seed=3)
    return (KeyedDataPipeline(zipf_sources(n_sources, z=1.1, seed=2), **kw),
            JaxPipeline(jax_zipf_sources(n_sources, z=1.1, seed=2), **kw))


def _same_state(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        assert a[key] == b[key], key


@pytest.mark.parametrize("n_workers", [4, 8])
def test_pipeline_matches_jax(n_workers):
    """6 intervals, the sources drifting before intervals 3 and 5 (the
    JAX package's default drift generator, then an explicit one): worker
    tokens, the controller's table and events, the packed batches of every
    worker (until one runs dry) and the state dict, equal each interval."""
    port, ref = _pair(n_workers)
    moved = 0
    for i in range(6):
        if i == 2:
            port.drift(magnitude=1.0)
            ref.drift(magnitude=1.0)
        if i == 4:
            port.drift(np.random.default_rng(11), magnitude=0.7)
            ref.drift(np.random.default_rng(11), magnitude=0.7)
        a, b = port.run_interval(n_docs=300), ref.run_interval(n_docs=300)
        np.testing.assert_array_equal(a, b)
        assert port.controller.assignment.table == \
            ref.controller.assignment.table
        ev, jev = port.controller.history[-1], ref.controller.history[-1]
        assert (ev.triggered, ev.theta_before) == \
            (jev.triggered, jev.theta_before)
        moved += int(ev.triggered)
        for w in range(n_workers):
            got, want = port.worker_batch(w, 2), ref.worker_batch(w, 2)
            assert (got is None) == (want is None)
            if got is not None:
                for key in ("tokens", "labels"):
                    np.testing.assert_array_equal(got[key], want[key])
                assert got["tokens"].dtype == np.int32
                assert np.array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
        _same_state(port.state_dict(), ref.state_dict())
    assert moved > 0


@pytest.mark.parametrize("n_workers", [4, 8])
def test_pipeline_state_round_trip(n_workers):
    """A JAX pipeline's ``state_dict`` loaded into a fresh port pipeline
    (and the port's into a fresh port pipeline): both continue exactly as
    the JAX pipeline does."""
    port, ref = _pair(n_workers)
    for _ in range(3):
        port.run_interval(250)
        ref.run_interval(250)
    from_ref, from_port = _pair(n_workers)[0], _pair(n_workers)[0]
    from_ref.load_state(ref.state_dict())
    from_port.load_state(port.state_dict())
    for _ in range(3):
        want = ref.run_interval(250)
        for pipe in (from_ref, from_port):
            np.testing.assert_array_equal(pipe.run_interval(250), want)
    for pipe in (from_ref, from_port):
        _same_state(pipe.state_dict(), ref.state_dict())
    for w in range(n_workers):
        want = ref.worker_batch(w, 1)
        for pipe in (from_ref, from_port):
            got = pipe.worker_batch(w, 1)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_zipf_sources_and_byte_tokenize_match_jax():
    got, want = zipf_sources(64, z=0.9, seed=5), jax_zipf_sources(
        64, z=0.9, seed=5)
    assert [(s.source_id, s.weight, s.mean_len) for s in got] == \
        [(s.source_id, s.weight, s.mean_len) for s in want]
    assert isinstance(got[0], SourceSpec)
    text = bytes(range(256)) * 3
    np.testing.assert_array_equal(byte_tokenize(text, 100),
                                  jax_byte_tokenize(text, 100))
    assert byte_tokenize(text, 100).dtype == np.int32
