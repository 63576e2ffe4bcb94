"""The keyed data pipeline (the JAX package's ``repro.data``)."""

from .pipeline import (KeyedDataPipeline, SourceSpec, byte_tokenize,
                       zipf_sources)

__all__ = ["KeyedDataPipeline", "SourceSpec", "byte_tokenize",
           "zipf_sources"]
