"""Launchers and launch tooling of the port — the JAX package's
``repro.launch``.

* :mod:`.serve` and :mod:`.train`: ``python -m repro_torch.launch.serve``
  and ``... .train`` run the smoke configs (``--mode local``, the default)
  or report a full config's dry run (``--mode lower``);
* :mod:`.mesh`: ``DeviceMesh`` construction over ``torch.distributed``;
* :mod:`.specs`: the (shape, dtype) stand-ins of every cell's inputs,
  parameters and caches;
* :mod:`.dryrun`: ``lower_cell``, the cell's step traced on the ``meta``
  device (FLOPs by ``FlopCounterMode``, 2- and 3-group probes) and its
  bytes per device under the mesh's shardings;
* :mod:`.roofline`: the FLOP model and the H100's compute and memory
  bounds over the dry-run reports.

Not ported, with the reason:

* ``dryrun.collective_bytes``: it parses XLA's optimized HLO text for
  collective ops. The port has no compiler-partitioned program to parse:
  its collectives are DTensor redistributions issued at run time, and the
  roofline has no link rate to charge them against until one is measured.
* ``compiled.memory_analysis``: XLA's buffer assignment of a compiled
  program. The dry run reports the resident bytes per device from the
  shardings instead; the peak of a real step is measured on the card
  (``torch.cuda.max_memory_allocated``, ``chip_smoke.py``).
* ``kernels/compat.py``: a shim over Pallas API drift between JAX
  versions (``CompilerParams``); the port has no Pallas.
"""
