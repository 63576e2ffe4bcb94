"""Launchers and launch tooling of the port — the JAX package's
``repro.launch``.

* :mod:`.serve` and :mod:`.train`: ``python -m repro_torch.launch.serve``
  and ``... .train`` run the smoke configs (``--mode local``, the default)
  or report a full config's dry run (``--mode lower``);
* :mod:`.mesh`: ``DeviceMesh`` construction over ``torch.distributed``;
* :mod:`.specs`: the (shape, dtype) stand-ins of every cell's inputs,
  parameters and caches;
* :mod:`.dryrun`: ``lower_cell``, the cell's step traced on the ``meta``
  device (FLOPs by ``FlopCounterMode``, 2- and 3-group probes), its bytes
  per device under the mesh's shardings, and the step again as DTensors
  on the production mesh over a fake process group (in a subprocess): its
  collective bytes per family and its memory per device, the JAX
  package's ``collective_bytes`` and ``compiled.memory_analysis``;
* :mod:`.roofline`: the FLOP model and the H100's compute, memory and
  collective bounds over the dry-run reports.

The launchers turn on the JAX launchers' ``REPRO_PERF_*`` flags for their
run unless given ``--no-perf-flags`` (:mod:`repro_torch.flags`).

Not ported, with the reason: ``kernels/compat.py``, a shim over Pallas
API drift between JAX versions (``CompilerParams``); the port has no
Pallas.
"""
