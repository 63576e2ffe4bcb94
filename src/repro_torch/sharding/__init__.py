"""Sharding rules and the activation-constraint context over
``torch.distributed`` device meshes — the JAX package's ``sharding``."""
