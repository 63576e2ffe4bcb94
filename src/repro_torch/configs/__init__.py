"""Architecture registry of the port: the JAX package's ``configs``, one
module per arch with its exact public config.

``get_config`` gives the exact public config, ``smoke_config`` the reduced
variant of the same family that the CPU tests and the smoke CLI run.
"""

import importlib

ARCHS = ["jamba_1_5_large_398b", "internvl2_1b", "dbrx_132b",
         "granite_moe_3b_a800m", "granite_20b", "granite_8b", "gemma3_12b",
         "qwen2_7b", "xlstm_125m", "whisper_large_v3"]

#: the JAX package's archs that the port does not have (none since the
#: recurrent layers, the whisper encoder and the vision prefix came)
NOT_PORTED: dict = {}

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(f"{__name__}.{mod_name}")


def get_config(name: str):
    return _module(name).CONFIG


def smoke_config(name: str):
    return _module(name).SMOKE
