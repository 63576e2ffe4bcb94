"""Architecture registry of the port: the JAX package's ``configs`` for the
archs whose layer kinds the port has (attention followed by a dense SwiGLU
or an MoE MLP).

``get_config`` gives the exact public config, ``smoke_config`` the reduced
variant of the same family that the CPU tests and the smoke CLI run. The
JAX package's other archs need layer kinds the port does not have yet and
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

import importlib

ARCHS = ["gemma3_12b", "qwen2_7b", "granite_moe_3b_a800m", "dbrx_132b",
         "granite_8b", "granite_20b"]

#: the JAX package's other archs, and the ROADMAP item each waits for
NOT_PORTED = {
    "jamba_1_5_large_398b": "Queue A item 4: mamba layers",
    "internvl2_1b": "Queue A item 4: the vision prefix",
    "xlstm_125m": "Queue A item 4: sLSTM and mLSTM layers",
    "whisper_large_v3": "Queue A item 4: the whisper encoder",
}

ALIASES = {a.replace("_", "-"): a for a in [*ARCHS, *NOT_PORTED]}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name in NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                  f"{NOT_PORTED[mod_name]})")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(f"{__name__}.{mod_name}")


def get_config(name: str):
    return _module(name).CONFIG


def smoke_config(name: str):
    return _module(name).SMOKE
