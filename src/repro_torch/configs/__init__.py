"""Configurations the port builds, every arch id of the reference
(``llama3_2_3b``, ``kimi_k2_1t_a32b``, ``deepseek_v2_236b``, the dense
``minicpm_2b`` and the windowed dense ``h2o_danube_1_8b`` and
``gemma3_12b``, the vlm ``pixtral_12b``, the encoder-decoder
``whisper_base``, the SSM ``mamba2_2_7b`` and the hybrid ``zamba2_2_7b``:
each with ``CONFIG`` and ``SMOKE``), and :func:`get_config` by those ids."""

import importlib

ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "minicpm-2b": "minicpm_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma3-12b": "gemma3_12b",
    "pixtral-12b": "pixtral_12b",
    "whisper-base": "whisper_base",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(arch: str, smoke: bool = False):
    """The config of ``arch`` (full width, or its ``SMOKE`` size)."""
    if arch not in ARCH_MODULES:
        raise NotImplementedError(f"the port has no config for {arch!r}: "
                                  f"{sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
