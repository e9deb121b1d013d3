"""Registry: ``--arch <id>`` -> ArchConfig (port of the reference's
``configs/__init__.py``).

:data:`ARCHS` holds the reference's eleven configs: the ten decoder
architectures of :data:`ASSIGNED`, in the reference's order, and
``feel-mlp``, the paper's classifier (family ``"mlp"``), which
:mod:`repro_torch.fed.feel_model` runs and ``models.model`` refuses.  An
unknown name raises ``KeyError``.
"""
from repro_torch.configs import (arctic_480b, deepseek_v2_lite_16b,
                                 feel_mlp, granite_34b,
                                 llava_next_mistral_7b, mamba2_2p7b,
                                 minicpm3_4b, mistral_nemo_12b,
                                 musicgen_large, qwen1p5_4b, zamba2_7b)
from repro_torch.configs.base import (SHAPES, ArchConfig, MLAConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      get_shape)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (granite_34b, deepseek_v2_lite_16b, mistral_nemo_12b,
                   musicgen_large, zamba2_7b, mamba2_2p7b, arctic_480b,
                   qwen1p5_4b, llava_next_mistral_7b, minicpm3_4b,
                   feel_mlp)}

# the 10 assigned decoder architectures (feel-mlp is the paper's own extra)
ASSIGNED = [
    "granite-34b", "deepseek-v2-lite-16b", "mistral-nemo-12b",
    "musicgen-large", "zamba2-7b", "mamba2-2.7b", "arctic-480b",
    "qwen1.5-4b", "llava-next-mistral-7b", "minicpm3-4b",
]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "ARCHS", "ASSIGNED", "get_arch",
           "get_shape"]
