"""Registry: ``--arch <id>`` -> ArchConfig, for the architectures the port
runs (the reference's ``configs/__init__.py``, cut to them).

``get_arch`` returns only configs that ``models.model`` runs.  The
reference's other architectures are named in :data:`NOT_PORTED`, and
asking for one raises ``NotImplementedError``; an unknown name raises
``KeyError``.  ``configs/feel_mlp.py`` holds the paper's classifier's
constants, not an ``ArchConfig``.
"""
from repro_torch.configs import (arctic_480b, deepseek_v2_lite_16b,
                                 granite_34b, llava_next_mistral_7b,
                                 mamba2_2p7b, minicpm3_4b, mistral_nemo_12b,
                                 musicgen_large, qwen1p5_4b, zamba2_7b)
from repro_torch.configs.base import (SHAPES, ArchConfig, MLAConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      get_shape)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (deepseek_v2_lite_16b, arctic_480b, granite_34b,
                   minicpm3_4b, mistral_nemo_12b, musicgen_large, zamba2_7b,
                   mamba2_2p7b, qwen1p5_4b, llava_next_mistral_7b)}

# the reference's registry names that are not decoder configs: feel-mlp is
# the paper's classifier (``configs/feel_mlp.py`` holds its constants)
NOT_PORTED = ("feel-mlp",)


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; the PyTorch port runs "
            f"{sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "ARCHS",
           "NOT_PORTED", "get_arch", "get_shape"]
