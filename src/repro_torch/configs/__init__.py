"""Registry: ``--arch <id>`` -> ArchConfig, for the architectures the port
runs (the reference's ``configs/__init__.py``, cut to them).

``get_arch`` returns only configs that ``models.model`` runs.  The
reference's other architectures are named in :data:`NOT_PORTED`, and
asking for one raises ``NotImplementedError``; an unknown name raises
``KeyError``.  ``configs/feel_mlp.py`` holds the paper's classifier's
constants, not an ``ArchConfig``.
"""
from repro_torch.configs import mamba2_2p7b, mistral_nemo_12b
from repro_torch.configs.base import ArchConfig, SSMConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (mistral_nemo_12b, mamba2_2p7b)}

# the reference's architectures that select parts the port does not run
# yet (MoE, MLA, hybrid, audio, VLM, qkv bias, the GELU FFN, the MLP)
NOT_PORTED = ("granite-34b", "deepseek-v2-lite-16b", "musicgen-large",
              "zamba2-7b", "arctic-480b", "qwen1.5-4b",
              "llava-next-mistral-7b", "minicpm3-4b", "feel-mlp")


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; the PyTorch port runs "
            f"{sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "SSMConfig", "ARCHS", "NOT_PORTED", "get_arch"]
