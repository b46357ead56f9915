"""rub_mimo_tpu — a MIMO-OFDM modem framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the RUB_MIMO
reference SDR testbed (see SURVEY.md).  The live-radio path is replaced by
file/stream IQ replay; the per-sample C++ state machine becomes one pure,
jit-compiled function over whole capture blocks, sharded across device meshes.
"""

from rub_mimo_tpu.config import (
    CommMode,
    DEFAULT_CONFIG,
    Detector,
    ModemConfig,
    Modulation,
    tiny_config,
)

__version__ = "0.1.0"

__all__ = [
    "CommMode",
    "DEFAULT_CONFIG",
    "Detector",
    "ModemConfig",
    "Modulation",
    "tiny_config",
]
